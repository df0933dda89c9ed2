"""Kernel B1's band plan (``ops/fir_dma_kernel.py BandPlan``): the fleet's
atlas window is zero outside each row's taps and each row tile's columns
cover its rows, at every start phase; a torch-ops emulation of the band
kernel's loop (each tile summed over its band only, in slices) matches
the plain version; the wrapper's checks of the plan.  The CUDA kernel
itself is held against the plain version in tests/test_torch_cuda.py and
chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine.fir_fleets import _sync_atlas
from resampler_tpu_torch.ops import fir_dma_kernel as kern
from resampler_tpu_torch.types import Attenuation, reduce_ratio

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

# (in_hz, out_hz, taps): the headline pair at 128 and 64 taps, periodic
# downsampling, the grouped small-M pair (g 64) and heavy periodic
# downsampling (g 128, the 16-row tile)
PAIRS = [
    (44100, 48000, 128),
    (44100, 48000, 64),
    (48000, 44100, 128),
    (48000, 96000, 64),
    (48000, 8000, 128),
]
IDS = ["44k1-48k-t128", "44k1-48k-t64", "48k-44k1", "48k-96k-grouped", "48k-8k-rows16"]


def _fleet_atlas(in_hz, out_hz, taps):
    """The atlas, plan and geometry ``make_fir_fleet_step_sync_tm`` builds
    on the periodic path."""
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=1, taps=taps, ratio_num=L, ratio_den=M)
    g = tfir._periodic_group_factor(L, M)
    Lg, Mg = L * g, M * g
    coeffs = tfir.fir_coefficients(
        taps, Attenuation.Db90, tfir.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz)
    )
    atlas_cfg = dataclasses.replace(cfg, ratio_num=Lg, ratio_den=Mg) if g > 1 else cfg
    a2 = _sync_atlas(atlas_cfg, coeffs)
    plan = kern.BandPlan(Lg, Mg, taps)
    K = -(-cfg.out_capacity // Mg)
    return a2, plan, (L, M), dict(L=Lg, M=Mg, span=Lg + taps + 1, K=K)


def _window(a2, L, M, i0, geo):
    c0 = (i0 * L) // M
    return a2[i0 : i0 + geo["M"], c0 : c0 + geo["span"]]


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_window_is_zero_outside_each_tiles_band(pair):
    a2, plan, (L, M), geo = _fleet_atlas(*pair)
    taps, Mg, span = pair[2], geo["M"], geo["span"]
    assert plan.period == M
    assert plan.tiles.shape == (M, -(-Mg // plan.rows), 2)
    cols = np.arange(span)
    for i0 in range(M):
        a = _window(a2, L, M, i0, geo)
        assert a.shape == (Mg, span)
        off = (i0 + np.arange(Mg)) * L // M - (i0 * L) // M  # each row's first tap
        row_band = (cols >= off[:, None]) & (cols < off[:, None] + taps)
        assert not np.any(a[~row_band]), f"i0 {i0}: a nonzero outside a row's taps"
        for t, (lo, hi) in enumerate(plan.tiles[i0]):
            rows = slice(t * plan.rows, min((t + 1) * plan.rows, Mg))
            assert 0 <= lo < hi <= span
            inside = (cols >= lo) & (cols < hi)
            assert np.all(inside[None, :] | ~row_band[rows]), f"i0 {i0} tile {t}: band uncovered"


def test_plan_tile_and_work():
    """32-row tiles on the main path (0.567 of the span-wide work over the
    period, 1.22x the taps-wide), 16-row ones where a 32-row tile would
    spread more than the taps."""
    _, plan, (L, M), geo = _fleet_atlas(44100, 48000, 128)
    assert (plan.rows, plan.n_tiles, plan.span) == (32, 5, 276)
    issued = np.mean([plan.issued(i0) for i0 in range(M)])
    assert abs(issued / (160 * 276) - 0.567) < 0.001
    assert abs(issued / (160 * 128) - 1.223) < 0.001
    assert plan.smem_bytes == 4 * kern.BAND_STAGES * kern.BAND_DEPTH * (32 + kern.BAND_LANES)
    assert plan.smem_bytes <= kern.SMEM_MAX
    assert kern.BandPlan(768, 128, 128).rows == 16  # 48 -> 8 kHz, g 128


def _emulate(buffer, base, a, plan, i0, K):
    """The band kernel's loop in torch ops: each tile of ``plan.rows``
    rows sums over its columns ``[lo, hi)`` only, ``BAND_DEPTH`` at a
    time, in f64 (the sum's order is the kernel's own business; f64 keeps
    the comparison to the f32 plain version's rounding alone)."""
    L, Mg = plan.L, plan.M
    R = buffer.shape[1]
    out = torch.zeros((K, Mg, R), dtype=torch.float64)
    buffer, a = buffer.double(), a.double()
    for t, (lo, hi) in enumerate(plan.tiles[i0].tolist()):
        j = slice(t * plan.rows, min((t + 1) * plan.rows, Mg))
        for s0 in range(lo, hi, kern.BAND_DEPTH):
            s1 = min(s0 + kern.BAND_DEPTH, hi)
            rows = buffer[base + s0 : base + (K - 1) * L + s1].unfold(0, s1 - s0, L)  # [K, R, w]
            out[:, j] += torch.einsum("js,krs->kjr", a[j, s0:s1], rows)
    return out


def _full_span_f64(buffer, base, a, L, M, span, K):
    """The plain version's sum (every span column) in f64."""
    windows = buffer[base : base + (K - 1) * L + span].double().unfold(0, span, L)
    return torch.einsum("js,krs->kjr", a.double(), windows)


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_band_emulation_matches_plain(pair):
    """The band's sum equals the full span's: against the plain version's
    sum taken in f64 within 1e-9, f64 rounding alone (a band one column
    short loses edge taps of ~1e-6); against the f32 plain version within
    the kernels' 1e-5 (its f32 sums of 128 taps sit up to ~1.8e-6 from
    the exact ones here)."""
    a2, plan, (L, M), geo = _fleet_atlas(*pair)
    geo = dict(geo, K=min(geo["K"], 3))
    K, rows = geo["K"], (geo["K"] - 1) * geo["L"] + geo["span"]
    rng = np.random.default_rng(sum(pair))
    ring = rows + 29
    buf = torch.from_numpy(rng.standard_normal((ring, 4), dtype=np.float32))
    for i0 in sorted({0, int(rng.integers(0, M)), M - 1}):
        a = torch.from_numpy(np.ascontiguousarray(_window(a2, L, M, i0, geo)))
        for base in (1, 3, 13, ring - rows):  # odd bases and the top bound
            ref = kern.dma_banded_contract_reference(buf, base, a, **geo)
            got = _emulate(buf, base, a, plan, i0, K)
            assert (got - _full_span_f64(buf, base, a, **geo)).abs().max().item() <= 1e-9
            assert (got - ref.double()).abs().max().item() <= 1e-5
            # the CPU wrapper runs the plain version whatever the band
            same = kern.dma_banded_contract(buf, base, a, band=(plan, i0), **geo)
            assert torch.equal(same, ref)


def test_fleet_window_view_matches_copy():
    """The fleet's window is a strided view of the transposed atlas; the
    plain version gives the same sums as on the contiguous copy."""
    a2, plan, (L, M), geo = _fleet_atlas(44100, 48000, 64)
    geo = dict(geo, K=2)
    a2_t = torch.from_numpy(np.ascontiguousarray(a2.T))
    rng = np.random.default_rng(5)
    buf = torch.from_numpy(rng.standard_normal(((geo["K"] - 1) * geo["L"] + geo["span"] + 7, 4),
                                               dtype=np.float32))
    i0 = 77
    c0 = (i0 * L) // M
    view = a2_t[c0 : c0 + geo["span"], i0 : i0 + geo["M"]].T
    assert not view.is_contiguous()
    copy = torch.from_numpy(np.ascontiguousarray(_window(a2, L, M, i0, geo)))
    assert torch.equal(view, copy)
    got = kern.dma_banded_contract(buf, 5, view, band=(plan, i0), **geo)
    np.testing.assert_allclose(
        got.numpy(), kern.dma_banded_contract_reference(buf, 5, copy, **geo).numpy(), atol=1e-6, rtol=0
    )


def _main_args():
    a2, plan, (L, M), geo = _fleet_atlas(44100, 48000, 64)
    geo = dict(geo, K=2)
    buf = torch.zeros(((geo["K"] - 1) * geo["L"] + geo["span"], 4))
    a = torch.from_numpy(np.ascontiguousarray(_window(a2, L, M, 3, geo)))
    return buf, a, plan, geo


@pytest.mark.parametrize(
    "other",
    [(147, 160, 128), (147, 161, 64), (146, 160, 64), (160, 147, 64)],
    ids=["taps", "M", "L", "swapped"],
)
def test_wrapper_rejects_a_plan_for_another_configuration(other):
    buf, a, plan, geo = _main_args()
    kern.dma_banded_contract(buf, 0, a, band=(plan, 3), **geo)
    with pytest.raises(ValueError, match="band plan"):
        kern.dma_banded_contract(buf, 0, a, band=(kern.BandPlan(*other), 3), **geo)


@pytest.mark.parametrize("i0", [-1, 160, 1000, 3.0, np.int64(3), True])
def test_wrapper_rejects_a_start_phase_out_of_range(i0):
    buf, a, plan, geo = _main_args()
    with pytest.raises(ValueError, match="i0"):
        kern.dma_banded_contract(buf, 0, a, band=(plan, i0), **geo)


def _bm_case(in_hz, out_hz, taps, B, C, seed):
    """A ring, the fleet's atlas window at a start phase, and the output
    capacity of a ``[B, n, C]`` fleet at that pair."""
    a2, plan, (L, M), geo = _fleet_atlas(in_hz, out_hz, taps)
    cfg = tfir.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    rng = np.random.default_rng(seed)
    i0 = int(rng.integers(0, M))
    a = torch.from_numpy(np.ascontiguousarray(_window(a2, L, M, i0, geo)))
    rows = (geo["K"] - 1) * geo["L"] + geo["span"] + 5
    buf = torch.from_numpy(rng.standard_normal((rows, B * C), dtype=np.float32))
    return buf, a, (plan, i0), geo, cfg.out_capacity


def _aten_epilogue(buf, base, a, geo, out_cap, n_out, B, C):
    """The parent form: the plain contraction, rows past ``n_out`` zeroed,
    relaid to ``[B, out_cap, C]``, and ``max |x|``."""
    tm = kern.dma_banded_contract_reference(buf, base, a, **geo).reshape(-1, B * C)[:out_cap]
    tm[n_out:] = 0.0
    out = tm.reshape(out_cap, B, C).permute(1, 0, 2).contiguous()
    return out, out.abs().amax()


@pytest.mark.parametrize(
    "pair,B,C,cut,poison",
    [(PAIRS[0], 3, 2, 0, False), (PAIRS[0], 3, 2, 500, False), (PAIRS[3], 5, 3, 77, False),
     (PAIRS[4], 2, 1, 0, False), (PAIRS[0], 3, 2, 300, True), (PAIRS[0], 3, 2, None, False)],
    ids=["full", "masked", "grouped-C3", "rows16-C1", "nan", "no-output"],
)
def test_bm_plain_matches_contraction_mask_relayout_amax(pair, B, C, cut, poison):
    """``dma_banded_contract_bm``'s plain version (through the wrapper, on
    the CPU) against the plain contraction, then the mask, the relayout and
    ``abs().amax()``: the same outputs (f32 sums of another gather, within
    1e-6), zeros past ``n_out`` exactly, the same peak; a NaN in a row the
    outputs read makes the peak NaN; ``n_out`` 0 (``cut`` None) leaves
    zeros and the peak as it was."""
    buf, a, band, geo, out_cap = _bm_case(*pair, B, C, seed=len(IDS) + B)
    n_out = 0 if cut is None else out_cap - cut
    base = 3
    if poison:
        buf[base + 200, C] = float("nan")  # stream 1, channel 0, a row early outputs read
    want, want_peak = _aten_epilogue(buf, base, a, geo, out_cap, n_out, B, C)
    out = torch.full((B, out_cap, C), 7.0)
    peak = torch.zeros(())
    got, got_peak = kern.dma_banded_contract_bm(buf, base, a, out, peak, n_out=n_out, band=band, **geo)
    assert got is out and got_peak is peak
    assert torch.equal(out[:, n_out:], torch.zeros_like(out[:, n_out:]))
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6, rtol=0)
    if poison:
        assert torch.isnan(peak) and torch.isnan(want_peak)
    else:
        assert abs(peak.item() - want_peak.item()) <= 1e-6
        assert (peak.item() > 0) == (n_out > 0)


@pytest.mark.parametrize(
    "what,match",
    [("out_shape", "out must be"), ("out_cap", "out must be"), ("out_dtype", "out must be"),
     ("n_out", "n_out"), ("peak_shape", "peak"), ("peak_dtype", "peak")],
)
def test_bm_wrapper_refuses_what_the_kernel_does_not_take(what, match):
    buf, a, band, geo, out_cap = _bm_case(*PAIRS[0], 3, 2, seed=1)
    K, M = geo["K"], geo["M"]
    out, peak, n_out = torch.zeros((3, out_cap, 2)), torch.zeros(()), out_cap
    if what == "out_shape":
        out = torch.zeros((2, out_cap, 2))
    elif what == "out_cap":
        out = torch.zeros((3, K * M + 1, 2))
    elif what == "out_dtype":
        out = out.double()
    elif what == "n_out":
        n_out = out_cap + 1
    elif what == "peak_shape":
        peak = torch.zeros((1,))
    else:
        peak = peak.double()
    with pytest.raises((TypeError, ValueError), match=match):
        kern.dma_banded_contract_bm(buf, 0, a, out, peak, n_out=n_out, band=band, **geo)
