"""Kernel B6b's tensor-core tiling (``ops/fir_async_kernel.py``
``AsyncTilePlan``, ``b_fragments``) on the CPU: every output's staged rows
are exactly the rows the plain version reads; a torch-ops emulation of
the kernel's loop (the staged prefix, the split, the parity-shifted word
copies, the gathered A rows, the four passes per k-step from the packed B
fragments, the shuffle-order combine) matches the plain version summed in
f64 within 1e-9 and the f32 plain version within the kernels' 1e-5, at
the card's async cases (a)-(g) at small R; the plan's checks of its
inputs.  The CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine import fir_fleets as tfleets
from resampler_tpu_torch.ops import fir_async_kernel as b6
from resampler_tpu_torch.ops.matmul3 import split_hi_lo
from resampler_tpu_torch.types import Attenuation, reduce_ratio

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

_U32 = (1 << 32) - 1
# chip_smoke.py's ASYNC_CASES at small R: (in_hz, out_hz, taps, R, skew,
# starved, outputs per tile)
CASES = {
    "a": (44100, 44101, 128, 6, 1, False, 128),
    "a-taps16": (44100, 44101, 16, 6, 1, False, 128),
    "a-taps64": (44100, 44101, 64, 4, 1, False, 128),
    "b-skew2": (22050, 96000, 128, 6, 2, False, 128),
    "c-48000-44101": (48000, 44101, 128, 6, 1, False, 128),
    "d-wide": (4_000_000_000, 4_000_000_001, 128, 6, 1, False, 128),
    "e-367500-1601": (367500, 1601, 128, 6, 1, False, 2),
    "f-ragged-R5": (44100, 44101, 32, 5, 1, False, 128),
    "g-starved": (44100, 44101, 128, 6, 1, True, 128),
}


def _plan(in_hz, out_hz, taps, skew, chunk=2048):
    """The plan of chip_smoke.py's ``async_plan``: the async fleet's
    ``max_out`` bound of a 2048-frame chunk."""
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=1, taps=taps, ratio_num=L, ratio_den=M)
    coeffs = tfir.fir_coefficients(taps, Attenuation.Db90, tfir.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz))
    out_cap = min(cfg.out_capacity, (chunk * M) // L + 128)
    plan = b6.async_combine_plan(
        A=tfir.farrow_matrix(coeffs)[0], L=L, M=M, out_cap=out_cap, skew_periods=skew,
        clamp_j=cfg.input_capacity + 2 if cfg.wide else None, precision="bf16x4",
    )
    return cfg, plan, (L, M)


def _decode(frags: np.ndarray) -> torch.Tensor:
    """The B operands ``[3, taps, 8]`` f64 back from their fragments."""
    n_b, ks = frags.shape[:2]
    w = frags.reshape(n_b, ks, 8, 4, 2)  # [basis, s, g, tig, word]
    halves = np.stack([w & 0xFFFF, w >> 16], -1).astype(np.uint32) << 16  # bf16 -> f32 bits
    vals = halves.view(np.float32)  # [basis, s, g, tig, word, half]
    # word 0: taps 2 tig, +1; word 1: taps 2 tig + 8, +9
    taps = vals.transpose(0, 1, 4, 3, 5, 2).reshape(n_b, ks * 16, 8)
    return torch.from_numpy(taps.astype(np.float64))


def _emulate(buffer, base0, n_out, lanes, plan):
    """B6b's loop in torch ops, f64 sums: per tile the staged prefix of its
    row map, the split, the word copies (copy p word w holds the pair
    starting at row 2w + p), each output's A rows gathered by word from
    its window start's copy, the four passes per k-step, the combine in
    the order of the two shuffle steps."""
    tp = plan.tiles
    R = buffer.shape[1]
    out = torch.zeros((plan.out_cap, R), dtype=torch.float64)
    b_hi, b_hic, b_lo = _decode(plan.frags)
    res, base_rel = lanes[0], lanes[1]
    off = torch.where((base_rel >= 1) & (base_rel <= plan.skew), base_rel, 0)
    lane_idx = torch.arange(R)[None, :, None]
    for t in range(tp.n_tiles):
        n0 = t * tp.outputs
        n_emit = min(tp.outputs, plan.out_cap - n0, n_out - n0)
        if n_emit <= 0:
            continue
        need = int(tp.win[n0 + n_emit - 1]) + tp.window
        words = (need + 1) // 2
        rows = torch.from_numpy(tp.rowmap[t, : 2 * words + 1].astype(np.int64))
        hi, lo = split_hi_lo(buffer[base0 + rows])
        copies = [torch.stack([x[p : p + 2 * words].reshape(words, 2, R) for p in (0, 1)]).double()
                  for x in (hi, lo)]  # [copy, word, 2, R]
        n = torch.arange(n0, n0 + n_emit)
        tt = (res[None, :] + torch.from_numpy(plan.s)[n][:, None]) & _U32
        wrap = (tt < res[None, :]) | (tt >= plan.M)
        rem = torch.where(wrap, (tt - plan.M) & _U32, tt)
        u = (2.0 * (rem.to(torch.float32) / torch.tensor(np.float32(plan.M))) - 1.0).double()
        row = torch.from_numpy(tp.win.astype(np.int64))[n][:, None] + off[None, :] + wrap.long()
        par, w0 = (row & 1)[..., None], (row >> 1)[..., None]
        acc = torch.zeros((4, n_emit, R, 8), dtype=torch.float64)
        for s in range(plan.taps // 16):
            word = w0 + 8 * s + torch.arange(8)  # the k-step's 8 pairs, taps 0-15 in order
            a_hi, a_lo = (c[par, word, :, lane_idx].reshape(n_emit, R, 16) for c in copies)
            k = slice(16 * s, 16 * s + 16)
            for p, (a, b) in enumerate(((a_hi, b_hi), (a_lo, b_hic), (a_hi, b_lo), (a_lo, b_lo))):
                acc[p] += a @ b[k]
        y = acc[0] + ((acc[1] + acc[2]) + acc[3])  # [n, R, 8]
        ts = [torch.ones_like(u), u]
        for _ in range(6):
            ts.append(2.0 * u * ts[-1] - ts[-2])
        part = [ts[2 * g] * y[..., 2 * g] + ts[2 * g + 1] * y[..., 2 * g + 1] for g in range(4)]
        out[n0 : n0 + n_emit] = (part[0] + part[1]) + (part[2] + part[3])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_every_output_stages_exactly_its_window(case):
    in_hz, out_hz, taps, _, skew, _, outputs = CASES[case]
    _, plan, _ = _plan(in_hz, out_hz, taps, skew)
    tp = plan.tiles
    assert tp.outputs == outputs
    assert tp.window == taps + skew + 1 and tp.rows <= b6.TC_ROWS_MAX
    assert tp.rowmap.shape == (tp.n_tiles, tp.rows_pad) and tp.win.shape == (plan.out_cap,)
    assert tp.n_tiles == -(-plan.out_cap // outputs)
    assert tp.pitch_w % 8 == 4 and 2 * tp.pitch_w >= tp.rows_pad
    for n in range(plan.out_cap):
        t = n // outputs
        got = tp.rowmap[t, tp.win[n] : tp.win[n] + tp.window]
        # the rows j[n] + off + c + t0 the plain version reads, every off
        # in [0, skew], c in {0, 1}, t0 < taps
        np.testing.assert_array_equal(got, plan.j[n] + np.arange(tp.window), err_msg=f"output {n}")
    # a tile's staged rows are its windows' union, in order, inside the
    # rows the wrapper checks against the ring
    for t in range(tp.n_tiles):
        rows = tp.rowmap[t]
        assert np.all(np.diff(rows) >= 0) and rows.max() < plan.reach
        jt = plan.j[t * outputs : (t + 1) * outputs]
        union = np.unique((jt[:, None] + np.arange(tp.window)).ravel())
        np.testing.assert_array_equal(rows[: union.size], union)
        assert np.all(rows[union.size :] == union[-1])
    # the B fragments hold a_hi, a_hi_c (zero past the degree cut) and a_lo
    b = _decode(plan.frags).numpy()
    np.testing.assert_array_equal(b[0], plan.a_hi.T)
    np.testing.assert_array_equal(b[1], plan.a_hi_c.T)
    np.testing.assert_array_equal(b[2], plan.a_lo.T)
    assert not plan.a_hi_c[plan.dc + 1 :].any()


@pytest.mark.parametrize("case", list(CASES))
def test_emulation_matches_plain(case):
    in_hz, out_hz, taps, R, skew, starved, _ = CASES[case]
    cfg, plan, (L, M) = _plan(in_hz, out_hz, taps, skew)
    ring = tfleets._ring_rows(cfg, 2048, 16)
    rng = np.random.default_rng(len(case) + taps)
    buf = torch.from_numpy(rng.standard_normal((ring, R), dtype=np.float32))
    res = rng.integers(0, M, R)
    base_rel = rng.integers(0, skew + 1 + (6 if starved else 0), R)
    if starved:
        base_rel[0] = skew + 3  # a frame skew past skew_periods reads offset 0
    lanes = torch.from_numpy(np.stack([res, base_rel]))
    n_main = min(plan.out_cap, (2048 * M) // L)
    top = ring - plan.reach
    for base0 in (0, 3, top):
        for n_out in sorted({0, 1, n_main, plan.out_cap}):
            got = _emulate(buf, base0, n_out, lanes, plan)
            exact = b6._reference(buf, base0, n_out, lanes, plan, torch.float64)
            ref = b6.async_combine_reference(buf, base0, n_out, lanes, plan)
            assert (got - exact).abs().max().item() <= 1e-9, (base0, n_out)
            assert (got - ref.double()).abs().max().item() <= 1e-5, (base0, n_out)
            assert not got[n_out:].any()


@pytest.mark.parametrize(
    "j,taps,skew,match",
    [
        (np.arange(8), 48, 1, "taps"),
        (np.arange(8), 256, 1, "taps"),
        (np.arange(8), 128, 0, "skew"),
        (np.arange(8), 128, 200, "skew"),
        (np.array([0, 2, 1]), 32, 1, "non-decreasing"),
        (np.array([-1, 0]), 32, 1, "non-decreasing"),
        (np.zeros(0, np.int64), 32, 1, "non-empty"),
    ],
    ids=["taps48", "taps256", "skew0", "window", "decreasing", "negative", "empty"],
)
def test_tile_plan_checks_its_inputs(j, taps, skew, match):
    with pytest.raises(ValueError, match=match):
        b6.AsyncTilePlan(j, taps, skew)


def test_tile_outputs_fall_back_where_windows_are_disjoint():
    """At 128 taps, outputs 3 rows apart: 128 would stage 511 rows, 64
    stage 319 (the cap is 320); 128 apart: a tile is 2 outputs' disjoint
    windows, and 1 when a window passes half the cap.  The plain
    plan at 48 taps builds (the CPU runs the plain version) while its
    tiles raise."""
    tp = b6.AsyncTilePlan(np.arange(256) * 3, 128, 1)
    assert (tp.outputs, tp.rows) == (64, 319)
    assert b6.AsyncTilePlan(np.arange(0, 4096, 128), 128, 1).outputs == 2
    assert b6.AsyncTilePlan(np.arange(0, 4096, 256), 128, 40).outputs == 1
    plan = b6.async_combine_plan(A=np.ones((8, 48), np.float32), L=1, M=1, out_cap=8, skew_periods=1,
                                 precision="bf16x4")
    with pytest.raises(ValueError, match="taps"):
        plan.tiles
