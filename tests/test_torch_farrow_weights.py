"""The farrow tm step's weights kernel on the CPU
(``resampler_tpu_torch.ops.fir_dma_kernel.FarrowWeightsKernel``, its C
entry ``fir_farrow_weights``): the wrapper's checks; the tm step's dispatch,
which off the card builds the weights with ``farrow_weights``, bit for bit,
and launches no weights kernel (``launches.farrow_weights`` stays 0); and a
torch-ops emulation of the kernel's rule per output row (the u32 residue, the offset
``jl = j_loc + wrap``, the band columns) against ``lane_residues``,
``j_loc`` and the plain weights, for the farrow, lerp, wide and packed
(B3) plans.  The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine import fir_fleets
from resampler_tpu_torch.ops import _build
from resampler_tpu_torch.ops import fir_dma_kernel as kern
from resampler_tpu_torch.types import Attenuation, Latency, reduce_ratio
from resampler_tpu_torch.utils import tracing

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

U32 = (1 << 32) - 1
TAPS = 128
#: (in_hz, out_hz, basis): B2 at q 64 in both bases, the wide u32 pair, B3
PLANS = [(44100, 44101, "cheb"), (44100, 44101, "lerp"), (600011, 600013, "cheb"),
         (48000, 1601, "cheb")]
PLAN_IDS = ["farrow", "lerp", "wide", "packed"]


def _plan(in_hz, out_hz, basis, taps=TAPS):
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=2, taps=taps, ratio_num=L, ratio_den=M)
    coeffs = tfir.fir_coefficients(
        taps, Attenuation.Db90, tfir.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz)
    )
    return cfg, coeffs, fir_fleets._farrow_tm_plan(cfg, coeffs, basis=basis)


def _emulate(fp, M: int, word: int, taps: int):
    """The kernel's rule per output row in torch int64 ops, from the
    tables as it reads them: ``(wrap, rem, jl, band)``, ``band [K, q, w]``
    the columns ``0 <= s - jl < taps``."""
    s_pad, j_loc = fir_fleets.farrow_weight_tables(fp, "cpu")[:2]
    s = s_pad.to(torch.int64) & U32  # the int32 tensor holds u32 bits
    t = (word + s) & U32
    wrap = (t < word) | (t >= M)
    rem = torch.where(wrap, (t - M) & U32, t)
    jl = j_loc.to(torch.int64) + wrap
    off = torch.arange(fp["w_blk"]) - jl[..., None]
    return wrap, rem, jl, (off >= 0) & (off < taps)


def _words(fp, M: int, wide: bool, rng) -> list[int]:
    """Residue words: 0, 1, 43, M - 1, the words at which the largest and
    the smallest non-zero split wrap and the words below them, random
    words; when wide, words near 2^32 whose u32 sums wrap."""
    s = np.unique(fp["s_pad"])
    s = s[s > 0]
    words = [0, 1, 43, M - 1]
    for x in (int(s.max()), int(s.min())):
        words += [M - x, M - x - 1]
    words += [int(v) for v in rng.integers(0, M, 3)]
    if wide:
        words += [U32, U32 - int(s.min()) + 1, U32 - int(s.max()), int(rng.integers(M, U32))]
    return words


@pytest.mark.parametrize("plan", PLANS, ids=PLAN_IDS)
def test_emulated_index_rule_equals_lane_residues(plan):
    """The kernel's u32 rule gives ``lane_residues``' wrap and residue and
    the plain weights' offsets and band, exactly, for the narrow residue
    word ``pos % M`` and the wide ``pos_lo``; and the plain weights (the
    positioning matmul) are exactly 0 outside that band and, inside it,
    the f64 sum of the band's basis products within f32 rounding."""
    cfg, _, fp = _plan(*plan)
    M, taps, wide = cfg.ratio_den, cfg.taps, cfg.wide
    ashift2 = torch.from_numpy(fp["ashift2"])
    A = fir_fleets.farrow_weight_tables(fp, "cpu")[2].numpy().astype(np.float64)
    rng = np.random.default_rng(22)
    for word in _words(fp, M, wide, rng):
        pos = (int(rng.integers(0, 1 << 20)), word) if wide else int(rng.integers(0, 9)) * M + word
        wrap, rem, jl, band = _emulate(fp, M, word, taps)
        want_wrap, want_rem = tfir.lane_residues(fp["s_pad"], M, pos)
        assert np.array_equal(wrap.numpy(), want_wrap.astype(bool)), word
        assert np.array_equal(rem.numpy(), np.asarray(want_rem, np.int64)), word
        assert np.array_equal(jl.numpy(), fp["j_loc"] + want_wrap), word
        assert int(jl.max()) < fp["n_jl"] and int(jl.min()) >= 0
        plain = fir_fleets.farrow_weights(fp, M, pos, ashift2).numpy()
        assert not plain[~band.numpy()].any(), word
        coef = tfir.combine_basis(want_rem, M, fp["U"]).astype(np.float64)  # [K, q, d1]
        cols = np.arange(fp["w_blk"]) - jl.numpy()[..., None]  # [K, q, w]
        terms = coef[..., :, None] * A[:, np.clip(cols, 0, taps - 1)].transpose(1, 2, 0, 3)
        terms = np.where(band.numpy()[..., None, :], terms, 0.0)
        bound = 8 * 2.0**-24 * np.abs(terms).sum(-2)
        assert (np.abs(plain - terms.sum(-2)) <= bound).all(), word


@pytest.mark.parametrize("plan", PLANS, ids=PLAN_IDS)
def test_weight_tables_hold_the_plans_basis(plan):
    """The kernel's tables: the splits' u32 bits, the offsets, the basis
    rows the plan's ``ashift2`` positions (the Chebyshev fit, or the SVD
    table basis and its factor for lerp), exactly."""
    cfg, coeffs, fp = _plan(*plan)
    s_pad, j_loc, basis, U = fir_fleets.farrow_weight_tables(fp, "cpu")
    assert s_pad.dtype == j_loc.dtype == torch.int32 and basis.is_contiguous()
    assert np.array_equal(s_pad.numpy().view(np.uint32), fp["s_pad"])
    assert np.array_equal(j_loc.numpy(), fp["j_loc"])
    if plan[2] == "lerp":
        want_U, want_A = tfir._table_svd_basis(coeffs)
        assert np.array_equal(U.numpy(), want_U)
    else:
        want_A, _ = tfir.farrow_matrix(coeffs)
        assert U is None
    assert np.array_equal(basis.numpy(), want_A)


def _step(cfg, coeffs, path, contraction, B=2, chunk=512):
    return fir_fleets.make_fir_fleet_step_sync_tm(
        cfg, coeffs, B, max_chunk=chunk, horizon=3, path=path, contraction=contraction,
        out_layout="tm", device="cpu",
    )


@pytest.mark.parametrize("contraction", ["auto", "xla", "dma_interpret"])
@pytest.mark.parametrize("plan", PLANS, ids=PLAN_IDS)
def test_cpu_step_contracts_farrow_weights_bit_for_bit(plan, contraction, monkeypatch):
    """Off the card the tm step's weights are ``farrow_weights``' own, bit
    for bit, on every emitting step, and ``launches.farrow_weights`` stays 0
    while ``fir.farrow_steps`` counts; nothing launches."""
    cfg, coeffs, fp = _plan(*plan)
    path = "lerp" if plan[2] == "lerp" else "farrow"
    seen = []
    for name in ("dma_farrow_contract", "dma_farrow_contract_packed",
                 "dma_farrow_contract_reference"):
        real = getattr(fir_fleets, name)
        monkeypatch.setattr(fir_fleets, name, lambda buf, base, a_blk, bb, real=real: (
            seen.append(a_blk.clone()), real(buf, base, a_blk, bb))[1])
    step = _step(cfg, coeffs, path, contraction)
    B, chunk = 2, 512
    state = fir_fleets.fir_fleet_init_sync_tm(cfg, B, max_chunk=chunk, horizon=3, device="cpu")
    ashift2 = torch.from_numpy(fp["ashift2"])
    rng = np.random.default_rng(5)
    tracing.reset_counters()
    before = dict(_build.LAUNCHES)
    emitted = 0
    for _ in range(5):
        pos = (state["pos_hi"], state["pos_lo"]) if cfg.wide else state["pos_num"]
        chunks = torch.from_numpy(rng.standard_normal((chunk, B * cfg.channels), dtype=np.float32))
        state, _, _, n_out = step(state, chunks, chunk)
        if n_out:
            emitted += 1
            assert len(seen) == emitted
            assert torch.equal(seen[-1], fir_fleets.farrow_weights(fp, cfg.ratio_den, pos, ashift2))
    assert emitted >= 2
    c = tracing.counters()
    assert c["fir.farrow_steps"] == emitted and c["launches.farrow_weights"] == 0
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("basis", ["cheb", "lerp"])
@pytest.mark.parametrize("attenuation", list(Attenuation), ids=lambda a: a.name)
@pytest.mark.parametrize("latency", list(Latency), ids=lambda l: l.name)
def test_every_latency_and_attenuation_fits_the_weights_kernel(latency, attenuation, basis):
    """Every plan the tm step can build, in both bases, at every filter
    length and attenuation, near-unity, downsampling (B3), upsampling and
    wide ratios, has at most the kernel's 16 basis rows, and its tables
    pass every check of the wrapper up to the device (the card's step
    builds the kernel from them, with no other path)."""
    for in_hz, out_hz in ((44100, 44101), (48000, 1601), (1601, 48000), (600011, 600013)):
        L, M = reduce_ratio(in_hz, out_hz)
        cfg = tfir.FirConfig(channels=2, taps=latency.taps, ratio_num=L, ratio_den=M)
        coeffs = tfir.fir_coefficients(
            latency.taps, attenuation, tfir.fir_cutoff(latency.taps, attenuation, in_hz / out_hz)
        )
        fp = fir_fleets._farrow_tm_plan(cfg, coeffs, basis=basis)
        assert 1 <= fp["d1"] <= kern._WEIGHTS_D1_MAX, (in_hz, out_hz, fp["d1"])
        with pytest.raises(ValueError, match="CUDA device"):
            kern.FarrowWeightsKernel(*fir_fleets.farrow_weight_tables(fp, "cpu"), M=M,
                                     w=fp["w_blk"])


def _args(**change):
    """Valid arguments of ``FarrowWeightsKernel`` for a 2 x 8 lerp plan on
    the CPU, with ``change`` applied."""
    args = dict(s_pad=torch.zeros((2, 8), dtype=torch.int32),
                j_loc=torch.zeros((2, 8), dtype=torch.int32),
                basis=torch.zeros((8, 16)), U=torch.zeros((1024, 8)), M=44101, w=24)
    args.update(change)
    return args


REFUSALS = {
    "s_pad-int64": (dict(s_pad=torch.zeros((2, 8), dtype=torch.int64)), TypeError, "s_pad"),
    "j_loc-float": (dict(j_loc=torch.zeros((2, 8))), TypeError, "j_loc"),
    "basis-float64": (dict(basis=torch.zeros((8, 16), dtype=torch.float64)), TypeError, "basis"),
    "U-1d": (dict(U=torch.zeros(1024)), TypeError, "U"),
    "s_pad-strided": (dict(s_pad=torch.zeros((8, 2), dtype=torch.int32).T), ValueError,
                      "contiguous"),
    "j_loc-shape": (dict(j_loc=torch.zeros((2, 9), dtype=torch.int32)), ValueError, r"\[K, q\]"),
    "d1-over-max": (dict(basis=torch.zeros((17, 16)), U=torch.zeros((1024, 17))), ValueError,
                    "d1"),
    "d1-zero": (dict(basis=torch.zeros((0, 16)), U=None), ValueError, "d1"),
    "U-columns": (dict(U=torch.zeros((1024, 7))), ValueError, "U must be"),
    "M-zero": (dict(M=0), ValueError, "M"),
    "M-past-u32": (dict(M=1 << 32), ValueError, "M"),
    "w-below-taps": (dict(w=15), ValueError, "w must"),
    "cpu": ({}, ValueError, "CUDA device"),
    "cpu-cheb": (dict(U=None), ValueError, "CUDA device"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_weights_kernel_wrapper_refuses(case):
    """A wrong dtype, shape, size or device raises when the kernel's tables
    are bound, before any launch (on the CPU every valid set of tables
    reaches the device check)."""
    change, exc, match = REFUSALS[case]
    before = _build.LAUNCHES["farrow_weights"]
    with pytest.raises(exc, match=match):
        kern.FarrowWeightsKernel(**_args(**change))
    assert _build.LAUNCHES["farrow_weights"] == before


@pytest.mark.parametrize("word,lerp", [(1 << 32, False), (-1, False), (44101, True), (3.0, False),
                                       (True, False)],
                         ids=["past-u32", "negative", "lerp-past-M", "float", "bool"])
def test_weights_kernel_refuses_a_word_outside_its_range(word, lerp, monkeypatch):
    """A step's word is an int in [0, 2^32), below M for the lerp basis
    (its ``p1 = rem * phases // M`` reads a row of U); the check comes
    before any launch.  The device check is passed over, as on the card."""
    monkeypatch.setattr(kern, "_device_kind", lambda t: "cuda")
    weights = kern.FarrowWeightsKernel(**_args(U=torch.zeros((1024, 8)) if lerp else None))

    def launch(*args):
        raise AssertionError("launched")

    monkeypatch.setattr(kern, "_launch", launch)
    with pytest.raises(ValueError, match="word"):
        weights(word)
    with pytest.raises(AssertionError, match="launched"):  # a word in range goes on
        weights(44100)
