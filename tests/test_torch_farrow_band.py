"""Kernel B2's band plan (``ops/fir_dma_kernel.py FarrowBandPlan``): every
nonzero weight the plain ``farrow_weights`` gives a row lies inside its row
tile's columns, at residue words that sweep each row's wrap, on the farrow,
wide, lerp and q 8-16 plans; a torch-ops emulation of the band kernel's
loop (each tile summed over its band only, in slices) matches the plain
full contraction; the plan's and the wrapper's checks; the counter
``fir.banded_steps`` off the card.  The CUDA kernel itself is held against
the plain version in tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import resampler_tpu_torch as rt
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine import fir_fleets as tfleets
from resampler_tpu_torch.ops import fir_dma_kernel as kern
from resampler_tpu_torch.types import Attenuation, reduce_ratio
from resampler_tpu_torch.utils import tracing

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ATOL = 1e-5  # the B2 tests' f32 tolerance (tests/test_torch_farrow_kernel.py)
TAPS = 128
U32 = 1 << 32
#: (in_hz, out_hz, basis): the `fir.farrow` and `fir.wide` cells' plans, the
#: lerp basis, and plans of q 8 and 16 (one 32-row tile wider than a block)
PLANS = [
    (44100, 44101, "cheb"),
    (48000000, 48000066, "cheb"),
    (44100, 44101, "lerp"),
    (48000, 6001, "cheb"),
    (48000, 12001, "cheb"),
]
IDS = ["farrow", "wide", "lerp", "q8", "q16"]


def _plan(in_hz, out_hz, basis, clamp=None):
    """The tm fleet's Farrow plan at the pair, its band plan and ``M``.
    ``clamp``: ``j_loc`` cut at that many frames past each block's base,
    as the wide plan cuts the offsets of lanes no buffer can emit."""
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=1, taps=TAPS, ratio_num=L, ratio_den=M)
    coeffs = tfir.fir_coefficients(
        TAPS, Attenuation.Db90, tfir.fir_cutoff(TAPS, Attenuation.Db90, in_hz / out_hz)
    )
    fp = tfleets._farrow_tm_plan(cfg, coeffs, basis=basis)
    if clamp is not None:
        fp = dict(fp, j_loc=np.minimum(fp["j_loc"], clamp).astype(np.int32))
    band = kern.FarrowBandPlan(fp["j_loc"], TAPS, fp["w_blk"])
    return fp, band, M, cfg.wide


def _words(fp, M: int, wide: bool, seed: int, u32: bool = True) -> list:
    """Positions whose residue words sweep the wrap: 0, M - 1, and for 24
    seeded splits ``s`` the word at which that split wraps and the one
    below it; on the wide schedule (``pos_lo`` beside a ``pos_hi``) with
    ``u32`` also the words past ``M`` at which its u32 sum wraps past
    2^32 (the weights kernel's range; their residues are no phase, so
    their weights are large)."""
    s = np.unique(fp["s_pad"])
    s = np.random.default_rng(seed).choice(s[s > 0], 24, replace=False).astype(np.int64)
    words = {0, M - 1, *(M - s).tolist(), *(M - s - 1).tolist()}
    if wide:
        if u32:
            words |= {*(U32 - s).tolist(), *(U32 - s - 1).tolist()}
        return [(3, w) for w in sorted(words)]
    return sorted(words)


def _weights(fp, M, pos):
    ashift2 = torch.from_numpy(fp["ashift2"])
    return tfleets.farrow_weights(fp, M, pos, ashift2).numpy()


@pytest.mark.parametrize("plan", PLANS, ids=IDS)
def test_every_nonzero_weight_lies_in_its_tiles_band(plan):
    """At each position, each row's nonzero weights lie in its tile's
    ``[lo, hi)``, and the band reaches no further than the rows need: its
    first column is some row's first tap, its last some wrapped row's
    last (or the block's edge); each row's own band ``[j_loc + wrap, +
    taps)`` lies inside for both carries."""
    fp, band, M, wide = _plan(*plan)
    K, q, w = band.shape
    assert (K, q, w) == (fp["K"], fp["q"], fp["w_blk"])
    assert band.tiles.shape == (K, -(-q // kern.FARROW_ROWS), 2)
    cols = np.arange(w)
    lo, hi = band.tiles[..., 0], band.tiles[..., 1]
    tile_of_row = np.arange(q) // kern.FARROW_ROWS
    row_lo, row_hi = lo[:, tile_of_row], hi[:, tile_of_row]  # [K, q]
    for wrap in (0, 1):
        first = fp["j_loc"] + wrap
        assert np.all(row_lo <= first) and np.all(np.minimum(first + TAPS, w) <= row_hi)
    assert np.all(lo == fp["j_loc"][:, :: kern.FARROW_ROWS])  # offsets rise down a block
    inside = (cols >= row_lo[..., None]) & (cols < row_hi[..., None])  # [K, q, w]
    wraps = set()
    for pos in _words(fp, M, wide, seed=q):
        a_blk = _weights(fp, M, pos)
        assert not np.any(a_blk[~inside]), f"{pos}: a nonzero weight outside its tile's band"
        wraps.add(tfir.lane_residues(fp["s_pad"], M, pos)[0].sum())
    assert len(wraps) > 2  # the words moved rows across the wrap


def test_band_covers_the_wide_plans_clamped_offsets():
    """Offsets cut short (the wide plan's clamp of lanes past the buffer)
    keep every row inside its tile's band, and the bands shrink with them."""
    fp, band, M, _ = _plan(48000000, 48000066, "cheb")
    cut = int(fp["j_loc"][0, 40])
    fp_c, band_c, _, _ = _plan(48000000, 48000066, "cheb", clamp=cut)
    assert np.all(band_c.tiles <= band.tiles) and np.any(band_c.tiles[:, 1, 1] < band.tiles[:, 1, 1])
    cols = np.arange(band_c.shape[2])
    tiles = band_c.tiles[:, np.arange(band_c.shape[1]) // kern.FARROW_ROWS]  # [K, q, 2]
    inside = (cols >= tiles[..., :1]) & (cols < tiles[..., 1:])
    for pos in _words(fp_c, M, True, seed=5)[:12]:
        assert not np.any(_weights(fp_c, M, pos)[~inside])


def test_plan_work_at_the_cells_shape():
    """At ``fir.farrow``'s plan (K 63, q 64, w 192) two 32-row tiles take
    159-160 columns each (the last block's, whose rows past ``out_cap``
    repeat the last offset, fewer): 0.831 of the full width's work, 1.246x
    the taps-wide."""
    _, band, _, _ = _plan(44100, 44101, "cheb")
    K, q, w = band.shape
    assert (K, q, w, band.n_tiles) == (63, 64, 192, 2)
    widths = band.tiles[..., 1] - band.tiles[..., 0]
    assert set(np.unique(widths[:-1])) == {159, 160}
    assert band.issued() == 32 * int(widths.sum()) == 643168
    assert abs(band.issued() / (K * q * w) - 0.831) < 1e-3
    assert abs(band.issued() / (K * q * TAPS) - 1.246) < 1e-3


def _emulate(buf, base, a_blk, bb, band):
    """The band kernel's loop in torch ops: each tile of ``FARROW_ROWS``
    rows of block ``k`` sums over its columns ``[lo, hi)`` only,
    ``BAND_DEPTH`` at a time, in f64 (the sum's order is the kernel's own
    business; f64 keeps the comparison to the f32 plain version's rounding
    alone)."""
    K, q, _ = a_blk.shape
    buf, a_blk = buf.double(), a_blk.double()
    out = torch.zeros((K, q, buf.shape[1]), dtype=torch.float64)
    for k in range(K):
        row = base + int(bb[k])
        for t, (lo, hi) in enumerate(band.tiles[k].tolist()):
            j = slice(t * kern.FARROW_ROWS, min((t + 1) * kern.FARROW_ROWS, q))
            for s0 in range(lo, hi, kern.BAND_DEPTH):
                s1 = min(s0 + kern.BAND_DEPTH, hi)
                out[k, j] += a_blk[k, j, s0:s1] @ buf[row + s0 : row + s1]
    return out


def _full_f64(buf, base, a_blk, bb):
    w = a_blk.shape[2]
    rows = torch.from_numpy(base + np.asarray(bb)[:, None] + np.arange(w))
    return torch.einsum("kqw,kwr->kqr", a_blk.double(), buf.double()[rows])


@pytest.mark.parametrize("plan", PLANS, ids=IDS)
def test_band_emulation_matches_plain(plan):
    """The band's sum equals the full width's: against the plain version's
    sum taken in f64 within 1e-9, f64 rounding alone (a band one column
    short loses edge taps of ~1e-3 here); against the f32 plain version
    within the kernels' 1e-5.  The weights are the plain ``farrow_weights``
    at three positions, one on each side of a row's wrap."""
    fp, band, M, wide = _plan(*plan)
    bb = fp["block_base"]
    rows = int(bb.max()) + fp["w_blk"]
    rng = np.random.default_rng(sum(plan[:2]) % 1000)
    buf = torch.from_numpy(rng.standard_normal((rows + 13, 4), dtype=np.float32))
    words = _words(fp, M, wide, seed=7, u32=False)
    for pos in (words[0], words[len(words) // 2], words[-1]):
        a_blk = torch.from_numpy(_weights(fp, M, pos))
        for base in (1, 13):  # an odd base and the top bound
            ref = kern.dma_farrow_contract_reference(buf, base, a_blk, bb)
            got = _emulate(buf, base, a_blk, bb, band)
            assert (got - _full_f64(buf, base, a_blk, bb)).abs().max().item() <= 1e-9
            assert (got - ref.double()).abs().max().item() <= ATOL
            # the CPU wrapper runs the plain version whatever the band
            assert torch.equal(kern.dma_farrow_contract(buf, base, a_blk, bb, band=band), ref)


def test_a_band_one_column_short_fails_the_emulation():
    """The emulation's f64 check sees a band that drops one edge column."""
    fp, band, M, _ = _plan(44100, 44101, "cheb")
    bb = fp["block_base"][:4]
    short = kern.FarrowBandPlan(fp["j_loc"][:4], TAPS - 1, fp["w_blk"])
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(rng.standard_normal((int(bb.max()) + fp["w_blk"] + 1, 4),
                                               dtype=np.float32))
    a_blk = torch.from_numpy(_weights(fp, M, M - 1)[:4])
    want = _full_f64(buf, 1, a_blk, bb)
    assert (_emulate(buf, 1, a_blk, bb, kern.FarrowBandPlan(fp["j_loc"][:4], TAPS, fp["w_blk"]))
            - want).abs().max().item() <= 1e-9
    assert (_emulate(buf, 1, a_blk, bb, short) - want).abs().max().item() > 1e-7


@pytest.mark.parametrize(
    "j_loc,taps,w",
    [(np.zeros((0, 4), np.int32), 8, 16), (np.zeros((2, 4), np.float32), 8, 16),
     (np.zeros(4, np.int32), 8, 16), (np.full((2, 4), -1), 8, 16), (np.full((2, 4), 16), 8, 16),
     (np.zeros((2, 4), np.int32), 0, 16)],
    ids=["empty", "float", "1-d", "negative", "past-w", "no-taps"],
)
def test_plan_refuses_offsets_it_cannot_band(j_loc, taps, w):
    with pytest.raises(ValueError):
        kern.FarrowBandPlan(j_loc, taps, w)


def test_wrappers_refuse_a_plan_for_other_weights():
    """B2's wrappers check the plan against ``a_blk``'s ``[K, q, w]`` on
    any device, before the plain version runs."""
    fp, band, M, _ = _plan(44100, 44101, "cheb")
    bb = fp["block_base"]
    buf = torch.zeros((int(bb.max()) + fp["w_blk"], 4))
    a_blk = torch.zeros(band.shape)
    kern.dma_farrow_contract(buf, 0, a_blk, bb, band=band)
    for other in (a_blk[:, :, :-1].contiguous(), a_blk[:, :32].contiguous()):
        with pytest.raises(ValueError, match="band plan"):
            kern.dma_farrow_contract(buf, 0, other, bb, band=band)
    out, peak = torch.zeros((2, 4000, 2)), torch.zeros(())
    with pytest.raises(ValueError, match="band plan"):
        kern.dma_farrow_contract_bm(buf, 0, a_blk[:, :32].contiguous(), bb, out, peak, n_out=10,
                                    band=band)


@pytest.mark.parametrize("in_hz,out_hz", [(44100, 44101), (48000, 1601)], ids=["b2", "b3"])
def test_banded_steps_read_zero_off_the_card(in_hz, out_hz):
    """On the CPU the farrow fleet's contraction is the plain version: it
    reads no band table, so ``fir.banded_steps`` stays 0 while
    ``fir.farrow_steps`` counts every emitting step (the card's B2 steps
    count in both: tests/test_torch_cuda.py)."""
    B, C, n = 2, 2, 1024
    fleet = rt.BatchedResamplerFir(B, C, in_hz, out_hz, rt.Latency.Sample64, rt.Attenuation.Db90,
                                   synchronized=True, max_chunk=n, device="cpu")
    rng = np.random.default_rng(4)
    tracing.reset_counters()
    for _ in range(3):
        fleet.resample(rng.standard_normal((B, n, C), dtype=np.float32))
    c = tracing.counters()
    assert c["fir.farrow_steps"] == 3 and c["fir.banded_steps"] == 0
