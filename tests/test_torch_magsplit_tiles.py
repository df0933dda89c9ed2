"""Kernel B4/B5's tiling (``ops/fft_magsplit_kernel.py`` ``MagsplitTilePlan``
and its packed weights) on the CPU: every group's pass-1 band is covered
once and its correction band once, no tile reads both ``prev`` and
``cur``; a torch-ops emulation of the kernel's tile loop (the x tile with
zeros past N, the select past the tile's width, the split, per k16 step
``hi * wh``, ``hi * t2l`` and ``lo * wh`` from the packed weights with
the correction band selected, the skipped steps) matches the plain
version summed in f64 within 1e-9 at six pairs, and the JAX package's
Pallas kernel in interpret mode within 1e-5 at the bench pair; a non-finite
input outside a group's band leaves that group finite; the packing refuses a
weight pair whose ``t2h`` half is not ``wh``'s slice.  The CUDA kernel is
held against the plain version in tests/test_torch_cuda.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from resampler_tpu.ops import fft_magsplit_kernel as jmag
from resampler_tpu_torch.ops import fft_magsplit_kernel as tmag
from resampler_tpu_torch.ops.matmul3 import split_hi_lo

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

#: (n_in, n_out): the bench pair, the stopband pair, cols 294 and 882,
#: rows 4410 and s 8
PAIRS = [(1176, 1280), (588, 1280), (1280, 1176), (1280, 3528), (3528, 1280), (2560, 2352)]
IDS = ["bench-1176-1280", "588-1280", "cols294-1280-1176", "cols882-1280-3528", "rows4410-3528-1280",
       "s8-2560-2352"]


def _inputs(R, n_in, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((R, n_in), dtype=np.float32)) for _ in range(2))


def _exact(prev, cur, wh, wcorr, plan):
    """The plain version's sums in f64, not rounded to f32."""
    hi, lo = (t.double() for t in split_hi_lo(torch.cat([prev, cur], dim=1)))
    outs = []
    for q in range(plan.s):
        r0 = q * plan.bps * plan.lp
        rb = r0 + plan.b0 * plan.lp
        hl = torch.cat([hi[:, rb : rb + plan.wc], lo[:, rb : rb + plan.wc]], dim=1)
        outs.append(hi[:, r0 : r0 + plan.rows] @ wh[q].double() + hl @ wcorr[q].double())
    return torch.cat(outs, dim=1)


def _emulate(prev, cur, wh, wcorr, plan):
    """The kernel's loop in torch ops, f64 sums: per group and tile the x
    tile as TMA stages it (zeros past N), columns outside ``[lo, hi)``
    selected to zero, the split, and per k16 step the products the kernel
    issues."""
    tp, packed, _ = tmag._kernel_weights(wh, wcorr, plan)
    w = packed.double().reshape(tp.n_wtiles, tmag.TILE_K, tp.cols_pad)
    R, n = prev.shape
    out = torch.zeros((R, plan.s * tp.cols_pad), dtype=torch.float64)
    col = torch.arange(tmag.TILE_K)
    for q in range(plan.s):
        acc = torch.zeros((R, tp.cols_pad), dtype=torch.float64)
        for src, c, lo, hi_end, wt, lt, clo, chi in tp.table[tp.starts[q] : tp.starts[q + 1]]:
            x = torch.zeros((R, tmag.TILE_K))
            part = (prev, cur)[src][:, c : c + tmag.TILE_K]
            x[:, : part.shape[1]] = part
            x = torch.where((col >= lo) & (col < hi_end), x, 0.0)
            hi, lo = (t.double() for t in split_hi_lo(x))
            corr = (col >= clo) & (col < chi)
            hc, lc = torch.where(corr, hi, 0.0), torch.where(corr, lo, 0.0)
            for k0 in range(0, hi_end, 16):
                k = slice(k0, k0 + 16)
                acc += hi[:, k] @ w[wt, k]
                if lt >= 0 and k0 < chi and k0 + 16 > clo:
                    acc += hc[:, k] @ w[lt, k] + lc[:, k] @ w[wt, k]
        out[:, q * tp.cols_pad : (q + 1) * tp.cols_pad] = acc
    return out.reshape(R, plan.s, tp.cols_pad)[:, :, : plan.cols].reshape(R, plan.n_out)


def _weights(pair):
    plan = tmag.plan_magsplit(*pair)
    return plan, *tmag.magsplit_weights(plan, "cpu")


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_tiles_cover_each_band_once(pair):
    plan = tmag.plan_magsplit(*pair)
    tp = tmag.MagsplitTilePlan(plan)
    n = plan.n_in
    assert tp.starts[0] == 0 and tp.starts[-1] == len(tp.tiles) == tp.table.shape[0]
    assert tp.cols_pad % tmag.TILE_COLS == 0 and tp.cols_pad - tmag.TILE_COLS < plan.cols <= tp.cols_pad
    n_w = 0
    for q in range(plan.s):
        r0 = q * plan.bps * plan.lp
        rb = r0 + plan.b0 * plan.lp
        band, corr = [], []
        for tile, row in zip(tp.tiles[tp.starts[q] : tp.starts[q + 1]], tp.table[tp.starts[q] : tp.starts[q + 1]]):
            assert tile.group == q and 0 <= tile.lo < 4 and tile.lo < tile.hi <= tmag.TILE_K
            # one tensor per tile, its first column on 16 bytes (TMA)
            assert 0 <= tile.col and tile.col % 4 == 0 and tile.col + tile.hi <= n
            x2 = tile.src * n + tile.col
            assert tile.band_row == x2 - r0
            band.extend(range(x2 + tile.lo, x2 + tile.hi))
            corr.extend(range(x2 + tile.corr_lo, x2 + tile.corr_hi))
            assert tuple(row[:4]) == (tile.src, tile.col, tile.lo, tile.hi) and row[4] == n_w
            assert (row[5] >= 0) == (tile.corr_hi > tile.corr_lo)
            n_w += 1 + (row[5] >= 0)
        assert band == list(range(r0, r0 + plan.rows))
        assert corr == list(range(rb, rb + plan.wc))
    assert n_w == tp.n_wtiles
    # the work it issues: the k the bound counts per output, plus at most
    # each tile's [lo, hi) rounded out to k16 steps and each correction range
    # rounded out to k16 steps at both ends (two passes)
    bound_k = plan.s * (plan.rows + 2 * plan.wc)
    n_corr = int((tp.table[:, 5] >= 0).sum())
    assert bound_k <= tp.issued_k() <= bound_k + 15 * len(tp.tiles) + 2 * 30 * n_corr


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_emulation_matches_plain(pair):
    plan, wh, wcorr = _weights(pair)
    for R, seed in ((8, 1), (3, 2)):
        prev, cur = _inputs(R, plan.n_in, seed)
        got = _emulate(prev, cur, wh, wcorr, plan)
        assert (got - _exact(prev, cur, wh, wcorr, plan)).abs().max().item() <= 1e-9
        ref = tmag.magsplit_projector_reference(prev, cur, wh, wcorr, plan=plan)
        assert (got - ref.double()).abs().max().item() <= 1e-5


def test_emulation_matches_jax_at_the_bench_pair():
    plan, wh, wcorr = _weights((1176, 1280))
    jp = jmag.plan_magsplit(1176, 1280)
    prev, cur = _inputs(8, 1176, seed=3)
    want = np.asarray(jmag.magsplit_projector(
        jnp.asarray(prev.numpy()), jnp.asarray(cur.numpy()), *jmag.magsplit_weights(jp), plan=jp,
        interpret=True))
    got = _emulate(prev, cur, wh, wcorr, plan).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("value", [float("inf"), float("nan")], ids=["inf", "nan"])
def test_non_finite_outside_a_band_leaves_the_group_finite(value):
    """At the bench pair, group 0's band is x2 columns [0, 1470): column
    1480 (cur 304) sits in the tail of its last tile, column 2000 beyond
    it; groups 1-3 start at 294.  A non-finite value there must not reach
    the groups whose band misses it (the select, never a multiply)."""
    plan, wh, wcorr = _weights((1176, 1280))
    prev, cur = _inputs(4, 1176, seed=5)

    def finite_groups(out):
        return torch.isfinite(out).reshape(4, plan.s, plan.cols).all(dim=2).all(dim=0).tolist()

    for x2, finite in ((1480, [True, False, False, False]), (2000, [True, True, False, False]),
                       (5, [False, True, True, True])):
        p, c = prev.clone(), cur.clone()
        (p if x2 < 1176 else c)[1, x2 % 1176] = value
        got = _emulate(p, c, wh, wcorr, plan)
        ref = tmag.magsplit_projector_reference(p, c, wh, wcorr, plan=plan)
        assert torch.equal(torch.isfinite(got), torch.isfinite(ref))
        assert finite_groups(got) == finite, x2
        assert bool(torch.isfinite(got[[0, 2, 3]]).all())


def test_packing_refuses_a_foreign_t2h_half():
    plan, wh, wcorr = _weights((1176, 1280))
    off = plan.b0 * plan.lp
    bad = wcorr.clone()
    bad[2, plan.wc + 17, 5] = -bad[2, plan.wc + 17, 5] + 1
    with pytest.raises(ValueError, match="t2h"):
        tmag.MagsplitTilePlan(plan).pack(wh, bad)
    assert torch.equal(wcorr[:, plan.wc :], wh[:, off : off + plan.wc])  # magsplit_weights' pair
