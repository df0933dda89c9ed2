"""Kernels B4 and B5 (the magsplit projector) on the CPU: the wrappers run
their plain PyTorch version, held against the JAX package's Pallas
kernels in interpret mode on the same seeded inputs.

Tolerance 1e-5: both sides multiply the identical bf16 operands (every
product is exact); the plain version sums them in f64 and rounds once,
the Pallas kernel sums them in f32, over up to rows + 2*wc = 3234 terms
(measured <= 1.2e-6 at outputs up to ~5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from resampler_tpu.ops import fft_magsplit_kernel as jmag
from resampler_tpu_torch.ops import _build
from resampler_tpu_torch.ops import fft_magsplit_kernel as tmag

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ATOL = 1e-5


def _inputs(R, n_in, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((R, n_in)).astype(np.float32),
        rng.standard_normal((R, n_in)).astype(np.float32),
    )


def _floor_db(out, prev, cur, n_in, n_out):
    ref = np.concatenate([prev, cur], axis=1).astype(np.float64) @ jmag._t2_f64(n_in, n_out)
    err = np.asarray(out, np.float64) - ref
    return -20 * np.log10(np.sqrt((err**2).mean() / (ref**2).mean()))


@pytest.mark.parametrize(
    "n_in,n_out,R", [(1176, 1280, 8), (588, 1280, 8), (588, 1280, 5), (1280, 1176, 3)],
    ids=["bench-pair", "stopband-pair", "ragged-R5", "ragged-cols-R3"],
)
def test_plain_b4_matches_jax_pallas(n_in, n_out, R):
    tp = tmag.plan_magsplit(n_in, n_out)
    jp = jmag.plan_magsplit(n_in, n_out)
    wh, wcorr = tmag.magsplit_weights(tp, "cpu")
    jwh, jwcorr = jmag.magsplit_weights(jp)
    prev, cur = _inputs(R, n_in, seed=11)
    before = dict(_build.LAUNCHES)
    got = tmag.magsplit_projector(
        torch.from_numpy(prev), torch.from_numpy(cur), wh, wcorr, plan=tp
    ).numpy()
    assert _build.LAUNCHES == before  # the CPU path launches nothing
    want = np.asarray(
        jmag.magsplit_projector(
            jnp.asarray(prev), jnp.asarray(cur), jwh, jwcorr, plan=jp, interpret=True
        )
    )
    assert got.shape == want.shape == (R, n_out)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the noise floor against the f64 operator, with the JAX test's slack
    assert _floor_db(got, prev, cur, n_in, n_out) >= tp.floor_db - 2.0


def test_plain_b5_matches_jax_pool():
    """The pool form reads its two slots in place (P = 3, slot pairs in
    both orders and the same slot twice) and equals JAX's pool kernel."""
    n_in, n_out, R = 588, 1280, 8
    tp, jp = tmag.plan_magsplit(n_in, n_out), jmag.plan_magsplit(n_in, n_out)
    wh, wcorr = tmag.magsplit_weights(tp, "cpu")
    jwh, jwcorr = jmag.magsplit_weights(jp)
    pool = np.random.default_rng(4).standard_normal((3, R, n_in)).astype(np.float32)
    tpool = torch.from_numpy(pool)
    for i, j in ((2, 0), (0, 1), (1, 1)):
        got = tmag.magsplit_projector_pool(tpool, i, j, wh, wcorr, plan=tp)
        want = jmag.magsplit_projector_pool(
            jnp.asarray(pool), i, j, jwh, jwcorr, plan=jp, interpret=True
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        direct = tmag.magsplit_projector(tpool[i], tpool[j], wh, wcorr, plan=tp)
        assert torch.equal(got, direct)


def test_non_finite_row_stays_in_its_row():
    """NaN in one row and Inf in another make those rows' outputs
    non-finite (where the bands reach them) and leave the other rows
    bit-equal, as the JAX package's split passes them through."""
    tp = tmag.plan_magsplit(588, 1280)
    wh, wcorr = tmag.magsplit_weights(tp, "cpu")
    prev, cur = (torch.from_numpy(x) for x in _inputs(6, 588, seed=3))
    clean = tmag.magsplit_projector(prev, cur, wh, wcorr, plan=tp)
    cur[1, 100] = float("nan")
    prev[4, 7] = float("inf")
    out = tmag.magsplit_projector(prev, cur, wh, wcorr, plan=tp)
    bad = ~torch.isfinite(out)
    assert bad[1].any() and bad[4].any()
    assert not bad[[0, 2, 3, 5]].any()
    assert torch.equal(out[[0, 2, 3, 5]], clean[[0, 2, 3, 5]])


def test_wrappers_check_arguments():
    tp = tmag.plan_magsplit(588, 1280)
    wh, wcorr = tmag.magsplit_weights(tp, "cpu")
    prev, cur = (torch.from_numpy(x) for x in _inputs(4, 588, seed=5))
    with pytest.raises(TypeError):
        tmag.magsplit_projector(prev.double(), cur, wh, wcorr, plan=tp)
    with pytest.raises(ValueError):
        tmag.magsplit_projector(prev[:, :-1], cur[:, :-1], wh, wcorr, plan=tp)
    with pytest.raises(ValueError):
        tmag.magsplit_projector(prev.T.contiguous().T, cur, wh, wcorr, plan=tp)
    with pytest.raises(ValueError):
        tmag.magsplit_projector(prev, cur, wcorr, wh, plan=tp)
    with pytest.raises(TypeError):
        tmag.magsplit_projector(prev, cur, wh.float(), wcorr, plan=tp)
    pool = torch.stack([prev, cur])
    with pytest.raises(IndexError):
        tmag.magsplit_projector_pool(pool, 0, 2, wh, wcorr, plan=tp)
    with pytest.raises(TypeError):
        tmag.magsplit_projector_pool(pool, 0, np.int32(1), wh, wcorr, plan=tp)
    # neither CPU nor CUDA: raises, never runs the plain version
    with pytest.raises(ValueError):
        tmag.magsplit_projector(
            prev.to("meta"), cur.to("meta"), wh.to("meta"), wcorr.to("meta"), plan=tp
        )


def test_kernel_weight_copy_layout():
    """The kernel-side weight copy (``MagsplitTilePlan.pack``): per K tile
    its ``wh`` rows with zero rows outside ``[lo, hi)``, and where it meets the
    correction band its ``t2l`` rows at their columns with zero rows
    elsewhere; columns zero-padded to whole 160-column tiles; the ``t2h``
    half of ``wcorr`` not copied; built once per (plan, device)."""
    for pair in ((1176, 1280), (1280, 1176), (588, 1280)):
        tp = tmag.plan_magsplit(*pair)
        wh, wcorr = tmag.magsplit_weights(tp, "cpu")
        plan, packed, _ = tmag._kernel_weights(wh, wcorr, tp)
        K, C = tmag.TILE_K, plan.cols_pad
        assert packed.shape == (plan.n_wtiles * K, C) and packed.dtype == torch.bfloat16
        assert C % 160 == 0 and C - 160 < tp.cols <= C
        w = packed.reshape(plan.n_wtiles, K, C)
        assert not w[:, :, tp.cols :].float().any()
        rb_off = tp.b0 * tp.lp
        for t, row in zip(plan.tiles, plan.table):
            q, b = t.group, t.band_row
            assert torch.equal(w[row[4], t.lo : t.hi, : tp.cols], wh[q, b + t.lo : b + t.hi])
            assert not w[row[4], : t.lo].float().any() and not w[row[4], t.hi :].float().any()
            if row[5] >= 0:
                lo, hi, c0 = t.corr_lo, t.corr_hi, b - rb_off
                assert torch.equal(w[row[5], lo:hi, : tp.cols], wcorr[q, c0 + lo : c0 + hi])
                assert not w[row[5], :lo].float().any() and not w[row[5], hi:].float().any()
        # the correction band's t2l rows once each, its t2h half never
        n_corr = int((plan.table[:, 5] >= 0).sum())
        assert plan.n_wtiles == len(plan.tiles) + n_corr
        assert tmag._kernel_weights(wh, wcorr, tp)[1] is packed  # built once
