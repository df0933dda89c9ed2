"""Kernels B2 and B3 (blocked Farrow contraction): the port's plain version
against the JAX package's Pallas kernels (interpret mode) and a direct
numpy sum, and the wrappers' argument and bounds checks; B2's fused
epilogue (``dma_farrow_contract_bm``) against the time-major form followed
by the mask, the relayout and ``abs().amax()``.  The CUDA kernels
themselves are held against the plain version in tests/test_torch_cuda.py
and chip_smoke.py.

The port's wrappers take the weights ``a_blk [K, q, w]`` unshifted and read
``base + block_base[k]`` exactly; the TPU kernels read from the 8-row
aligned floor, so the test builds their pre-shifted weights
``a_shift[k, l, s + rem_k] = a_blk[k, l, s]``, ``rem_k = (base +
block_base[k]) % 8`` (and, for the packed kernel, the block-diagonal
group layout with K padded to a group multiple by repeating the last
block), as the JAX fleet does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from resampler_tpu.ops.fir_dma_kernel import (
    dma_farrow_contract as jax_b2,
    dma_farrow_contract_packed as jax_b3,
)
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine import fir_fleets as tfleets
from resampler_tpu_torch.ops import fir_dma_kernel as kern
from resampler_tpu_torch.types import reduce_ratio

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

# f32 sums in another order: the JAX suite's own dma-vs-xla tolerance for
# this path (tests/test_pallas.py)
ATOL = 1e-5
# (in_hz, out_hz) -> q at 32 taps: 64 (B2), and 4, 2, 1 (B3)
PAIRS = [(44100, 44101), (48000, 3001), (48000, 1601), (367500, 1601)]


def _case(in_hz, out_hz, R, seed=0, k_max=5):
    """A plan's block geometry (first ``k_max`` blocks), random weights
    and a ring with room past the region for the TPU kernels' aligned
    over-read."""
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=1, taps=32, ratio_num=L, ratio_den=M)
    coeffs = np.zeros((tfir.PHASES, 32), np.float32)
    plan = tfleets._farrow_tm_plan(cfg, coeffs)
    K, q, w = min(plan["K"], k_max), plan["q"], plan["w_blk"]
    bb = plan["block_base"][:K]
    rng = np.random.default_rng(seed)
    # weights of a filter's scale: each output sums to O(1)
    a_blk = (rng.standard_normal((K, q, w)) / np.sqrt(w)).astype(np.float32)
    rows = int(bb.max()) + w
    buf = rng.standard_normal((rows + 61, R)).astype(np.float32)
    bases = [1, 5, 13, buf.shape[0] - rows]  # base % 8 != 0, and the top bound
    return buf, a_blk, bb, bases


def _numpy_sum(buf, base, a_blk, bb):
    K, q, w = a_blk.shape
    out = np.zeros((K, q, buf.shape[1]), np.float64)
    for k in range(K):
        out[k] = a_blk[k].astype(np.float64) @ buf[base + bb[k] : base + bb[k] + w]
    return out


def _jax_kernel(buf, base, a_blk, bb):
    K, q, w = a_blk.shape
    w_dma = -(-(w + 7) // 8) * 8
    a_shift = np.zeros((K, q, w_dma), np.float32)
    for k in range(K):
        rem = (base + int(bb[k])) % 8
        a_shift[k, :, rem : rem + w] = a_blk[k]
    if q >= 8:
        out = jax_b2(jnp.asarray(buf), base, jnp.asarray(a_shift), jnp.asarray(bb, jnp.int32),
                     interpret=True)
        return np.asarray(out)
    G = 8 // q
    pad = -(-K // G) * G - K
    a_shift = np.concatenate([a_shift, np.repeat(a_shift[-1:], pad, 0)])
    bb_p = np.concatenate([bb, np.full(pad, bb[-1])])
    Kg = (K + pad) // G
    a_pack = np.zeros((Kg, G * q, G * w_dma), np.float32)
    for g in range(Kg):
        for j in range(G):
            a_pack[g, j * q : (j + 1) * q, j * w_dma : (j + 1) * w_dma] = a_shift[g * G + j]
    out = jax_b3(jnp.asarray(buf), base, jnp.asarray(a_pack), jnp.asarray(bb_p, jnp.int32),
                 G=G, s_sub=w_dma, interpret=True)
    return np.asarray(out).reshape(Kg * G, q, -1)[:K]


@pytest.mark.parametrize("pair", PAIRS, ids=["q64", "q4", "q2", "q1"])
def test_plain_matches_jax_pallas_and_numpy(pair):
    buf, a_blk, bb, bases = _case(*pair, R=4)
    q = a_blk.shape[1]
    wrapper = kern.dma_farrow_contract if q >= 8 else kern.dma_farrow_contract_packed
    before = dict(kern.LAUNCHES)
    for base in bases:
        got = wrapper(torch.from_numpy(buf), base, torch.from_numpy(a_blk), bb).numpy()
        assert got.shape == (a_blk.shape[0], q, buf.shape[1])
        np.testing.assert_allclose(got, _numpy_sum(buf, base, a_blk, bb), atol=ATOL, rtol=0)
        if base == bases[-1]:
            continue  # the TPU kernels' aligned read runs past the exact top bound
        np.testing.assert_allclose(got, _jax_kernel(buf, base, a_blk, bb), atol=ATOL, rtol=0)
    assert kern.LAUNCHES == before  # the CPU path launches nothing


def test_plain_ragged_lanes():
    buf, a_blk, bb, bases = _case(48000, 1601, R=6, seed=3)
    got = kern.dma_farrow_contract_reference(torch.from_numpy(buf), 7, torch.from_numpy(a_blk), bb)
    np.testing.assert_allclose(got.numpy(), _numpy_sum(buf, 7, a_blk, bb), atol=ATOL, rtol=0)


def _args(pair=(44100, 44101)):
    buf, a_blk, bb, bases = _case(*pair, R=4)
    return torch.from_numpy(buf), torch.from_numpy(a_blk), bb, bases[-1]


def test_wrappers_check_bounds():
    for pair, fn in (((44100, 44101), kern.dma_farrow_contract),
                     ((367500, 1601), kern.dma_farrow_contract_packed)):
        buf, a_blk, bb, top = _args(pair)
        fn(buf, top, a_blk, bb)
        for base in (-1, top + 1):
            with pytest.raises(IndexError):
                fn(buf, base, a_blk, bb)
        with pytest.raises(IndexError):  # a block base past the ring
            fn(buf, 0, a_blk, bb + buf.shape[0])


def test_wrappers_check_arguments():
    buf, a_blk, bb, _ = _args()
    b2, b3 = kern.dma_farrow_contract, kern.dma_farrow_contract_packed
    with pytest.raises(TypeError):
        b2(buf, np.int64(1), a_blk, bb)
    with pytest.raises(TypeError):
        b2(buf.double(), 1, a_blk, bb)
    with pytest.raises(TypeError):
        b2(buf, 1, a_blk[0], bb)
    with pytest.raises(ValueError):
        b2(buf.T.contiguous().T, 1, a_blk, bb)
    with pytest.raises(ValueError):  # one base per block
        b2(buf, 1, a_blk, bb[:-1])
    with pytest.raises(ValueError):
        b2(buf, 1, a_blk, bb.astype(np.float64))
    with pytest.raises(ValueError):  # q >= 8 is B2's, q < 8 is B3's
        b3(buf, 1, a_blk, bb)
    with pytest.raises(ValueError):
        b2(buf, 1, a_blk[:, :4].contiguous(), bb)
    with pytest.raises(ValueError):  # B3's group weights must fit shared memory
        b3(torch.zeros((bb.max() + 2001, 4)), 0, torch.zeros((len(bb), 1, 2000)), bb)
    # neither CPU nor CUDA: raises, never runs the plain version
    with pytest.raises(ValueError):
        b2(buf.to("meta"), 1, a_blk.to("meta"), bb)


def _bm_case(C: int, B: int = 3, seed: int = 0):
    """The whole plan of a ``[B, n, C]`` fleet at 44.1 -> 44.101 kHz, 32
    taps (K 64 blocks of q 64; out_cap 4067 < K*q 4096), random weights and
    a ring of ``B*C`` lanes with 9 rows to spare."""
    L, M = reduce_ratio(44100, 44101)
    cfg = tfir.FirConfig(channels=C, taps=32, ratio_num=L, ratio_den=M)
    plan = tfleets._farrow_tm_plan(cfg, np.zeros((tfir.PHASES, 32), np.float32))
    K, q, w, bb = plan["K"], plan["q"], plan["w_blk"], plan["block_base"]
    rng = np.random.default_rng(seed)
    a_blk = torch.from_numpy((rng.standard_normal((K, q, w)) / np.sqrt(w)).astype(np.float32))
    buf = torch.from_numpy(rng.standard_normal((int(bb.max()) + w + 9, B * C), dtype=np.float32))
    return buf, a_blk, bb, cfg.out_capacity


def _aten_epilogue(buf, base, a_blk, bb, out_cap, n_out, B, C):
    """The parent form: the plain contraction, rows past ``n_out`` zeroed,
    relaid to ``[B, out_cap, C]``, and ``max |x|``."""
    tm = kern.dma_farrow_contract_reference(buf, base, a_blk, bb).reshape(-1, B * C)[:out_cap]
    tm[n_out:] = 0.0
    out = tm.reshape(out_cap, B, C).permute(1, 0, 2).contiguous()
    return out, out.abs().amax()


@pytest.mark.parametrize(
    "C,cut,poison",
    [(2, 0, False), (2, 700, False), (1, 33, False), (1, 0, False), (2, 300, True),
     (2, None, False)],
    ids=["stereo-full", "stereo-masked", "mono-masked", "mono-full", "nan", "no-output"],
)
def test_bm_plain_matches_contraction_mask_relayout_amax(C, cut, poison):
    """``dma_farrow_contract_bm``'s plain version (through the wrapper, on
    the CPU) against the plain contraction cut to ``out_cap``, then the
    mask, the relayout and ``abs().amax()``: the same outputs (f32 sums of
    another gather, within 1e-6), zeros past ``n_out`` exactly, the same
    peak; a NaN in a ring row that kept outputs read makes the peak NaN;
    ``n_out`` 0 (``cut`` None) leaves zeros and the peak as it was."""
    B = 3
    buf, a_blk, bb, out_cap = _bm_case(C, B, seed=C)
    K, q, _ = a_blk.shape
    assert out_cap < K * q
    n_out = 0 if cut is None else out_cap - cut
    base = 5
    if poison:
        buf[base + 10, C] = float("nan")  # stream 1, channel 0, a row block 0 reads
    want, want_peak = _aten_epilogue(buf, base, a_blk, bb, out_cap, n_out, B, C)
    out = torch.full((B, out_cap, C), 7.0)
    peak = torch.zeros(())
    before = dict(kern.LAUNCHES)
    got, got_peak = kern.dma_farrow_contract_bm(buf, base, a_blk, bb, out, peak, n_out=n_out)
    assert kern.LAUNCHES == before  # the CPU path launches nothing
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
     ("out_strided", "contiguous"), ("out_device", "out is on"), ("n_out_high", "n_out"),
     ("n_out_negative", "n_out"), ("n_out_bool", "n_out"), ("peak_shape", "peak"),
     ("peak_dtype", "peak"), ("peak_device", "peak is on"), ("q_b3", "q >= 8")],
)
def test_bm_wrapper_refuses_what_the_kernel_does_not_take(what, match):
    """``dma_farrow_contract_bm`` refuses, on any device, what its kernel
    does not take: an output that is not a contiguous f32 ``[B, out_cap <=
    K*q, C]`` with ``B*C`` the ring's lanes, on the ring's device; a peak
    that is not a 0-d f32 there; ``n_out`` outside ``[0, out_cap]``; B3's
    blocks of ``q < 8``."""
    buf, a_blk, bb, out_cap = _bm_case(2)
    K, q, _ = a_blk.shape
    out, peak, n_out = torch.zeros((3, out_cap, 2)), torch.zeros(()), out_cap
    if what == "out_shape":
        out = torch.zeros((2, out_cap, 2))
    elif what == "out_cap":
        out = torch.zeros((3, K * q + 1, 2))
    elif what == "out_dtype":
        out = out.double()
    elif what == "out_strided":
        out = torch.zeros((3, 2, out_cap)).transpose(1, 2)
    elif what == "out_device":
        out = out.to("meta")
    elif what == "n_out_high":
        n_out = out_cap + 1
    elif what == "n_out_negative":
        n_out = -1
    elif what == "n_out_bool":
        n_out = True
    elif what == "peak_shape":
        peak = torch.zeros((1,))
    elif what == "peak_dtype":
        peak = peak.double()
    elif what == "peak_device":
        peak = peak.to("meta")
    else:
        a_blk = a_blk[:, :4].contiguous()
    with pytest.raises((TypeError, ValueError), match=match):
        kern.dma_farrow_contract_bm(buf, 0, a_blk, bb, out, peak, n_out=n_out)
