"""Kernels B2 and B3 (blocked Farrow contraction): the port's plain version
against the JAX package's Pallas kernels (interpret mode) and a direct
numpy sum, and the wrappers' argument and bounds checks.  The CUDA kernels
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
