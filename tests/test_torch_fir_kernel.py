"""Kernel B1 (banded contraction): the port's plain version against the
JAX package's Pallas kernel (interpret mode) and its XLA einsum form, and
the wrapper's argument checks.  The CUDA kernel itself is held against
the plain version in tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from resampler_tpu.ops.fir_dma_kernel import dma_banded_contract as jax_dma
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine.fir_fleets import _sync_atlas
from resampler_tpu_torch.ops import _build
from resampler_tpu_torch.ops import fir_dma_kernel as kern
from resampler_tpu_torch.types import Attenuation, reduce_ratio

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

# (in_hz, out_hz, taps, lanes R): the headline pair, the grouped small-M
# pair (g 64: Lg 64, Mg 128) and a ragged fleet of R = 6 lanes
SHAPES = [(44100, 48000, 64, 4), (48000, 96000, 16, 4), (44100, 48000, 16, 6)]
# f32 accumulation order differs between the three forms; the JAX suite's
# own dma-vs-xla tolerance (tests/test_pallas.py)
ATOL = 1e-5


def _case(in_hz, out_hz, taps, R, seed=0):
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=1, taps=taps, ratio_num=L, ratio_den=M)
    g = tfir._periodic_group_factor(L, M)
    Lg, Mg = L * g, M * g
    span = Lg + taps + 1
    K = min(-(-cfg.out_capacity // Mg), 3)
    cut = tfir.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz)
    coeffs = tfir.fir_coefficients(taps, Attenuation.Db90, cut)
    a2 = _sync_atlas(dataclasses.replace(cfg, ratio_num=Lg, ratio_den=Mg), coeffs)
    rng = np.random.default_rng(seed)
    i0 = int(rng.integers(0, M))
    c0 = (i0 * L) // M
    a = np.ascontiguousarray(a2[i0 : i0 + Mg, c0 : c0 + span])
    rows = (K - 1) * Lg + span
    ring = rows + 29
    buf = rng.standard_normal((ring, R)).astype(np.float32)
    bases = [1, 3, 13, ring - rows]  # base % 8 != 0, and the top bound
    return buf, a, bases, dict(L=Lg, M=Mg, span=span, K=K)


def _xla_form(buf, base, a, L, M, span, K):
    """The JAX fleet's XLA contraction (region -> n_blk shifted block
    views -> one einsum at HIGHEST), on an exactly sized region."""
    n_blk = 1 + -(-(span - L) // L)
    s_len = n_blk * L
    region = jnp.pad(
        jnp.asarray(buf[base : base + (K - 1) * L + span]),
        ((0, (K + n_blk) * L - ((K - 1) * L + span)), (0, 0)),
    )
    blocks = region.reshape(K + n_blk, L, buf.shape[1])
    segs = jnp.concatenate([blocks[b : b + K] for b in range(n_blk)], axis=1)
    a_pad = jnp.pad(jnp.asarray(a), ((0, 0), (0, s_len - span)))
    return np.asarray(
        jnp.einsum("js,ksr->kjr", a_pad, segs, precision=jax.lax.Precision.HIGHEST)
    )


@pytest.mark.parametrize("shape", SHAPES, ids=["44k1-48k", "48k-96k-grouped", "ragged-R6"])
def test_plain_matches_jax_pallas_and_xla(shape):
    buf, a, bases, geo = _case(*shape)
    before = dict(kern.LAUNCHES)
    for base in bases:
        got = kern.dma_banded_contract(
            torch.from_numpy(buf), base, torch.from_numpy(a), **geo
        ).numpy()
        assert got.shape == (geo["K"], geo["M"], buf.shape[1])
        np.testing.assert_allclose(got, _xla_form(buf, base, a, **geo), atol=ATOL, rtol=0)
        if base == bases[-1]:
            # the Pallas kernel's 8-row aligned DMA fetches ceil8(span)+8
            # rows, past the ring's end at the exact top bound (the JAX
            # fleet's read slack keeps it clear there)
            continue
        pallas = np.asarray(
            jax_dma(jnp.asarray(buf), base, jnp.asarray(a), interpret=True, **geo)
        )
        np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    assert kern.LAUNCHES == before  # the CPU path launches nothing


def _args():
    buf, a, bases, geo = _case(44100, 48000, 16, 4)
    return torch.from_numpy(buf), torch.from_numpy(a), geo


def test_wrapper_checks_bounds():
    buf, a, geo = _args()
    top = buf.shape[0] - ((geo["K"] - 1) * geo["L"] + geo["span"])
    kern.dma_banded_contract(buf, top, a, **geo)
    for base in (-1, top + 1):
        with pytest.raises(IndexError):
            kern.dma_banded_contract(buf, base, a, **geo)


def test_wrapper_checks_arguments():
    buf, a, geo = _args()
    with pytest.raises(TypeError):
        kern.dma_banded_contract(buf, np.int32(1), a, **geo)
    with pytest.raises(TypeError):
        kern.dma_banded_contract(buf.double(), 1, a, **geo)
    with pytest.raises(ValueError):
        kern.dma_banded_contract(buf.T.contiguous().T, 1, a, **geo)
    with pytest.raises(ValueError):
        kern.dma_banded_contract(buf, 1, a[:, :-1].contiguous(), **geo)
    # neither CPU nor CUDA: raises, never runs the plain version
    with pytest.raises(ValueError):
        kern.dma_banded_contract(buf.to("meta"), 1, a.to("meta"), **geo)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()

