"""Kernels B1-B3: the contractions of the time-major sync FIR fleet.

Ports of ``resampler_tpu/ops/fir_dma_kernel.py``:

- B1 ``dma_banded_contract`` (``:277``), the periodic path::

      out[k, j, r] = sum_{s < span} a[j, s] * buffer[base + k*L + s, r],  k < K

  ``a [M, span]``; returns ``[K, M, R]``.
- B2 ``dma_farrow_contract`` (``:225``), the farrow / lerp / wide path
  for Farrow blocks of ``q >= 8`` outputs, and B3
  ``dma_farrow_contract_packed`` (``:170``), the same sum for ``q < 8``
  (heavy coprime downsampling)::

      out[k, l, r] = sum_{s < w} a_blk[k, l, s] * buffer[base + block_base[k] + s, r]

  ``a_blk [K, q, w]``, ``block_base [K]`` host ints (the plan's static
  table); returns ``[K, q, R]``.

``buffer [ring, R]`` f32, ``base`` a Python int.  The TPU kernels' Mosaic
workarounds do not carry over: no 8-row aligned DMA, so neither B1's
remainder-shifted atlas nor B2/B3's pre-shifted weights (the wrappers take
``a_blk`` unshifted and read ``base + block_base[k]`` exactly); no
block-diagonal packing or group padding of K for B3; no ``R % 128`` lane
gate (the CUDA kernels mask a ragged lane edge).

Each wrapper launches its hand-written CUDA kernel (``csrc/``) for CUDA
tensors, counting the launch in ``LAUNCHES``, and runs its ``*_reference``
plain PyTorch version only for CPU tensors; there is no fallback between
the two.  ``ops/_build.py`` compiles the kernels with ``nvcc`` for
``sm_90a`` on first use and binds them with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import LAUNCHES, device_kind as _device_kind, launch as _launch

__all__ = [
    "dma_banded_contract",
    "dma_banded_contract_reference",
    "dma_farrow_contract",
    "dma_farrow_contract_packed",
    "dma_farrow_contract_reference",
]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: B3 keeps a thread block's weights in shared memory: the 48 KB default
#: less its 4 KB reduction buffer
_PACKED_SMEM_MAX = 44 * 1024
#: per-device copies of B2/B3's ``block_base`` tables, uploaded once
_block_base_cache: dict[tuple, torch.Tensor] = {}


def _check_tensors(buffer, name: str, weights, nd: int) -> None:
    for what, t, n in (("buffer", buffer, 2), (name, weights, nd)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.ndim != n:
            raise TypeError(f"{what} must be a {n}-D float32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    if weights.device != buffer.device:
        raise ValueError(f"{name} is on {weights.device}, buffer on {buffer.device}")
    ring, R = buffer.shape
    if R < 1:
        raise ValueError("buffer has no lanes")
    if max(ring, R) >= 1 << 31:
        raise ValueError("the kernels take 32-bit row and lane counts")


def _check_rows(base, lo: int, hi: int, ring: int) -> None:
    """Rows ``[base + lo, base + hi)`` must lie inside the ring."""
    if not isinstance(base, int) or isinstance(base, bool):
        raise TypeError(f"base must be a Python int, got {type(base).__name__}")
    if base + lo < 0 or base + hi > ring:
        raise IndexError(
            f"rows [{base + lo}, {base + hi}) fall outside the ring of {ring} rows"
        )


# --------------------------------------------------------------------------
# B1: banded contraction (periodic path)
# --------------------------------------------------------------------------


def _check_banded(buffer, base, a, L, M, span, K) -> None:
    _check_tensors(buffer, "a", a, 2)
    if min(L, M, span, K) < 1:
        raise ValueError(f"L, M, span, K must be >= 1: {(L, M, span, K)}")
    if tuple(a.shape) != (M, span):
        raise ValueError(f"a must be [{M}, {span}], got {tuple(a.shape)}")
    if M * K >= 1 << 31:
        raise ValueError("the kernel takes 32-bit block counts")
    _check_rows(base, 0, (K - 1) * L + span, buffer.shape[0])


def dma_banded_contract_reference(buffer, base: int, a, *, L: int, M: int, span: int, K: int):
    """Plain PyTorch version of B1: a stride-``L`` window view of
    ``buffer[base : base + (K-1)*L + span]`` contracted with ``a`` in
    f32.  ``[K, M, R]``."""
    _check_banded(buffer, base, a, L, M, span, K)
    windows = buffer[base : base + (K - 1) * L + span].unfold(0, span, L)  # [K, R, span]
    return torch.einsum("js,krs->kjr", a, windows)


def dma_banded_contract(buffer, base: int, a, *, L: int, M: int, span: int, K: int):
    """``out[k, j, r] = sum_s a[j, s] * buffer[base + k*L + s, r]``,
    ``[K, M, R]`` f32.  CUDA tensors launch kernel B1 on the current
    stream; CPU tensors run the plain version.  Anything else raises."""
    _check_banded(buffer, base, a, L, M, span, K)
    if _device_kind(buffer) == "cpu":
        return dma_banded_contract_reference(buffer, base, a, L=L, M=M, span=span, K=K)
    R = buffer.shape[1]
    out = torch.empty((K, M, R), dtype=torch.float32, device=buffer.device)
    _launch(
        "fir_banded_contract", buffer.device,
        _P(buffer.data_ptr()), _P(a.data_ptr()), _P(out.data_ptr()),
        _I(R), _I(base), _I(L), _I(M), _I(span), _I(K),
    )
    LAUNCHES["dma_banded_contract"] += 1
    return out


# --------------------------------------------------------------------------
# B2 / B3: blocked Farrow contraction
# --------------------------------------------------------------------------


def _check_farrow(buffer, base, a_blk, block_base) -> np.ndarray:
    _check_tensors(buffer, "a_blk", a_blk, 3)
    K, q, w = a_blk.shape
    if min(K, q, w) < 1:
        raise ValueError(f"a_blk must be non-empty, got {tuple(a_blk.shape)}")
    bb = np.asarray(block_base)
    if bb.dtype.kind not in "iu" or bb.shape != (K,):
        raise ValueError(f"block_base must be {K} host ints, got {bb.dtype} {bb.shape}")
    bb = bb.astype(np.int64)
    if K >= 1 << 31 or K * q >= 1 << 31:
        raise ValueError("the kernels take 32-bit block counts")
    _check_rows(base, int(bb.min()), int(bb.max()) + w, buffer.shape[0])
    return bb


def dma_farrow_contract_reference(buffer, base: int, a_blk, block_base):
    """Plain PyTorch version of B2 and B3: each block's ``w`` ring rows
    taken at ``base + block_base[k]`` and contracted with its weights in
    f32 (the JAX fleet's XLA form).  ``[K, q, R]``."""
    bb = _check_farrow(buffer, base, a_blk, block_base)
    w = a_blk.shape[2]
    rows = torch.from_numpy(base + bb[:, None] + np.arange(w)).to(buffer.device)
    return torch.einsum("kqw,kwr->kqr", a_blk, buffer[rows])


def _farrow_launch(name: str, fn_name: str, buffer, base: int, a_blk, bb: np.ndarray, *extra):
    K, q, w = a_blk.shape
    R = buffer.shape[1]
    key = (buffer.device, bb.tobytes())
    bb_dev = _block_base_cache.get(key)
    if bb_dev is None:
        bb_dev = _block_base_cache[key] = torch.from_numpy(bb).to(buffer.device)
    out = torch.empty((K, q, R), dtype=torch.float32, device=buffer.device)
    _launch(
        fn_name, buffer.device,
        _P(buffer.data_ptr()), _P(a_blk.data_ptr()), _P(bb_dev.data_ptr()),
        _P(out.data_ptr()), _I(R), _I64(base), _I(K), _I(q), _I(w), *extra,
    )
    LAUNCHES[name] += 1
    return out


def dma_farrow_contract(buffer, base: int, a_blk, block_base):
    """``out[k, l, r] = sum_s a_blk[k, l, s] * buffer[base + block_base[k]
    + s, r]``, ``[K, q, R]`` f32, for Farrow blocks of ``q >= 8`` rows.
    CUDA tensors launch kernel B2; CPU tensors run the plain version."""
    bb = _check_farrow(buffer, base, a_blk, block_base)
    if a_blk.shape[1] < 8:
        raise ValueError(f"B2 takes blocks of q >= 8 rows (q < 8: B3), got q={a_blk.shape[1]}")
    if _device_kind(buffer) == "cpu":
        return dma_farrow_contract_reference(buffer, base, a_blk, bb)
    return _farrow_launch("dma_farrow_contract", "fir_farrow_contract", buffer, base, a_blk, bb)


def dma_farrow_contract_packed(buffer, base: int, a_blk, block_base):
    """B2's sum for Farrow blocks of ``q < 8`` rows (heavy coprime
    downsampling), ``[K, q, R]`` f32.  CUDA tensors launch kernel B3,
    which groups ``ceil(8/q)`` blocks per thread block; CPU tensors run
    the plain version."""
    bb = _check_farrow(buffer, base, a_blk, block_base)
    K, q, w = a_blk.shape
    if q >= 8:
        raise ValueError(f"B3 takes blocks of q < 8 rows (q >= 8: B2), got q={q}")
    if -(-8 // q) * q * w * 4 > _PACKED_SMEM_MAX:  # the group's weights
        raise ValueError(f"B3's group weights ({-(-8 // q) * q} x {w}) exceed shared memory")
    if _device_kind(buffer) == "cpu":
        return dma_farrow_contract_reference(buffer, base, a_blk, bb)
    # 16-byte lane loads need a lane count and row pitch that keep them aligned
    vec = 4 if buffer.shape[1] % 4 == 0 and buffer.data_ptr() % 16 == 0 else 1
    return _farrow_launch(
        "dma_farrow_contract_packed", "fir_farrow_contract_packed",
        buffer, base, a_blk, bb, _I(vec),
    )
