"""The bf16 hi/lo split of ``resampler_tpu/ops/matmul3.py``.

``split_hi_lo`` (``matmul3.py:39``) is the operand split of the FFT
engine's magsplit kernels (B4, B5) and, later, of B7's bf16x3 GEMM.  Both
forms here round with integer operations on the float32 bit pattern,
round to nearest even, exactly as a float32 -> bfloat16 conversion does
(``ml_dtypes`` and XLA): ``(u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000``,
with a NaN becoming ``sign | 0x7FC00000``.  PyTorch's own CPU conversion
gives NaNs another bit pattern, so neither form uses it.

- ``bf16_round_np``: NumPy, for the host-side weight design;
- ``split_hi_lo``: PyTorch, bit for bit JAX's split, as float32 tensors
  whose values are exact bfloat16 (the CUDA kernels split in registers
  by the same rule).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bf16_round_np", "bf16_bits_np", "split_hi_lo"]

_MASK32 = 0xFFFFFFFF
#: the smallest normal float32
_F32_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def _round_bits(u, where):
    """Round float32 bit patterns ``u`` (non-negative int64 values) to
    bfloat16 bit patterns in the upper 16 bits, nearest even; NaNs become
    the quiet NaN of their sign."""
    r = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    return where(nan, (u & 0x80000000) | 0x7FC00000, r)


def bf16_bits_np(a) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (``uint16``), round to nearest
    even, as ``a.astype(ml_dtypes.bfloat16)``."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.int64)
    return (_round_bits(u, np.where) >> 16).astype(np.uint16)


def bf16_round_np(a) -> np.ndarray:
    """``a`` rounded to bfloat16 and back to float32:
    ``a.astype(np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)``."""
    return (bf16_bits_np(a).astype(np.uint32) << 16).view(np.float32)


def _round_tensor(a: torch.Tensor) -> torch.Tensor:
    u = a.contiguous().view(torch.int32).to(torch.int64) & _MASK32
    r = _round_bits(u, torch.where)
    r = torch.where(r > 0x7FFFFFFF, r - (1 << 32), r)  # back to int32 range
    return r.to(torch.int32).view(torch.float32)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormals to zero of the same sign."""
    return torch.where(x.abs() < _F32_MIN_NORMAL, x * 0.0, x)


def split_hi_lo(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-term bf16 decomposition ``a ~= hi + lo``, ``hi = bf16(a)``,
    ``lo = bf16(a - hi)``, as float32 tensors of bfloat16 values, bit for
    bit ``resampler_tpu.ops.matmul3.split_hi_lo`` widened to float32.

    Non-finite values pass through: ``hi`` is ``a``'s bfloat16 (Inf, or
    the quiet NaN of its sign) and ``lo = a - a`` is NaN, so glitched
    input comes out visibly non-finite.  A finite value near the float32
    maximum rounds ``hi`` to Inf, as the conversion does.  The subtraction
    ``a - hi`` treats subnormal operands and results as zero of the same
    sign, as XLA's does (on the CPU it runs with flush-to-zero; the TPU has
    no subnormals).  (The integer rounding is int64 arithmetic on the
    float32 bits: PyTorch's uint32 has few bitwise operations on the CPU.)"""
    a = a.to(torch.float32)
    hi = _round_tensor(a)
    lo = _round_tensor(_flush(_flush(a) - _flush(hi)))
    return hi, lo
