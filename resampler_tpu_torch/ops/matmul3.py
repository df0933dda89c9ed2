"""Kernel B7 and the bf16 hi/lo split of ``resampler_tpu/ops/matmul3.py``.

``split_hi_lo`` (``matmul3.py:39``) is the operand split of the FFT
engine's magsplit kernels (B4, B5), of B7 and of B6b.  Both forms here
round with integer operations on the float32 bit pattern,
round to nearest even, exactly as a float32 -> bfloat16 conversion does
(``ml_dtypes`` and XLA): ``(u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000``,
with a NaN becoming ``sign | 0x7FC00000``.  PyTorch's own CPU conversion
gives NaNs another bit pattern, so neither form uses it.

- ``bf16_round_np``: NumPy, for the host-side weight design;
- ``split_hi_lo``: PyTorch, bit for bit JAX's split, as float32 tensors
  whose values are exact bfloat16 (the CUDA kernels split in registers
  by the same rule, ``csrc/bf16_split.cuh``);
- ``split_weight``: a weight's two halves as bfloat16 tensors, B7's ``t``.

B7, ``matmul3`` (``matmul3.py:78``), is the split-precision product
``x [.., M, K] f32 @ (t_hi + t_lo) [K, N] bf16 -> [.., M, N] f32``: the
products ``hi(x) t_hi + lo(x) t_hi + hi(x) t_lo`` (``passes=3``, JAX's
``Precision.HIGH`` on a device with bf16 passes: the FFT engine's matmul
and conv backends) and ``+ lo(x) t_lo`` (``passes=4``, the FIR fleet's
``precision="bf16x4"``), every product exact, summed in f32.  For CUDA
tensors the wrapper launches the hand-written kernels of
``csrc/matmul3.cu``, counted once per call in ``LAUNCHES["matmul3"]``: a
split pass that writes ``hi(x)`` and ``lo(x)`` as compact K-major bf16
scratch, then a TMA-fed, warp-specialised ``wgmma`` GEMM over it.  CPU
tensors run ``matmul3_reference``; there is no fallback between the two.
``x`` and ``out`` may be any strided views (an overlapping ring window, a
time-major output), and M, N and K need not be tile multiples (the TPU
kernel's Mosaic rule).  The layout the GEMM's tensor maps need (``Kp``,
the scratch, the maps' extents, strides and coordinates, a weight copy
where its rows are not 16-byte multiples) is planned here in Python,
``plan_matmul3``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ._build import LAUNCHES, device_kind, launch

__all__ = [
    "bf16_round_np", "bf16_bits_np", "split_hi_lo", "split_weight", "matmul3", "matmul3_reference",
    "Matmul3Plan", "plan_matmul3", "tile_coords", "split_pass_reference",
]

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


def split_weight(t) -> tuple[torch.Tensor, torch.Tensor]:
    """``split_hi_lo`` of a weight as two bfloat16 tensors (exact: both
    halves are bfloat16 values), B7's ``t_hi`` and ``t_lo``."""
    hi, lo = split_hi_lo(torch.as_tensor(t))
    return hi.to(torch.bfloat16), lo.to(torch.bfloat16)


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_I32_MAX = (1 << 31) - 1
#: csrc/matmul3.cu's tiles: the split pass's 32 rows; the GEMM's 128 rows,
#: 160 columns, 64 of K per stage and weight boxes of 32 columns
_SPLIT_ROWS, _BM, _BN, _BK, _BOX_N = 32, 128, 160, 64, 32
#: the GEMM's accumulation form (kPromote in csrc/matmul3.cu): 0 chains one
#: tensor-core accumulator over the whole K, 1 sums each 64-deep K tile in a
#: fresh accumulator and adds it to f32 sums in registers.  The chained form
#: missed the 1e-5 tolerance at the FFT projector on an H100 (2.29e-5 at K
#: 1176; promoted 4.77e-6): the tensor cores' accumulation truncates
_PROMOTE = 1


def _no_overlap(t: torch.Tensor) -> bool:
    """No two elements of ``t`` share memory (strides sorted ascending each
    step past the extent of the ones before)."""
    need = 1
    for stride, size in sorted((s, n) for s, n in zip(t.stride(), t.shape) if n > 1):
        if stride < need:
            return False
        need = stride * size
    return True


def _check(x, t_hi, t_lo, passes: int, out):
    """``(x3, out3)``: ``x`` and ``out`` as 3-D views ``[batch, M, K]``,
    ``[batch, M, N]`` (``out3`` None when not given)."""
    if passes not in (3, 4):
        raise ValueError(f"passes must be 3 or 4, got {passes}")
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 or x.ndim not in (2, 3):
        raise TypeError("x must be a 2-D or 3-D float32 tensor")
    for what, t in (("t_hi", t_hi), ("t_lo", t_lo)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.bfloat16 or t.ndim != 2:
            raise TypeError(f"{what} must be a 2-D bfloat16 tensor")
        if t.device != x.device:
            raise ValueError(f"{what} is on {t.device}, x on {x.device}")
    K, N = t_hi.shape
    if tuple(t_lo.shape) != (K, N) or t_lo.stride() != t_hi.stride():
        raise ValueError("t_hi and t_lo must have one shape and one layout")
    if N > 1 and t_hi.stride(1) != 1:
        raise ValueError("the weight's columns must be contiguous")
    x3 = x if x.ndim == 3 else x.unsqueeze(0)
    batch, M, Kx = x3.shape
    if Kx != K:
        raise ValueError(f"x has K = {Kx}, the weight {K}")
    if min(batch, M, N, K) < 1 or max(M, N, K) > _I32_MAX or batch > 65535 or -(-M // _SPLIT_ROWS) > 65535:
        raise ValueError(f"shape {tuple(x3.shape)} @ {(K, N)} outside the kernel's grid")
    if out is None:
        return x3, None
    if not isinstance(out, torch.Tensor) or out.dtype != torch.float32 or out.device != x.device:
        raise TypeError(f"out must be a float32 tensor on {x.device}")
    if out.ndim != x.ndim or tuple(out.shape) != tuple(x.shape[:-1]) + (N,):
        raise ValueError(f"out must be {list(x.shape[:-1]) + [N]}, got {list(out.shape)}")
    if not _no_overlap(out):
        raise ValueError("out's elements must not overlap")
    return x3, out if out.ndim == 3 else out.unsqueeze(0)


def matmul3_reference(x, t_hi, t_lo, *, passes: int = 3, out=None) -> torch.Tensor:
    """Plain PyTorch version of B7: the exact bf16 products, summed in
    float64 and rounded once to float32 (an f32 sum of the same products
    is no 1e-5 yardstick at K >= 1176).  ``out`` (optional) receives the
    result, which is returned."""
    x3, out3 = _check(x, t_hi, t_lo, passes, out)
    hi, lo = (h.double() for h in split_hi_lo(x3))
    th, tl = t_hi.double(), t_lo.double()
    acc = hi @ th + lo @ th + hi @ tl
    if passes == 4:
        acc += lo @ tl
    res = acc.to(torch.float32)
    if out3 is None:
        return res if x.ndim == 3 else res[0]
    out3.copy_(res)
    return out


@dataclasses.dataclass(frozen=True)
class Matmul3Plan:
    """B7's layout on the card (``csrc/matmul3.cu``): the split pass's
    scratch and the four TMA maps of the GEMM, extents and strides
    innermost first, strides in bytes."""

    batch: int
    M: int
    N: int
    K: int
    #: K rounded up to 8: the scratch rows are 16-byte multiples, zero past K
    Kp: int
    #: the x_hi / x_lo maps over the scratch ``[batch, M, Kp]``
    a_dims: tuple
    a_strides: tuple
    a_box: tuple
    #: the weight is copied to ``[K, ldt]`` scratch: its row stride is no
    #: multiple of 8 elements, or a half's base is not 16-byte aligned (a
    #: TMA box's innermost coordinate must sit on 16 bytes, so a base cannot
    #: be aligned down and the remainder added to the column coordinate)
    weight_copy: bool
    #: the mapped weight's row stride, in elements
    ldt: int
    b_dims: tuple
    b_strides: tuple
    b_box: tuple
    #: the GEMM's blocks: column tiles, row tiles, batch
    grid: tuple

    @property
    def scratch_shape(self) -> tuple:
        return (self.batch, self.M, self.Kp)


def plan_matmul3(x3: torch.Tensor, t_hi: torch.Tensor, t_lo: torch.Tensor) -> Matmul3Plan:
    """The card's layout for ``x3 [batch, M, K] @ t [K, N]`` (shapes and
    the weight's strides and addresses; any device)."""
    batch, M, K = x3.shape
    N = t_hi.shape[1]
    Kp = -(-K // 8) * 8
    ldt = t_hi.stride(0)
    weight_copy = ldt % 8 != 0 or any(t.data_ptr() % 16 for t in (t_hi, t_lo))
    if weight_copy:
        ldt = -(-N // 8) * 8
    return Matmul3Plan(
        batch=batch, M=M, N=N, K=K, Kp=Kp,
        a_dims=(Kp, M, batch), a_strides=(2 * Kp, 2 * Kp * M), a_box=(_BK, _BM, 1),
        weight_copy=weight_copy, ldt=ldt, b_dims=(N, K), b_strides=(2 * ldt,), b_box=(_BOX_N, _BK),
        grid=(-(-N // _BN), -(-M // _BM), batch),
    )


def tile_coords(plan: Matmul3Plan, b: int, m_tile: int, n_tile: int, k_tile: int) -> dict:
    """The TMA coordinates (innermost first) that the GEMM's block
    ``(n_tile, m_tile, b)`` loads at K tile ``k_tile``: ``"a"`` for x_hi
    and x_lo, ``"b"`` the weight's 32-column boxes of t_hi and t_lo."""
    k = k_tile * _BK
    return {
        "a": (k, m_tile * _BM, b),
        "b": [(n_tile * _BN + j * _BOX_N, k) for j in range(_BN // _BOX_N)],
    }


def split_pass_reference(x3: torch.Tensor, Kp: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B7's split pass: ``split_hi_lo(x3)`` as compact
    bfloat16 ``[batch, M, Kp]``, zero past K."""
    pad = Kp - x3.shape[-1]
    return tuple(torch.nn.functional.pad(h, (0, pad)).to(torch.bfloat16) for h in split_hi_lo(x3))


@dataclasses.dataclass
class _Call:
    """One card call of B7, planned and allocated: ``_split`` then
    ``_gemm`` run it (``matmul3`` does both)."""

    plan: Matmul3Plan
    x3: torch.Tensor
    out: torch.Tensor
    out3: torch.Tensor
    t_hi: torch.Tensor
    t_lo: torch.Tensor
    x_hi: torch.Tensor
    x_lo: torch.Tensor


def _prepare(x, t_hi, t_lo, passes, out) -> _Call:
    x3, out3 = _check(x, t_hi, t_lo, passes, out)
    plan = plan_matmul3(x3, t_hi, t_lo)
    if out3 is None:
        out = torch.empty(tuple(x.shape[:-1]) + (plan.N,), dtype=torch.float32, device=x.device)
        out3 = out if out.ndim == 3 else out.unsqueeze(0)
    if plan.weight_copy:
        t_hi, t_lo = (t.new_empty((plan.K, plan.ldt))[:, : plan.N].copy_(t) for t in (t_hi, t_lo))
    x_hi, x_lo = (torch.empty(plan.scratch_shape, dtype=torch.bfloat16, device=x.device) for _ in range(2))
    return _Call(plan, x3, out, out3, t_hi, t_lo, x_hi, x_lo)


def _split(c: _Call) -> None:
    """The split pass: ``c.x_hi``, ``c.x_lo`` from ``c.x3``."""
    p = c.plan
    launch(
        "matmul3_split", c.x3.device,
        _P(c.x3.data_ptr()), _P(c.x_hi.data_ptr()), _P(c.x_lo.data_ptr()),
        _I(p.batch), _I(p.M), _I(p.K), _I(p.Kp), *(_I64(s) for s in c.x3.stride()),
    )


def _gemm(c: _Call, passes: int, promote: int = _PROMOTE) -> None:
    """The GEMM over the split pass's scratch into ``c.out3``."""
    p = c.plan
    launch(
        "matmul3_gemm", c.x3.device,
        _P(c.x_hi.data_ptr()), _P(c.x_lo.data_ptr()),
        _P(c.t_hi.data_ptr()), _P(c.t_lo.data_ptr()), _P(c.out3.data_ptr()),
        _I(p.batch), _I(p.M), _I(p.N), _I(p.K), _I(p.Kp), _I64(p.ldt),
        *(_I64(s) for s in c.out3.stride()), _I(passes), _I(promote),
    )


def matmul3(x, t_hi, t_lo, *, passes: int = 3, out=None) -> torch.Tensor:
    """B7: ``x [batch, M, K]`` (or ``[M, K]``) float32, any strides, times
    the pre-split weight ``t_hi + t_lo [K, N]`` (bfloat16, contiguous
    columns) in ``passes`` (3 or 4) bf16 passes with f32 sums.  Writes
    ``out`` (any non-overlapping strided view of the result's shape) when
    given, else a new contiguous tensor; returns it.  CUDA tensors launch
    the split pass and the GEMM on the current stream; CPU tensors run the
    plain version.  Anything else raises."""
    if isinstance(x, torch.Tensor) and device_kind(x) == "cpu":
        return matmul3_reference(x, t_hi, t_lo, passes=passes, out=out)
    c = _prepare(x, t_hi, t_lo, passes, out)
    _split(c)
    _gemm(c, passes)
    LAUNCHES["matmul3"] += 1
    return c.out
