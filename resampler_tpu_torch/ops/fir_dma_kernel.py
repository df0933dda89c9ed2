"""Kernels B1-B3: the contractions of the time-major sync FIR fleet.

Ports of ``resampler_tpu/ops/fir_dma_kernel.py``:

- B1 ``dma_banded_contract`` (``:277``), the periodic path::

      out[k, j, r] = sum_{s < span} a[j, s] * buffer[base + k*L + s, r],  k < K

  ``a [M, span]`` at any strides; returns ``[K, M, R]``.  The fleet's
  atlas window is zero outside each row's taps: ``BandPlan`` gives the
  kernel the columns each tile of rows needs, per start phase.
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
import math

import numpy as np
import torch

from ._build import LAUNCHES, SMEM_MAX, device_kind as _device_kind, launch as _launch

__all__ = [
    "BandPlan",
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
#: B1's tile (``csrc/fir_banded_contract.cu``): lanes per block, band
#: columns per pipeline slice, slices in flight
BAND_LANES, BAND_DEPTH, BAND_STAGES = 256, 16, 3


def _check_tensors(buffer, name: str, weights, nd: int, weights_contiguous=True) -> None:
    for what, t, n, contiguous in (("buffer", buffer, 2, True), (name, weights, nd, weights_contiguous)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.ndim != n:
            raise TypeError(f"{what} must be a {n}-D float32 tensor")
        if contiguous and not t.is_contiguous():
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


class BandPlan:
    """B1's band plan for one periodic atlas: ``L, M`` the atlas's ratio
    (grouped: ``gL, gM``), ``taps``, ``span = L + taps + 1``.

    Row ``j`` of the fleet's atlas window at start phase ``i0`` (rows ``i0
    .. i0 + M``, columns from ``off(i0)``) is zero outside the columns
    ``[off(i0 + j) - off(i0), + taps)``, ``off(ii) = ii*L//M`` (equal in
    the reduced ratio, so a grouped atlas has the reduced one's rows).  The
    kernel takes ``rows`` consecutive rows per tile; ``tiles[i0, t] = (lo,
    hi)`` are the columns tile ``t`` needs at start phase ``i0`` in ``[0,
    period)`` (the reduced ``M``):

    - ``lo = off(i0 + t*rows) - off(i0)``;
    - ``hi = min(span, off(i0 + last row of t) - off(i0) + taps)``.

    ``rows`` is 32, or 16 where a 32-row tile would spread more than
    ``taps`` columns (heavy periodic downsampling).  ``smem_bytes`` is a
    block's dynamic shared memory: ``BAND_STAGES`` slices of
    ``BAND_DEPTH`` columns, each the tile's weights and ``BAND_LANES``
    ring lanes."""

    def __init__(self, L: int, M: int, taps: int):
        if min(L, M, taps) < 1:
            raise ValueError(f"L, M, taps must be >= 1: {(L, M, taps)}")
        self.L, self.M, self.taps = L, M, taps
        self.span = L + taps + 1
        self.period = M // math.gcd(L, M)
        self.rows = 16 if 31 * L > taps * M else 32
        self.n_tiles = -(-M // self.rows)
        i0 = np.arange(self.period, dtype=np.int64)[:, None]
        t = np.arange(self.n_tiles, dtype=np.int64)
        first = i0 + t * self.rows
        last = i0 + np.minimum((t + 1) * self.rows, M) - 1
        off0 = i0 * L // M
        lo = first * L // M - off0
        hi = np.minimum(self.span, last * L // M - off0 + taps)
        self.tiles = np.stack([lo, hi], -1).astype(np.int32)  # [period, n_tiles, 2]
        self.smem_bytes = 4 * BAND_STAGES * BAND_DEPTH * (self.rows + BAND_LANES)
        if self.smem_bytes > SMEM_MAX:
            raise ValueError(f"B1's tile needs {self.smem_bytes} B of shared memory")
        self._dev: dict = {}

    def issued(self, i0: int) -> int:
        """Multiply-adds per lane and period block at start phase ``i0``:
        each tile's rows times its band's columns (rows past ``M`` are
        masked, not issued)."""
        rows = np.minimum(self.rows, self.M - self.rows * np.arange(self.n_tiles))
        lo, hi = self.tiles[i0, :, 0], self.tiles[i0, :, 1]
        return int((rows * (hi - lo)).sum())

    def check(self, L: int, M: int, span: int, i0) -> None:
        if (self.L, self.M, self.span) != (L, M, span):
            raise ValueError(
                f"band plan is for L, M, span {(self.L, self.M, self.span)}, not {(L, M, span)}"
            )
        if not isinstance(i0, int) or isinstance(i0, bool) or not 0 <= i0 < self.period:
            raise ValueError(f"i0 must be an int in [0, {self.period}), got {i0!r}")

    def table(self, device: torch.device) -> torch.Tensor:
        """``tiles`` (int32) on ``device``, uploaded once."""
        tab = self._dev.get(device)
        if tab is None:
            tab = self._dev[device] = torch.from_numpy(self.tiles).to(device)
        return tab


def _check_banded(buffer, base, a, L, M, span, K) -> None:
    _check_tensors(buffer, "a", a, 2, weights_contiguous=False)
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
    f32 over the full span.  ``[K, M, R]``."""
    _check_banded(buffer, base, a, L, M, span, K)
    windows = buffer[base : base + (K - 1) * L + span].unfold(0, span, L)  # [K, R, span]
    return torch.einsum("js,krs->kjr", a, windows)


def dma_banded_contract(buffer, base: int, a, *, L: int, M: int, span: int, K: int, band=None):
    """``out[k, j, r] = sum_s a[j, s] * buffer[base + k*L + s, r]``,
    ``[K, M, R]`` f32.  ``band = (plan, i0)``: ``a`` is the atlas window
    of ``plan`` (a ``BandPlan``) at start phase ``i0``, and the kernel
    reads only the columns each row tile needs; ``None`` reads the full
    span.  CUDA tensors launch kernel B1 on the current stream; CPU
    tensors run the plain version, which ignores ``band``.  Anything else
    raises."""
    _check_banded(buffer, base, a, L, M, span, K)
    if band is not None:
        plan, i0 = band
        plan.check(L, M, span, i0)
    if _device_kind(buffer) == "cpu":
        return dma_banded_contract_reference(buffer, base, a, L=L, M=M, span=span, K=K)
    R = buffer.shape[1]
    out = torch.empty((K, M, R), dtype=torch.float32, device=buffer.device)
    if band is None:
        tiles, rows = 0, 32
    else:
        # row i0 of the [period, n_tiles, 2] int32 table, by address (no
        # indexing op on the host)
        tiles = plan.table(buffer.device).data_ptr() + 8 * plan.n_tiles * i0
        rows = plan.rows
    # 16-byte ring copies and output stores need a lane count and row pitch
    # that keep them aligned
    vec = int(R % 4 == 0 and buffer.data_ptr() % 16 == 0)
    _launch(
        "fir_banded_contract", buffer.device,
        _P(buffer.data_ptr()), _P(a.data_ptr()), _I64(a.stride(0)), _I64(a.stride(1)),
        _P(tiles), _P(out.data_ptr()), _I(R), _I64(base), _I(L), _I(M), _I(span), _I(K),
        _I(rows), _I(vec),
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
