"""Kernels B1-B3: the contractions of the time-major sync FIR fleet.

Ports of ``resampler_tpu/ops/fir_dma_kernel.py``:

- B1 ``dma_banded_contract`` (``:277``), the periodic path::

      out[k, j, r] = sum_{s < span} a[j, s] * buffer[base + k*L + s, r],  k < K

  ``a [M, span]`` at any strides; returns ``[K, M, R]``.  The fleet's
  atlas window is zero outside each row's taps: ``BandPlan`` gives the
  kernel the columns each tile of rows needs, per start phase.
  ``dma_banded_contract_bm`` is B1 with the tm fleet's output epilogue
  fused (no TPU counterpart: the JAX fleet leaves it to XLA): rows
  ``k*M + j`` below ``out_cap`` stored as ``[B, out_cap, C]`` (lane
  ``b*C + c``), those past ``n_out`` as zeros, and ``max |x|`` of the rest
  metered into a peak scalar.
- B2 ``dma_farrow_contract`` (``:225``), the farrow / lerp / wide path
  for Farrow blocks of ``q >= 8`` outputs, and B3
  ``dma_farrow_contract_packed`` (``:170``), the same sum for ``q < 8``
  (heavy coprime downsampling)::

      out[k, l, r] = sum_{s < w} a_blk[k, l, s] * buffer[base + block_base[k] + s, r]

  ``a_blk [K, q, w]``, ``block_base [K]`` host ints (the plan's static
  table); returns ``[K, q, R]``.  Each output's weights are zero outside
  its taps: ``FarrowBandPlan`` gives B2 the columns each tile of rows
  needs, once per plan.  ``dma_farrow_contract_bm`` is B2 with
  the tm fleet's output epilogue fused, as ``dma_banded_contract_bm`` is
  B1's: output rows ``k*q + l`` below ``out_cap`` stored as ``[B,
  out_cap, C]``, those past ``n_out`` as zeros, the peak metered.
- ``FarrowWeightsKernel`` builds B2/B3's ``a_blk`` for one step on the
  card from the step's residue word and static tables (no TPU
  counterpart: the JAX fleet forms it with XLA ops).  Its plain version is
  ``engine/fir_fleets.py farrow_weights``, which the step runs off the
  card; this wrapper takes CUDA tensors only.

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

from ..utils import tracing
from ._build import LAUNCHES, SMEM_MAX, device_kind as _device_kind, launch as _launch

__all__ = [
    "BandPlan",
    "dma_banded_contract",
    "dma_banded_contract_bm",
    "dma_banded_contract_bm_reference",
    "dma_banded_contract_reference",
    "dma_farrow_contract",
    "dma_farrow_contract_bm",
    "dma_farrow_contract_bm_reference",
    "dma_farrow_contract_packed",
    "dma_farrow_contract_reference",
    "FarrowBandPlan",
    "FarrowWeightsKernel",
]

_P, _I, _I64, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
#: B3 keeps a thread block's weights in shared memory: the 48 KB default
#: less its 4 KB reduction buffer
_PACKED_SMEM_MAX = 44 * 1024
#: per-device copies of B2/B3's ``block_base`` tables, uploaded once
_block_base_cache: dict[tuple, torch.Tensor] = {}
#: the most basis rows ``d1`` the weights kernel takes (``kD1Max``)
_WEIGHTS_D1_MAX = 16
#: B1's tile (``csrc/fir_banded_contract.cu``): lanes per block, band
#: columns per pipeline slice, slices in flight
BAND_LANES, BAND_DEPTH, BAND_STAGES = 256, 16, 3
#: B2's tile (``csrc/fir_farrow_contract.cu``): rows per block (its lanes,
#: band columns per slice and slices in flight are B1's)
FARROW_ROWS = 32


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
    with tracing.span("fir.check"):
        _check_banded(buffer, base, a, L, M, span, K)
        if band is not None:
            plan, i0 = band
            plan.check(L, M, span, i0)
    if _device_kind(buffer) == "cpu":
        return dma_banded_contract_reference(buffer, base, a, L=L, M=M, span=span, K=K)
    out = torch.empty((K, M, buffer.shape[1]), dtype=torch.float32, device=buffer.device)
    _banded_launch(buffer, base, a, out, L, M, span, K, band)
    return out


def _banded_launch(buffer, base, a, out, L, M, span, K, band, out_cap=0, C=1, n_out=0, peak=None):
    """Launch B1 into ``out``: time-major for ``out_cap`` 0, else with the
    fused epilogue (``out [R / C, out_cap, C]``, ``peak``)."""
    R = buffer.shape[1]
    if band is None:
        tiles, rows = 0, 32
    else:
        plan, i0 = band
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
        _I(rows), _I(vec), _I(out_cap), _I(C), _I(n_out),
        _P(0 if peak is None else peak.data_ptr()),
    )
    LAUNCHES["dma_banded_contract"] += 1


def _check_bm(buffer, out, peak, M: int, K: int, n_out) -> tuple[int, int]:
    """``(out_cap, C)`` of the fused epilogue's ``out [B, out_cap, C]``."""
    R = buffer.shape[1]
    if not isinstance(out, torch.Tensor) or out.dtype != torch.float32 or out.ndim != 3:
        raise TypeError("out must be a 3-D float32 tensor")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    B, out_cap, C = out.shape
    if B * C != R or not 1 <= out_cap <= K * M:
        raise ValueError(
            f"out must be [B, out_cap <= {K * M}, C] with B*C = {R} lanes, got {tuple(out.shape)}"
        )
    if not isinstance(peak, torch.Tensor) or peak.dtype != torch.float32 or peak.ndim != 0:
        raise TypeError("peak must be a 0-d float32 tensor")
    for what, t in (("out", out), ("peak", peak)):
        if t.device != buffer.device:
            raise ValueError(f"{what} is on {t.device}, buffer on {buffer.device}")
    if not isinstance(n_out, int) or isinstance(n_out, bool) or not 0 <= n_out <= out_cap:
        raise ValueError(f"n_out must be an int in [0, {out_cap}], got {n_out!r}")
    return out_cap, C


def dma_banded_contract_bm_reference(
    buffer, base: int, a, out, peak, *, L: int, M: int, span: int, K: int, n_out: int
):
    """Plain PyTorch version of ``dma_banded_contract_bm``: each emitted
    row ``i < n_out`` (``k, j = divmod(i, M)``) gathers its ``span`` ring
    rows at ``base + k*L`` and is contracted with ``a[j]`` in f32; ``out``
    takes them as ``[B, out_cap, C]`` and zeros elsewhere, ``peak`` their
    largest ``|x|`` (NaN where any is NaN) if that is above it.  Returns
    ``(out, peak)``."""
    _check_banded(buffer, base, a, L, M, span, K)
    out_cap, C = _check_bm(buffer, out, peak, M, K, n_out)
    out.zero_()
    if n_out:
        i = torch.arange(n_out, device=buffer.device)
        rows = base + (i // M * L)[:, None] + torch.arange(span, device=buffer.device)
        vals = torch.einsum("is,isr->ir", a[i % M], buffer[rows])  # [n_out, R]
        out[:, :n_out] = vals.reshape(n_out, -1, C).permute(1, 0, 2)
        peak.copy_(torch.maximum(peak, vals.abs().amax()))
    return out, peak


def dma_banded_contract_bm(
    buffer, base: int, a, out, peak, *, L: int, M: int, span: int, K: int, n_out: int, band=None
):
    """B1 with the tm fleet's output epilogue fused, in place: the rows
    ``i = k*M + j < out_cap`` of ``dma_banded_contract``'s output go to
    ``out [B, out_cap, C]`` f32 (``out[b, i, c]`` is lane ``b*C + c``;
    ``out_cap <= K*M``), rows ``i >= n_out`` as zeros; ``peak`` (0-d f32,
    zeroed by the caller) takes ``max |x|`` over the rows below ``n_out``,
    NaN where any is NaN, as ``torch.amax``.  ``band`` as in
    ``dma_banded_contract``.  CUDA tensors launch kernel B1 on the current
    stream (the same sums, in the same order, as its time-major form);
    CPU tensors run the plain version.  Returns ``(out, peak)``."""
    with tracing.span("fir.check"):
        _check_banded(buffer, base, a, L, M, span, K)
        out_cap, C = _check_bm(buffer, out, peak, M, K, n_out)
        if band is not None:
            plan, i0 = band
            plan.check(L, M, span, i0)
    if _device_kind(buffer) == "cpu":
        return dma_banded_contract_bm_reference(
            buffer, base, a, out, peak, L=L, M=M, span=span, K=K, n_out=n_out
        )
    _banded_launch(buffer, base, a, out, L, M, span, K, band, out_cap, C, n_out, peak)
    return out, peak


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


class FarrowBandPlan:
    """B2's band plan for one Farrow plan (``engine/fir_fleets.py
    _farrow_tm_plan``): ``j_loc [K, q]`` the outputs' local offsets in
    their blocks, ``taps``, ``w`` the blocks' width.

    Row ``l`` of block ``k`` is zero outside the columns ``[j_loc[k, l] +
    wrap, + taps)`` (cut at ``w``), ``wrap`` 0 or 1 by the step's residue
    (``farrow_weights``).  The kernel takes ``FARROW_ROWS`` consecutive rows
    per tile; ``tiles[k, t] = (lo, hi)`` are the columns tile ``t`` of
    block ``k`` needs at every position:

    - ``lo = min(j_loc[k, rows of t])``;
    - ``hi = min(w, max(j_loc[k, rows of t]) + 1 + taps)``, the ``+ 1``
      for the wrap.

    The plan is checked against ``a_blk``'s ``[K, q, w]`` at each call;
    that its rows are zero outside it is the caller's to keep."""

    def __init__(self, j_loc, taps: int, w: int):
        j_loc = np.asarray(j_loc)
        if j_loc.dtype.kind not in "iu" or j_loc.ndim != 2 or 0 in j_loc.shape:
            raise ValueError(f"j_loc must be a non-empty [K, q] of ints, got {j_loc.dtype} "
                             f"{j_loc.shape}")
        if min(taps, w) < 1 or j_loc.min() < 0 or j_loc.max() >= w:
            raise ValueError(f"taps, w must be >= 1 and j_loc in [0, w): taps {taps}, w {w}, "
                             f"j_loc in [{j_loc.min()}, {j_loc.max()}]")
        K, q = j_loc.shape
        self.shape = (K, q, w)
        self.n_tiles = -(-q // FARROW_ROWS)
        pad = self.n_tiles * FARROW_ROWS - q  # the last row repeated: it widens no band
        rows = np.pad(j_loc.astype(np.int64), ((0, 0), (0, pad)), mode="edge")
        rows = rows.reshape(K, self.n_tiles, FARROW_ROWS)
        lo = rows.min(-1)
        hi = np.minimum(w, rows.max(-1) + 1 + taps)
        self.tiles = np.stack([lo, hi], -1).astype(np.int32)  # [K, n_tiles, 2]
        self._dev: dict = {}

    def issued(self) -> int:
        """Multiply-adds per lane of one call: each tile's rows below ``q``
        times its band's columns."""
        q = self.shape[1]
        rows = np.minimum(FARROW_ROWS, q - FARROW_ROWS * np.arange(self.n_tiles))
        return int((rows * (self.tiles[..., 1] - self.tiles[..., 0])).sum())

    def check(self, shape: tuple) -> None:
        if shape != self.shape:
            raise ValueError(f"band plan is for a_blk {self.shape}, not {shape}")

    def table(self, device: torch.device) -> torch.Tensor:
        """``tiles`` (int32) on ``device``, uploaded once."""
        tab = self._dev.get(device)
        if tab is None:
            tab = self._dev[device] = torch.from_numpy(self.tiles).to(device)
        return tab


def _check_b2(buffer, base, a_blk, block_base, band) -> np.ndarray:
    bb = _check_farrow(buffer, base, a_blk, block_base)
    if a_blk.shape[1] < 8:
        raise ValueError(f"B2 takes blocks of q >= 8 rows (q < 8: B3), got q={a_blk.shape[1]}")
    if band is not None:
        band.check(tuple(a_blk.shape))
    return bb


def _block_base_table(bb: np.ndarray, device) -> torch.Tensor:
    """``block_base`` on ``device``, uploaded once per table."""
    key = (device, bb.tobytes())
    bb_dev = _block_base_cache.get(key)
    if bb_dev is None:
        bb_dev = _block_base_cache[key] = torch.from_numpy(bb).to(device)
    return bb_dev


def _b2_launch(buffer, base: int, a_blk, bb: np.ndarray, band, out, out_cap=0, C=1, n_out=0,
               peak=None):
    """Launch B2 into ``out``: time-major ``[K, q, R]`` for ``out_cap`` 0,
    else with the fused epilogue (``out [R / C, out_cap, C]``, ``peak``)."""
    K, q, w = a_blk.shape
    R = buffer.shape[1]
    tiles = 0 if band is None else band.table(buffer.device).data_ptr()
    # 16-byte ring copies and output stores need a lane count and row pitch
    # that keep them aligned
    vec = int(R % 4 == 0 and buffer.data_ptr() % 16 == 0)
    _launch(
        "fir_farrow_contract", buffer.device,
        _P(buffer.data_ptr()), _P(a_blk.data_ptr()),
        _P(_block_base_table(bb, buffer.device).data_ptr()), _P(tiles), _P(out.data_ptr()),
        _I(R), _I64(base), _I(K), _I(q), _I(w), _I(vec),
        _I(out_cap), _I(C), _I(n_out), _P(0 if peak is None else peak.data_ptr()),
    )
    LAUNCHES["dma_farrow_contract"] += 1


def dma_farrow_contract(buffer, base: int, a_blk, block_base, band=None):
    """``out[k, l, r] = sum_s a_blk[k, l, s] * buffer[base + block_base[k]
    + s, r]``, ``[K, q, R]`` f32, for Farrow blocks of ``q >= 8`` rows.
    ``band``: a ``FarrowBandPlan`` of ``a_blk``'s plan, whose rows are zero
    outside it; the kernel reads only the columns each row tile needs;
    ``None`` reads the full width.  CUDA tensors launch kernel B2; CPU
    tensors run the plain version, which ignores ``band``."""
    with tracing.span("fir.check"):
        bb = _check_b2(buffer, base, a_blk, block_base, band)
    if _device_kind(buffer) == "cpu":
        return dma_farrow_contract_reference(buffer, base, a_blk, bb)
    K, q, _ = a_blk.shape
    out = torch.empty((K, q, buffer.shape[1]), dtype=torch.float32, device=buffer.device)
    _b2_launch(buffer, base, a_blk, bb, band, out)
    return out


def dma_farrow_contract_bm_reference(buffer, base: int, a_blk, block_base, out, peak, *,
                                     n_out: int):
    """Plain PyTorch version of ``dma_farrow_contract_bm``: each emitted
    row ``i < n_out`` (``k, l = divmod(i, q)``) gathers its ``w`` ring rows
    at ``base + block_base[k]`` and is contracted with ``a_blk[k, l]`` in
    f32; ``out`` takes them as ``[B, out_cap, C]`` and zeros elsewhere,
    ``peak`` their largest ``|x|`` (NaN where any is NaN) if that is above
    it.  Returns ``(out, peak)``."""
    bb = _check_farrow(buffer, base, a_blk, block_base)
    K, q, w = a_blk.shape
    _, C = _check_bm(buffer, out, peak, q, K, n_out)
    out.zero_()
    if n_out:
        i = torch.arange(n_out, device=buffer.device)
        first = torch.from_numpy(base + bb).to(buffer.device)[i // q]
        rows = first[:, None] + torch.arange(w, device=buffer.device)
        vals = torch.einsum("is,isr->ir", a_blk.reshape(K * q, w)[:n_out], buffer[rows])
        out[:, :n_out] = vals.reshape(n_out, -1, C).permute(1, 0, 2)
        peak.copy_(torch.maximum(peak, vals.abs().amax()))
    return out, peak


def dma_farrow_contract_bm(buffer, base: int, a_blk, block_base, out, peak, *, n_out: int,
                           band=None):
    """B2 with the tm fleet's output epilogue fused, in place: the rows
    ``i = k*q + l < out_cap`` of ``dma_farrow_contract``'s output go to
    ``out [B, out_cap, C]`` f32 (``out[b, i, c]`` is lane ``b*C + c``;
    ``out_cap <= K*q``), rows ``i >= n_out`` as zeros; ``peak`` (0-d f32,
    zeroed by the caller) takes ``max |x|`` over the rows below ``n_out``,
    NaN where any is NaN, as ``torch.amax``.  ``band`` as in
    ``dma_farrow_contract``.  CUDA tensors launch kernel B2 on the current
    stream (the same sums, in the same order, as its time-major form); CPU
    tensors run the plain version.  Returns ``(out, peak)``."""
    with tracing.span("fir.check"):
        bb = _check_b2(buffer, base, a_blk, block_base, band)
        K, q, _ = a_blk.shape
        out_cap, C = _check_bm(buffer, out, peak, q, K, n_out)
    if _device_kind(buffer) == "cpu":
        return dma_farrow_contract_bm_reference(buffer, base, a_blk, bb, out, peak, n_out=n_out)
    _b2_launch(buffer, base, a_blk, bb, band, out, out_cap, C, n_out, peak)
    return out, peak


def dma_farrow_contract_packed(buffer, base: int, a_blk, block_base):
    """B2's sum for Farrow blocks of ``q < 8`` rows (heavy coprime
    downsampling), ``[K, q, R]`` f32.  CUDA tensors launch kernel B3,
    which groups ``ceil(8/q)`` blocks per thread block; CPU tensors run
    the plain version."""
    with tracing.span("fir.check"):
        bb = _check_farrow(buffer, base, a_blk, block_base)
        K, q, w = a_blk.shape
        if q >= 8:
            raise ValueError(f"B3 takes blocks of q < 8 rows (q >= 8: B2), got q={q}")
        if -(-8 // q) * q * w * 4 > _PACKED_SMEM_MAX:  # the group's weights
            raise ValueError(f"B3's group weights ({-(-8 // q) * q} x {w}) exceed shared memory")
    if _device_kind(buffer) == "cpu":
        return dma_farrow_contract_reference(buffer, base, a_blk, bb)
    R = buffer.shape[1]
    # 16-byte lane loads need a lane count and row pitch that keep them aligned
    vec = 4 if R % 4 == 0 and buffer.data_ptr() % 16 == 0 else 1
    out = torch.empty((K, q, R), dtype=torch.float32, device=buffer.device)
    _launch(
        "fir_farrow_contract_packed", buffer.device,
        _P(buffer.data_ptr()), _P(a_blk.data_ptr()),
        _P(_block_base_table(bb, buffer.device).data_ptr()), _P(out.data_ptr()),
        _I(R), _I64(base), _I(K), _I(q), _I(w), _I(vec),
    )
    LAUNCHES["dma_farrow_contract_packed"] += 1
    return out


# --------------------------------------------------------------------------
# The Farrow weights of B2 / B3
# --------------------------------------------------------------------------


class FarrowWeightsKernel:
    """The Farrow blocks' banded weights ``a_blk [K, q, w]`` f32 of one
    plan, built on the card for a step's residue word by one launch of the
    weights kernel on the current stream.

    ``kernel(word)``, ``word`` the step's ``pos % M`` or wide ``pos_lo``
    (an int in ``[0, 2^32)``; below ``M`` for the lerp basis): each output
    ``r`` of the ``[K, q]`` tables takes ``t = word + s_pad[r]`` in u32,
    ``wrap = t < word or t >= M``, ``rem = t - M`` if ``wrap`` else ``t``,
    and the row ``sum_d coef_d(rem) * basis[d, s - jl]`` over ``0 <= s -
    jl < taps`` (``jl = j_loc[r] + wrap``), exactly 0 elsewhere; ``coef`` is
    ``combine_basis(rem, M, U)`` in the same f32 operations.

    The tables, checked once here: ``s_pad`` ``[K, q]`` int32 holding the
    splits' u32 bits; ``j_loc`` ``[K, q]`` int32; ``basis`` ``[d1, taps]``
    f32, ``d1`` at most 16; ``U`` the lerp basis's ``[phases, d1]``
    f32 factor, or ``None`` for the Chebyshev values.  All on one CUDA
    device and contiguous; anything else raises (the plain version is
    ``engine/fir_fleets.py farrow_weights``)."""

    def __init__(self, s_pad, j_loc, basis, U, *, M: int, w: int):
        for what, t, dtype in (("s_pad", s_pad, torch.int32), ("j_loc", j_loc, torch.int32),
                               ("basis", basis, torch.float32), ("U", U, torch.float32)):
            if t is None and what == "U":
                continue
            if not isinstance(t, torch.Tensor) or t.dtype != dtype or t.ndim != 2:
                raise TypeError(f"{what} must be a 2-D {dtype} tensor")
            if not t.is_contiguous():
                raise ValueError(f"{what} must be contiguous")
        K, q = s_pad.shape
        d1, taps = basis.shape
        if tuple(j_loc.shape) != (K, q) or K * q < 1:
            raise ValueError(f"s_pad and j_loc must be one non-empty [K, q], got "
                             f"{tuple(s_pad.shape)} and {tuple(j_loc.shape)}")
        if not 1 <= d1 <= _WEIGHTS_D1_MAX:
            raise ValueError(f"the weights kernel takes 1 to {_WEIGHTS_D1_MAX} basis rows d1, "
                             f"got {d1}")
        if U is not None and (U.shape[1] != d1 or U.shape[0] < 1):
            raise ValueError(f"U must be [phases, {d1}], got {tuple(U.shape)}")
        if not isinstance(M, int) or isinstance(M, bool) or not 1 <= M < 1 << 32:
            raise ValueError(f"M must be an int in [1, 2^32), got {M!r}")
        if not isinstance(w, int) or not taps <= w < 1 << 31 or K * q * w >= 1 << 31:
            raise ValueError(f"w must be an int >= taps = {taps} with K*q*w < 2^31, got {w!r}")
        device = s_pad.device
        for what, t in (("j_loc", j_loc), ("basis", basis), ("U", U)):
            if t is not None and t.device != device:
                raise ValueError(f"{what} is on {t.device}, s_pad on {device}")
        if _device_kind(s_pad) != "cuda":
            raise ValueError(
                f"the weights kernel runs on a CUDA device, not {device}; "
                "farrow_weights is its plain version"
            )
        self.shape, self.device = (K, q, w), device
        self._tables = (s_pad, j_loc, basis, U)  # kept alive for the pointers below
        self._words = M if U is not None else 1 << 32
        self._args = (
            _U32(M), _P(s_pad.data_ptr()), _P(j_loc.data_ptr()), _P(basis.data_ptr()),
            _P(0 if U is None else U.data_ptr()), _I(0 if U is None else U.shape[0]),
            _I(K * q), _I(d1), _I(taps), _I(w),
        )

    def __call__(self, word: int) -> torch.Tensor:
        if not isinstance(word, int) or isinstance(word, bool) or not 0 <= word < self._words:
            raise ValueError(f"word must be an int in [0, {self._words}), got {word!r}")
        a_blk = torch.empty(self.shape, dtype=torch.float32, device=self.device)
        _launch("fir_farrow_weights", self.device, _U32(word), *self._args, _P(a_blk.data_ptr()))
        LAUNCHES["farrow_weights"] += 1
        return a_blk
