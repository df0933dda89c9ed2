"""Kernels B6 and B6b: the fused contraction and combine of the async FIR
fleet.

Port of ``resampler_tpu/ops/fir_async_kernel.py:294 build_async_combine``,
B6 its ``precision="highest"`` form and B6b its ``"bf16x4"`` form (the TPU
default).  B6 computes the function the JAX package's XLA async step computes
(``engine/fir_fleets.py:1161-1257``)::

    out[n, r] = sum_{d < 8} T_d(u[n, r]) * y_c[d]          n < n_out, else 0
    y_c[d]    = sum_{t < taps} A[d, t] * buffer[base0 + off[r] + j[n] + c + t, r]

with ``j[n] = (n*L)//M`` and ``s[n] = (n*L)%M`` static, and per lane ``r``
(stream ``b = r // C``) two words, ``lanes [2, R]`` int64: the residue
``res[r]`` (the stream's ``r_b``, or its ``pos_lo`` on wide pairs, in
``[0, 2^32)``) and the stream's frame skew ``base_rel[r]``::

    t = (res + s[n]) mod 2^32;  c = t < res or t >= M;  rem = t - M*c
    u = 2 * float32(rem) / float32(M) - 1
    off = base_rel if 1 <= base_rel <= skew_periods else 0

``c`` picks the wrap row by select, as the XLA step does; ``off`` is the
XLA step's region-select chain, whose fall-through reads offset 0 when a
starved state carries ``base_rel`` past ``skew_periods``.

B6b computes the same with the TPU kernel's degree-banded split
contraction (``_contract`` ``:139-161``, weight split ``:396-413``): with
``x = hi + lo`` each ring sample's ``split_hi_lo``, ``a_hi = bf16(A)`` and
``a_lo = bf16(A - a_hi)`` (``astype``, round to nearest even), ::

    y_c[d] = sum_t a_hi[d, t] hi + (d <= dc) (a_hi[d, t] lo + a_lo[d, t] hi + a_lo[d, t] lo)

where ``dc`` is the last degree whose basis row exceeds 1e-3 of the
basis maximum (``:400-405``).  Every product is exact; the sums are f32 in
the kernel and f64 in the plain version.

- ``async_combine_plan`` holds the static tables (``A`` or its split,
  ``j``, ``s``, ``M``, the skew, the precision) and their per-device copies.
- ``async_combine`` launches the CUDA kernel (``csrc/fir_async_combine.cu``)
  of the plan's precision for CUDA tensors, counted in
  ``LAUNCHES["async_combine"]`` (B6) or ``["async_combine_bf16x4"]`` (B6b);
  ``async_combine_reference``, the plain PyTorch version (the XLA step's
  region select, banded einsum, wrap takes and Chebyshev combine), runs for
  CPU tensors.  There is no fallback between the two.
- ``F32TilePlan`` (B6's, ``plan.f32_tiles()``) cuts the outputs into
  tiles of consecutive outputs, each with the ring rows its block stages
  with ``cp.async`` (a persistent block stages its next tile while it
  computes this one), in one of two forms that ``L/M`` picks: at
  ``L <= POSITIONS_MAX_RATIO * M`` the block computes the 8 basis
  responses once per position ``p`` of the tile's range (a thread: one
  lane, 8 consecutive positions, 64 f32 sums over a sliding window of the
  staged rows) and each output takes those of its position ``j[n] + off
  + c``; above, each output contracts its own window.
- ``AsyncTilePlan`` (B6b's, ``plan.tiles``) cuts the outputs into tiles
  and lists, per tile, the ring rows its block stages (the union of its
  outputs' windows, in order) and where each output's window starts among
  them; ``b_fragments`` packs the split basis as the tensor cores'
  B operand.  B6b runs on the bf16 tensor cores (``mma.sync`` m16n8k16,
  f32 sums): each MMA row is one lane of one output, its 16 columns 16
  taps of that output's window, its 8 columns of B the basis degrees.

What does not carry over from the TPU kernel: the per-block atlas and its
shift/dual forms, the 8-row DMA remainder switch (Mosaic cannot gather;
any row is addressable here), the wide u/wrap planes (the CUDA kernel has
native u32 and computes the wide residues itself), the ``R % 128`` and
``MAX_SDMA`` gates, the wrap blend ``z0 + w (z1 - z0)`` and the division
as ``rem * (1/M)`` (B6b keeps B6's select and IEEE division).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import tracing
from ._build import LAUNCHES, SMEM_MAX, device_kind, launch
from .matmul3 import bf16_bits_np, bf16_round_np, split_hi_lo

__all__ = [
    "AsyncCombinePlan", "AsyncTilePlan", "F32TilePlan", "async_combine", "async_combine_plan",
    "async_combine_reference", "b_fragments", "degree_cut",
]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_U32 = (1 << 32) - 1
#: rows per band of the plain version's banded einsum (the XLA step's ``Lb``)
_LB = 64
#: correction products are dropped for basis rows at or below this share
#: of the basis maximum (the TPU kernel's degree cut)
_DEGREE_CUT = 1e-3
#: B6b's block: 32 lanes (two 16-row MMA groups) by one tile of outputs
TC_LANES = 32
#: ring rows one B6b block stages at most (2 blocks of 8 warps fit an SM)
TC_ROWS_MAX = 320
#: outputs per tile, the largest whose tiles stage at most TC_ROWS_MAX rows
#: (on an H100 128 ran faster than 64, and 64 than 32: each block's
#: staging is a fixed cost)
TC_TILE_OUTPUTS = (128, 64, 32, 16, 8, 4, 2, 1)
#: floats per staged f32 row in shared memory (the lanes, padded so the
#: split pass reads without bank conflicts)
TC_STAGE_PITCH = 36
#: B6's block: 32 lanes by 4 warps
F32_LANES, F32_WARPS = 32, 4
#: consecutive positions per thread (8 degrees each: 64 f32 sums), and
#: per pass of a block
F32_KP = 8
F32_PASS = F32_KP * F32_WARPS
#: floats per lane of a warp's response scratch: 8 positions x 8 degrees,
#: padded so 16-byte accesses meet no bank conflict
F32_YS_PITCH = F32_KP * 8 + 4
#: passes of 32 positions per tile at most
F32_MAX_PASSES = 4
#: B6 computes every position where L <= POSITIONS_MAX_RATIO * M, about
#: L/M positions per output, and above it contracts each output's own
#: window.  On an H100 a position cost 0.65x an output's own contraction
#: (chip_smoke.py phase 11, case (a), both forms in turns: 0.2592 ms for
#: 2112 positions per lane, 0.3863 ms for 2048 outputs), so the forms
#: cross near L/M = 1.5
POSITIONS_MAX_RATIO = 1.5
#: shared memory of one B6 block when two share an SM (228 KB per SM, 1 KB
#: reserved per block)
F32_SMEM_TWO = 115_712


def degree_cut(A) -> int:
    """The last degree that takes B6b's correction products: the highest
    ``d`` whose row maximum exceeds 1e-3 of the basis maximum, scanning
    down from the top (in f64, as the TPU kernel's build does)."""
    a = np.abs(np.asarray(A, np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):  # an all-zero basis cuts nothing
        rel = a.max(axis=1) / a.max()
    dc = a.shape[0] - 1
    while dc > 0 and rel[dc] <= _DEGREE_CUT:
        dc -= 1
    return dc


class AsyncTilePlan:
    """B6b's output tiles.  An output ``n`` of a lane with frame skew
    ``off`` in ``[0, skew]`` and wrap bit ``c`` reads the ring rows
    ``base0 + j[n] + off + c + t``, ``t < taps``: all within its window
    ``[j[n], j[n] + window)``, ``window = taps + skew + 1``.  Tiles of
    ``outputs`` consecutive outputs (the largest of ``TC_TILE_OUTPUTS``
    whose every tile stages at most ``TC_ROWS_MAX`` rows: 128 where ``j``
    steps by about one row, 2 at 367500 -> 1601 where the windows are
    disjoint) stage the union of their outputs' windows, in order:

    - ``rowmap [n_tiles, rows_pad]`` int32: the ring rows (relative to
      ``base0``) of a tile's staged rows, padded with its last row;
    - ``win [out_cap]`` int32: where output ``n``'s window starts among
      its tile's staged rows, so it reads staged rows ``win[n] + off + c
      + t``; the parity of that start picks the kernel's shifted copy.

    The kernel stages only the prefix that the tile's outputs below
    ``n_out`` read."""

    def __init__(self, j, taps: int, skew: int):
        j = np.asarray(j, np.int64)
        if j.ndim != 1 or j.size < 1 or np.any(np.diff(j) < 0) or j[0] < 0:
            raise ValueError("j must be a non-empty, non-decreasing table of rows >= 0")
        if taps not in (16, 32, 64, 128):
            raise ValueError(f"B6b's tensor-core tiles take 16, 32, 64 or 128 taps, got {taps}")
        self.taps, self.skew = int(taps), int(skew)
        self.window = self.taps + self.skew + 1
        if self.skew < 1 or self.window > TC_ROWS_MAX:
            raise ValueError(f"a window of {self.window} rows (skew {skew}) exceeds {TC_ROWS_MAX}")
        for nt in TC_TILE_OUTPUTS:
            tiles = [self._union(j[n0 : n0 + nt]) for n0 in range(0, j.size, nt)]
            if max(rows.size for rows, _ in tiles) <= TC_ROWS_MAX:
                break
        self.outputs = nt
        self.n_tiles = len(tiles)
        self.rows = max(rows.size for rows, _ in tiles)
        # even, plus the row the shifted copy's last pair reads
        self.rows_pad = -(-self.rows // 2) * 2 + 2
        self.rowmap = np.stack([np.pad(rows, (0, self.rows_pad - rows.size), mode="edge")
                                for rows, _ in tiles]).astype(np.int32)
        self.win = np.concatenate([w for _, w in tiles]).astype(np.int32)
        # 32-bit words per lane of each bf16 array: pairs of rows, the pitch
        # = 4 mod 8 words, so a warp's fragment loads (8 lanes x 4 words)
        # meet 32 banks
        half = self.rows_pad // 2
        self.pitch_w = half + (4 - half) % 8
        # the bf16 arrays, the f32 stage (later the tile's results), the
        # tile's win and s
        self.smem_bytes = 4 * (4 * TC_LANES * self.pitch_w
                               + max(self.rows_pad * TC_STAGE_PITCH, self.outputs * TC_LANES) + 2 * self.outputs)
        if self.smem_bytes > SMEM_MAX:
            raise ValueError(f"B6b's tiles need {self.smem_bytes} B of shared memory")

    def _union(self, jt: np.ndarray):
        rows = np.unique((jt[:, None] + np.arange(self.window)).ravel())
        return rows, np.searchsorted(rows, jt)


class F32TilePlan:
    """B6's tiles (the f32 kernel).  A block is 32 lanes by 4 warps and
    walks its tiles with a double-buffered ``cp.async`` stage; each tile
    is a run of consecutive outputs ``[n_lo, n_hi)`` and the ring rows it
    stages.  The form follows from ``L/M`` alone:

    - ``"positions"`` (``L <= POSITIONS_MAX_RATIO * M``): the tile's
      outputs read positions ``p = j[n] + off + c`` in ``[j[n_lo],
      j[n_hi - 1] + skew + 2)``; the block computes the 8 basis responses
      of every position of that range once, a pass of 32 positions at a
      time (a thread: one lane, ``F32_KP`` consecutive positions), and
      each output takes its position's.  The stage is the contiguous rows
      from ``j[n_lo]``.  Tiles are as long as the shared-memory budget of
      two blocks per SM allows, in passes of 32 positions (the count of
      passes per tile that computes the fewest positions in all);
    - ``"outputs"`` (above, where a position would serve too few outputs
      for its cost): each output contracts its own window; the stage is
      the union of the tile's windows, as ``AsyncTilePlan``'s.

    Tables (int32): ``tiles [n_tiles, 2]`` (``n_lo``, ``n_hi``);
    ``rowmap [n_tiles, rows_pad]`` the ring rows (relative to ``base0``) of
    each tile's staged rows, padded with the last row its outputs read;
    ``aux``: for ``"positions"`` ``pfirst [n_aux]``, the first output whose
    ``j`` reaches position ``p``, for ``"outputs"`` ``win [out_cap]``,
    where output ``n``'s window starts among its tile's staged rows.
    ``emit[n_out]`` is the number of tiles with an output below ``n_out``
    (the tiles one call computes) and ``z0[n_out]`` the first output row
    past them (rows from there to ``out_cap`` are zero-filled)."""

    def __init__(self, j, taps: int, skew: int, L: int, M: int, form: str | None = None):
        j = np.asarray(j, np.int64)
        if j.ndim != 1 or j.size < 1 or np.any(np.diff(j) < 0) or j[0] < 0:
            raise ValueError("j must be a non-empty, non-decreasing table of rows >= 0")
        if taps < F32_KP or taps % F32_KP:
            raise ValueError(f"B6's tiles take a multiple of {F32_KP} taps, got {taps}")
        if skew < 1 or L < 1 or M < 1:
            raise ValueError(f"need skew >= 1, L >= 1 and M >= 1: {skew}, {L}, {M}")
        if form is None:
            form = "positions" if L <= POSITIONS_MAX_RATIO * M else "outputs"
        if form not in ("positions", "outputs"):
            raise ValueError(f"form must be 'positions' or 'outputs', not {form!r}")
        self.form, self.taps, self.skew = form, int(taps), int(skew)
        self.window = self.taps + self.skew + 1
        out_cap = j.size
        if form == "positions":
            best = None
            for passes in range(1, F32_MAX_PASSES + 1):
                if passes * F32_PASS < self.skew + 2:
                    continue
                rows_pad = passes * F32_PASS + self.taps
                fixed = 4 * (8 * self.taps + 2 * F32_LANES * rows_pad + F32_WARPS * F32_LANES * F32_YS_PITCH)
                out_max = (F32_SMEM_TWO - fixed) // (4 * F32_LANES + 16)  # results, two (j, s) stages
                if out_max < 1:
                    continue
                # each tile: from n_lo, the outputs whose positions stay in
                # its passes, at most out_max of them
                last = np.searchsorted(j, j + passes * F32_PASS - self.skew - 2, side="right")
                bounds = [0]
                while bounds[-1] < out_cap:
                    n_lo = bounds[-1]
                    bounds.append(int(min(last[n_lo], n_lo + out_max, out_cap)))
                lo, hi = np.array(bounds[:-1]), np.array(bounds[1:])
                span = j[hi - 1] + self.skew + 2 - j[lo]
                computed = int((-(-span // F32_PASS) * F32_PASS).sum())
                if best is None or computed < best[0]:
                    best = (computed, passes, rows_pad, lo, hi)
            if best is None:
                raise ValueError(f"skew {skew} leaves no positions tile within the shared-memory budget")
            self.positions, self.passes, self.rows_pad, lo, hi = best
            last_row = j[hi - 1] + self.window - 1  # the last row the tile's outputs read
            self.rowmap = np.minimum(j[lo][:, None] + np.arange(self.rows_pad), last_row[:, None])
            # positions up to j[-1] + skew + 1, plus a thread's F32_KP past them
            self.aux = np.searchsorted(j, np.arange(int(j[-1]) + self.skew + 3 + F32_KP), side="left")
        else:
            out_max = 64  # outputs per tile at most: the results' share of the budget
            rows_cap = (F32_SMEM_TWO // 4 - 8 * self.taps - (F32_LANES + 4) * out_max) // (2 * F32_LANES)
            if self.window > rows_cap:
                raise ValueError(f"a window of {self.window} rows exceeds {rows_cap}")
            new = np.minimum(np.diff(j), self.window)  # rows each output adds to its predecessor's union
            bounds = [0]
            while bounds[-1] < out_cap:
                n_lo = bounds[-1]
                grow = self.window + np.cumsum(new[n_lo : n_lo + out_max - 1])
                bounds.append(min(n_lo + 1 + int(np.searchsorted(grow, rows_cap, side="right")), out_cap))
            lo, hi = np.array(bounds[:-1]), np.array(bounds[1:])
            unions = [np.unique((j[a:b, None] + np.arange(self.window)).ravel()) for a, b in zip(lo, hi)]
            self.rows_pad = max(u.size for u in unions)
            self.rowmap = np.stack([np.pad(u, (0, self.rows_pad - u.size), mode="edge") for u in unions])
            self.aux = np.concatenate([np.searchsorted(u, j[a:b]) for u, a, b in zip(unions, lo, hi)])
            self.positions = None
        self.tiles = np.stack([lo, hi], axis=1).astype(np.int32)
        self.rowmap = self.rowmap.astype(np.int32)
        self.aux = self.aux.astype(np.int32)
        self.n_tiles = len(lo)
        self.out_max = int((hi - lo).max())
        self.smem_bytes = 4 * (8 * self.taps + 2 * F32_LANES * self.rows_pad + (F32_LANES + 4) * self.out_max
                               + (F32_WARPS * F32_LANES * F32_YS_PITCH if form == "positions" else 0))
        if self.smem_bytes > SMEM_MAX:
            raise ValueError(f"B6's tiles need {self.smem_bytes} B of shared memory")
        emit = np.searchsorted(lo, np.arange(out_cap + 1), side="left")
        self.emit = emit.tolist()
        self.z0 = np.where(emit > 0, hi[np.maximum(emit - 1, 0)], 0).tolist()


def b_fragments(bases) -> np.ndarray:
    """The tensor cores' B operand: bf16-valued bases ``[d1 = 8, taps]``
    packed as ``mma.sync`` m16n8k16 fragments, ``[len(bases), taps/16,
    32, 2]`` uint32.  Thread ``4g + t`` of k-step ``s`` holds degree
    ``g`` at taps ``16s + 2t, +1`` (word 0) and ``16s + 2t + 8, +9``
    (word 1), the lower tap in the low half."""
    out = []
    for a in bases:
        bits = bf16_bits_np(np.asarray(a, np.float32)).astype(np.uint32)  # [8, taps]
        d1, taps = bits.shape
        t = np.arange(4)
        cols = np.stack([np.stack([2 * t, 2 * t + 1], -1), np.stack([2 * t + 8, 2 * t + 9], -1)], 1)  # [4, 2, 2]
        ks = bits.reshape(d1, taps // 16, 16)[:, :, cols]  # [8, ks, 4, 2, 2]
        words = ks[..., 0] | (ks[..., 1] << 16)  # [8 (g), ks, 4 (t), 2]
        out.append(words.transpose(1, 0, 2, 3).reshape(taps // 16, 32, 2))
    return np.stack(out)


class AsyncCombinePlan:
    """Static tables of B6 / B6b for one fleet: ``A [d1, taps]`` (the
    Farrow basis), ``j``, ``s`` ``[out_cap]`` int64, ``M``,
    ``skew_periods``, ``precision`` (``"highest"``: B6, f32; ``"bf16x4"``:
    B6b, with the split basis ``a_hi``, ``a_lo`` and the degree cut
    ``dc``).  ``L = j[1] * M + s[1]`` is the ratio's numerator (B6's form
    follows ``L/M``).  ``reach`` is the highest ring row, relative to
    ``base0``, that a call may read: the ring must hold ``[base0, base0 +
    reach)``."""

    def __init__(self, A: np.ndarray, j: np.ndarray, s: np.ndarray, M: int, skew_periods: int,
                 precision: str = "highest"):
        if precision not in ("highest", "bf16x4"):
            raise ValueError(f"precision must be 'highest' or 'bf16x4', not {precision!r}")
        self.precision = precision
        self.A = np.ascontiguousarray(A, np.float32)
        self.d1, self.taps = self.A.shape
        if self.d1 != 8:
            raise ValueError(f"B6 takes the degree-7 basis (8 rows), got {self.d1}")
        self.j = np.asarray(j, np.int64)
        self.s = np.asarray(s, np.int64)
        self.out_cap = self.j.shape[0]
        self.M = int(M)
        self.skew = int(skew_periods)
        if self.s.shape != (self.out_cap,) or self.out_cap < 1:
            raise ValueError("j and s must be equal-length, non-empty lane tables")
        if not 1 <= self.M <= _U32 or self.skew < 1:
            raise ValueError(f"need 1 <= M < 2^32 and skew_periods >= 1: {M}, {skew_periods}")
        self.L = int(self.j[1]) * self.M + int(self.s[1]) if self.out_cap > 1 else self.M
        # B6b's weight split (XLA's astype: round to nearest even, in f32)
        # and degree cut
        self.dc = degree_cut(self.A)
        self.a_hi = bf16_round_np(self.A)
        self.a_lo = bf16_round_np(self.A - self.a_hi)
        self.a_lo[self.dc + 1 :] = 0.0
        # a_hi on the degrees that take corrections, zero on the rest
        self.a_hi_c = np.where(np.arange(self.d1)[:, None] <= self.dc, self.a_hi, 0.0).astype(np.float32)
        # the plain version's banded atlases: ab[p*d1 + d, p + t] = A[d, t]
        self._ab = {name: self._banded(a) for name, a in (
            ("ab", self.A), ("ab_hi", self.a_hi), ("ab_lo", self.a_lo), ("ab_hi_c", self.a_hi_c),
        )}
        p_pad = -(-(int(self.j[-1]) + 2) // _LB) * _LB
        self.reach = p_pad + self.taps - 1 + self.skew
        self._tiles = None
        self._f32_tiles: dict = {}
        self._dev: dict = {}

    @property
    def tiles(self) -> AsyncTilePlan:
        """B6b's tile plan (built on first use; it raises where the
        tensor-core kernel does not take the fleet's taps or skew)."""
        if self._tiles is None:
            self._tiles = AsyncTilePlan(self.j, self.taps, self.skew)
        return self._tiles

    def f32_tiles(self, form: str | None = None) -> F32TilePlan:
        """B6's tile plan in ``form`` (``None``: the form ``L/M`` picks),
        built on first use (it raises where B6's tiles do not take the
        fleet's taps)."""
        key = form or ("positions" if self.L <= POSITIONS_MAX_RATIO * self.M else "outputs")
        if key not in self._f32_tiles:
            self._f32_tiles[key] = F32TilePlan(self.j, self.taps, self.skew, self.L, self.M, key)
        return self._f32_tiles[key]

    @property
    def frags(self) -> np.ndarray:
        """B6b's B operand: ``a_hi``, ``a_hi_c``, ``a_lo`` as
        ``b_fragments``, in the order of the kernel's four passes' bases."""
        return b_fragments((self.a_hi, self.a_hi_c, self.a_lo))

    def _banded(self, a: np.ndarray) -> np.ndarray:
        ab = np.zeros((_LB * self.d1, _LB + self.taps - 1), np.float32)
        for p in range(_LB):
            ab[p * self.d1 : (p + 1) * self.d1, p : p + self.taps] = a
        return ab

    def tables(self, device: torch.device) -> dict:
        """The tables on ``device``, uploaded once."""
        tabs = self._dev.get(device)
        if tabs is None:
            host = dict(a_t=self.A.T, j=self.j, s=self.s, **self._ab)
            if self.precision == "bf16x4" and device.type == "cuda":
                host.update(frags=self.frags.view(np.int32), rowmap=self.tiles.rowmap, win=self.tiles.win)
            elif device.type == "cuda":
                # j and s as one 8-byte word per output (s < 2^32 as u32 bits)
                host.update(js=np.stack([self.j.astype(np.int32), self.s.astype(np.uint32).view(np.int32)], 1))
            tabs = self._dev[device] = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()
            }
        return tabs

    def f32_tables(self, device: torch.device, form: str | None = None) -> dict:
        """B6's tile tables in ``form`` on ``device``, uploaded once."""
        tp = self.f32_tiles(form)
        key = (device, tp.form)
        tabs = self._dev.get(key)
        if tabs is None:
            tabs = self._dev[key] = {
                k: torch.from_numpy(np.ascontiguousarray(getattr(tp, k))).to(device)
                for k in ("tiles", "rowmap", "aux")
            }
        return tabs


def async_combine_plan(*, A, L: int, M: int, out_cap: int, skew_periods: int, clamp_j=None,
                       precision: str = "highest"):
    """The plan of an async fleet: lane tables ``j = (n*L)//M`` (clamped at
    ``clamp_j`` on wide pairs, as the JAX step clamps at
    ``input_capacity + 2``) and ``s = (n*L)%M`` for ``n < out_cap``;
    ``precision`` ``"highest"`` (B6) or ``"bf16x4"`` (B6b)."""
    n = np.arange(out_cap, dtype=np.int64)
    j = (n * L) // M
    if clamp_j is not None:
        j = np.minimum(j, clamp_j)
    return AsyncCombinePlan(A, j, (n * L) % M, M, skew_periods, precision)


def _check(buffer, base0, n_out, lanes, plan: AsyncCombinePlan) -> None:
    if not isinstance(buffer, torch.Tensor) or buffer.dtype != torch.float32 or buffer.ndim != 2:
        raise TypeError("buffer must be a 2-D float32 tensor")
    if not buffer.is_contiguous():
        raise ValueError("buffer must be contiguous")
    ring, R = buffer.shape
    if R < 1 or max(ring, R) >= 1 << 31:
        raise ValueError(f"the kernel takes 1 <= lanes and 32-bit row counts, got {tuple(buffer.shape)}")
    if not isinstance(lanes, torch.Tensor) or lanes.dtype != torch.int64:
        raise TypeError("lanes must be an int64 tensor")
    if tuple(lanes.shape) != (2, R) or not lanes.is_contiguous() or lanes.device != buffer.device:
        raise ValueError(f"lanes must be a contiguous [2, {R}] tensor on {buffer.device}")
    for what, v in (("base0", base0), ("n_out", n_out)):
        if not isinstance(v, int) or isinstance(v, bool):
            raise TypeError(f"{what} must be a Python int, got {type(v).__name__}")
    if not 0 <= n_out <= plan.out_cap:
        raise ValueError(f"n_out={n_out} outside [0, {plan.out_cap}]")
    if base0 < 0 or base0 + plan.reach > ring:
        raise IndexError(
            f"rows [{base0}, {base0 + plan.reach}) fall outside the ring of {ring} rows"
        )


def async_combine_reference(buffer, base0: int, n_out: int, lanes, plan: AsyncCombinePlan):
    """Plain PyTorch version of B6 and B6b, the JAX XLA step's form: the
    region read with each lane's frame skew selected in, the banded
    basis-response einsum (f32; for B6b the split products, exact, summed
    in f64 and rounded once), the takes at ``j`` and ``j + 1``, the select
    on the wrap bit and the Chebyshev combine.  ``[out_cap, R]``."""
    return _reference(buffer, base0, n_out, lanes, plan, torch.float32)


def _reference(buffer, base0: int, n_out: int, lanes, plan: AsyncCombinePlan, dtype):
    """``async_combine_reference`` with the responses and the combine in
    ``dtype`` (float64: B6b's exact sums, B6's sums of the f32 samples and
    basis in f64; the CPU tests' yardstick for the kernels' tilings)."""
    _check(buffer, base0, n_out, lanes, plan)
    R = buffer.shape[1]
    out = buffer.new_zeros((plan.out_cap, R), dtype=dtype)
    if n_out == 0:
        return out
    tabs = plan.tables(buffer.device)
    res, base_rel = lanes[0], lanes[1]
    j, s = tabs["j"][:n_out], tabs["s"][:n_out]

    # ---- residues, exact in int64 with the u32 wrap made explicit ----
    t = (res[None, :] + s[:, None]) & _U32  # [n_out, R]
    wrap = (t < res[None, :]) | (t >= plan.M)
    rem = torch.where(wrap, (t - plan.M) & _U32, t)
    frac = rem.to(torch.float32) / torch.tensor(np.float32(plan.M), device=buffer.device)
    u = (2.0 * frac - 1.0).to(dtype)
    ts = [torch.ones_like(u), u]
    for _ in range(plan.d1 - 2):
        ts.append(2.0 * u * ts[-1] - ts[-2])
    v = torch.stack(ts, dim=1)  # [n_out, d1, R]

    # ---- region read with the per-lane frame skew selected in ----
    p_pad = -(-(int(plan.j[n_out - 1]) + 2) // _LB) * _LB
    rows = p_pad + plan.taps - 1
    reg = buffer[base0 : base0 + rows + plan.skew]
    region = reg[:rows]
    for sk in range(1, plan.skew + 1):
        region = torch.where((base_rel == sk)[None, :], reg[sk : sk + rows], region)

    # ---- banded basis responses y[p, d, r] = sum_t A[d, t] region[p + t, r] ----
    segs = region.unfold(0, _LB + plan.taps - 1, _LB).permute(0, 2, 1)  # [Kc, s_len, R]
    if plan.precision == "bf16x4":
        hi, lo = (h.double() for h in split_hi_lo(segs))
        ab_hi, ab_hi_c, ab_lo = (tabs[k].double() for k in ("ab_hi", "ab_hi_c", "ab_lo"))
        y = (
            torch.einsum("qs,ksr->kqr", ab_hi, hi) + torch.einsum("qs,ksr->kqr", ab_hi_c, lo)
            + torch.einsum("qs,ksr->kqr", ab_lo, hi) + torch.einsum("qs,ksr->kqr", ab_lo, lo)
        ).to(dtype)
    else:
        y = torch.einsum("qs,ksr->kqr", tabs["ab"].to(dtype), segs.to(dtype))
    y = y.reshape(p_pad, plan.d1, R)

    # ---- wrap select and Chebyshev combine ----
    y0 = y[j]
    y1 = y[j + 1]
    out[:n_out] = (torch.where(wrap[:, None, :], y1, y0) * v).sum(dim=1)
    return out


def async_combine(buffer, base0: int, n_out: int, lanes, plan: AsyncCombinePlan, *,
                  _form: str | None = None):
    """B6 (or B6b for a ``"bf16x4"`` plan), ``[out_cap, R]`` f32 (lanes
    ``n >= n_out`` are zero).  CUDA tensors launch the kernel on the
    current stream; CPU tensors run the plain version.  Anything else
    raises.  ``_form`` forces B6's form (``"positions"`` or ``"outputs"``,
    to check and time both on one shape)."""
    with tracing.span("fir.check"):
        _check(buffer, base0, n_out, lanes, plan)
    if device_kind(buffer) == "cpu":
        return async_combine_reference(buffer, base0, n_out, lanes, plan)
    R = buffer.shape[1]
    tabs = plan.tables(buffer.device)
    out = torch.empty((plan.out_cap, R), dtype=torch.float32, device=buffer.device)
    if plan.precision == "bf16x4":
        tp = plan.tiles
        # 16-byte ring copies and output stores need a lane count and row
        # pitch that keep them aligned
        vec = int(R % 4 == 0 and buffer.data_ptr() % 16 == 0)
        launch(
            "fir_async_combine_bf16x4", buffer.device, _P(buffer.data_ptr()), _P(tabs["frags"].data_ptr()),
            _P(tabs["s"].data_ptr()), _P(lanes.data_ptr()), _P(tabs["rowmap"].data_ptr()),
            _P(tabs["win"].data_ptr()), _P(out.data_ptr()), _I(R), _I64(base0), _I(n_out),
            _I(plan.out_cap), _I(plan.taps), _I64(plan.M), _I(plan.skew), _I(tp.outputs), _I(tp.rows_pad),
            _I(tp.pitch_w), _I(vec),
        )
        LAUNCHES["async_combine_bf16x4"] += 1
    else:
        tp = plan.f32_tiles(_form)
        ft = plan.f32_tables(buffer.device, _form)
        vec = int(R % 4 == 0 and buffer.data_ptr() % 16 == 0)
        launch(
            "fir_async_combine", buffer.device, _P(buffer.data_ptr()), _P(tabs["a_t"].data_ptr()),
            _P(tabs["js"].data_ptr()), _P(lanes.data_ptr()), _P(ft["tiles"].data_ptr()),
            _P(ft["rowmap"].data_ptr()), _P(ft["aux"].data_ptr()), _P(out.data_ptr()), _I(R), _I64(base0),
            _I(n_out), _I(plan.out_cap), _I(plan.taps), _I64(plan.M), _I(plan.skew),
            _I(int(tp.form == "positions")), _I(tp.emit[n_out]), _I(tp.z0[n_out]), _I(tp.rows_pad),
            _I(tp.out_max), _I(tp.aux.size), _I(vec),
        )
        LAUNCHES["async_combine"] += 1
    return out
