"""Kernels B4 and B5: the FFT engine's banded magnitude-split projector.

Port of ``resampler_tpu/ops/fft_magsplit_kernel.py``.  The chunk operator
``out_t = [x_{t-1} | x_t] @ T2`` (``T2 [2N, M]``) is banded Toeplitz with
period ``(lp, mp)``; the projector spends one bf16 pass over each column
group's ``(g+1)``-period band and the two refinement passes (``hi @ T2_lo``
and ``lo @ T2_hi``) over a ``w_p``-period magnitude band only, accumulating
in f32.  ``plan_magsplit`` picks the narrowest band whose host-simulated
noise floor clears the target; ``None`` sends the engine to the dense
projector.

- Host design (NumPy, float64; the JAX module's ``:69-245`` with its
  arithmetic unchanged): ``MagsplitPlan``, ``simulate_magsplit_floor``,
  ``plan_magsplit``, ``magsplit_weights``.  The bf16 rounding is
  ``ops.matmul3.bf16_round_np`` (integer round to nearest even, equal to
  ``ml_dtypes`` bit for bit), so nothing here needs ``ml_dtypes``.
- B4 ``magsplit_projector`` (``:288``) and B5 ``magsplit_projector_pool``
  (``:332``): one CUDA source, ``csrc/fft_magsplit.cu``, for CUDA tensors
  (counted in ``LAUNCHES``); ``magsplit_projector_reference``, the plain
  PyTorch version, for CPU tensors only.  There is no fallback between the
  two.  The TPU kernel's row padding to a multiple of 8 and the pool's
  ``R % 8`` gate do not carry over: the CUDA kernel masks ragged rows.
  The kernel's K tiles and packed weights are planned here
  (``MagsplitTilePlan``); it reads ``prev`` and ``cur`` through TMA maps
  (cached per pointer and shape), so ``N`` must be a multiple of 4 on the
  card, and it takes only a weight pair whose ``t2h`` half of ``wcorr``
  is ``wh``'s slice, as ``magsplit_weights`` builds it: the wrappers raise
  ``ValueError`` otherwise, on the card only.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import threading

import numpy as np
import torch

from ._build import LAUNCHES, build, device_kind, launch
from .matmul3 import bf16_bits_np, bf16_round_np, split_hi_lo

__all__ = [
    "MagsplitPlan",
    "plan_magsplit",
    "magsplit_weights",
    "magsplit_projector",
    "magsplit_projector_pool",
    "magsplit_projector_reference",
    "simulate_magsplit_floor",
]


@dataclasses.dataclass(frozen=True)
class MagsplitPlan:
    """Static geometry of the banded magsplit projector for one pair."""

    n_in: int     # N
    n_out: int    # M
    g: int        # gcd(N, M) = column blocks
    lp: int       # period rows   N / g
    mp: int       # period cols   M / g
    bps: int      # column blocks fused per group
    b0: int       # correction band offset (periods, relative to block)
    w_p: int      # correction band width (periods)
    floor_db: float  # host-simulated noise floor of this plan

    @property
    def s(self) -> int:  # noqa: D102 - groups
        return self.g // self.bps

    @property
    def cols(self) -> int:
        return self.bps * self.mp

    @property
    def rows(self) -> int:  # pass-1 band rows per group (g+1 period span)
        return (self.bps + self.g) * self.lp

    @property
    def wc(self) -> int:  # correction band rows per group
        return (self.w_p + self.bps - 1) * self.lp

    @property
    def macs_per_sample(self) -> int:
        """Tensor-core MACs per output sample (a dense three-pass bf16
        product spends 3 * 2N)."""
        return self.rows + 2 * self.wc


def _t2_f64(n_in: int, n_out: int) -> np.ndarray:
    from ..engine.fft import spectral_projection_matrix

    T = spectral_projection_matrix(n_in, n_out).astype(np.float64)
    return np.vstack([T[:, n_out:], T[:, :n_out]])  # [2N, M]


def simulate_magsplit_floor(
    n_in: int, n_out: int, bps: int, b0: int, w_p: int, T2: np.ndarray
) -> float:
    """Bit-exact host simulation of the kernel's dataflow on white noise:
    returns -20*log10(rms error vs f64 / rms signal) in dB.  The device
    kernel differs only in f32 accumulation order."""
    g = math.gcd(n_in, n_out)
    lp, mp = n_in // g, n_out // g
    t2h = bf16_round_np(T2)
    t2l = bf16_round_np(T2 - t2h.astype(np.float64))
    rng = np.random.default_rng(7)
    x2 = rng.standard_normal((64, 2 * n_in)).astype(np.float32)
    hi = bf16_round_np(x2)
    lo = bf16_round_np(x2 - hi)
    cols = bps * mp
    rows = (bps + g) * lp
    wc = (w_p + bps - 1) * lp
    outs = []
    for q in range(g // bps):
        r0 = q * bps * lp
        rb = r0 + b0 * lp
        csl = slice(q * cols, (q + 1) * cols)
        y = hi[:, r0 : r0 + rows] @ t2h[r0 : r0 + rows, csl]
        y = y + hi[:, rb : rb + wc] @ t2l[rb : rb + wc, csl]
        y = y + lo[:, rb : rb + wc] @ t2h[rb : rb + wc, csl]
        outs.append(y)
    y = np.concatenate(outs, axis=1)
    ref = x2.astype(np.float64) @ T2
    err = y.astype(np.float64) - ref
    return float(-20 * np.log10(np.sqrt((err**2).mean() / (ref**2).mean())))


_PLAN_CACHE: dict[tuple, "MagsplitPlan | None"] = {}
_PLAN_LOCK = threading.Lock()


def plan_magsplit(
    n_in: int,
    n_out: int,
    *,
    target_floor_db: float = 103.0,
    bps: int = 2,
) -> MagsplitPlan | None:
    """Pick the narrowest correction band whose host-simulated noise floor
    clears ``target_floor_db``; ``None`` if the pair is ineligible.

    Eligibility is the JAX package's, unchanged: ``lp, mp >= 64``,
    ``g % bps == 0`` and ``g >= 2*bps`` (at least two column groups),
    ``n_in <= 4096``, and weight stacks of at most 40 MB (the TPU kernel
    holds them on chip; here they are L2-resident at the bench pair's
    8.3 MB).
    """
    key = (n_in, n_out, target_floor_db, bps)
    with _PLAN_LOCK:
        if key in _PLAN_CACHE:
            return _PLAN_CACHE[key]
    g = math.gcd(n_in, n_out)
    lp, mp = n_in // g, n_out // g
    plan: MagsplitPlan | None = None
    if (
        g % bps == 0 and g >= 2 * bps and lp >= 64 and mp >= 64
        and n_in <= 4096
    ):
        T2 = _t2_f64(n_in, n_out)
        # magnitude center: the period of block 0 with the largest entry
        blk = np.abs(T2[:, :mp])
        per_max = blk.reshape(2 * g, lp, mp).max(axis=(1, 2))
        center = int(np.argmax(per_max))
        for w_p in range(2, g + 2):
            b0 = min(max(center - (w_p - 1) // 2, 0), g + 1 - w_p)
            if b0 < 0:
                break
            floor = simulate_magsplit_floor(n_in, n_out, bps, b0, w_p, T2)
            if floor >= target_floor_db:
                plan = MagsplitPlan(
                    n_in=n_in, n_out=n_out, g=g, lp=lp, mp=mp, bps=bps,
                    b0=b0, w_p=w_p, floor_db=round(floor, 1),
                )
                wbytes = plan.s * (plan.rows + 2 * plan.wc) * plan.cols * 2
                if wbytes > 40 * 1024 * 1024:
                    plan = None
                break
    with _PLAN_LOCK:
        _PLAN_CACHE[key] = plan
    return plan


_WEIGHT_CACHE: dict[tuple, tuple] = {}
_WEIGHT_LOCK = threading.Lock()


def _bf16_tensor(a: np.ndarray, device) -> torch.Tensor:
    bits = torch.from_numpy(bf16_bits_np(a).view(np.int16))
    return bits.view(torch.bfloat16).to(device)


def magsplit_weights(plan: MagsplitPlan, device="cuda"):
    """Per-group weight stacks on ``device``, built once per (plan,
    device): ``wh [S, rows, cols]`` bf16 (pass-1 band) and ``wcorr [S,
    2*wc, cols]`` bf16 (T2_lo band stacked over T2_hi band, matching the
    kernel's hi|lo-stacked correction operand).  Bit for bit the JAX
    package's arrays."""
    device = torch.device(device)
    key = (dataclasses.astuple(plan), str(device))
    with _WEIGHT_LOCK:
        cached = _WEIGHT_CACHE.get(key)
    if cached is not None:
        return cached
    T2 = _t2_f64(plan.n_in, plan.n_out)
    t2h = bf16_round_np(T2)
    t2l = (T2 - t2h.astype(np.float64)).astype(np.float32)
    lp = plan.lp
    whs, wcs = [], []
    for q in range(plan.s):
        r0 = q * plan.bps * lp
        rb = r0 + plan.b0 * lp
        csl = slice(q * plan.cols, (q + 1) * plan.cols)
        whs.append(t2h[r0 : r0 + plan.rows, csl])
        wcs.append(
            np.concatenate(
                [t2l[rb : rb + plan.wc, csl], t2h[rb : rb + plan.wc, csl]],
                axis=0,
            )
        )
    out = (_bf16_tensor(np.stack(whs), device), _bf16_tensor(np.stack(wcs), device))
    with _WEIGHT_LOCK:
        _WEIGHT_CACHE[key] = out
    return out


# --------------------------------------------------------------------------
# B4 / B5 and their plain version
# --------------------------------------------------------------------------

#: the kernel's K tile, row tile and column tile (``csrc/fft_magsplit.cu``)
TILE_K = 64
TILE_ROWS = 128
TILE_COLS = 160
#: bytes one K tile stages: the f32 x tile and a bf16 weight tile
_X_TILE_BYTES = 4 * TILE_ROWS * TILE_K
_W_TILE_BYTES = 2 * TILE_K * TILE_COLS


@dataclasses.dataclass(frozen=True)
class MagsplitTile:
    """One K tile of a group's pass-1 band: ``TILE_K`` columns of ``prev``
    (``src`` 0) or ``cur`` (``src`` 1) from column ``col`` (a multiple of
    4), of which the tile-local columns ``[lo, hi)`` lie in the band; local
    column ``j`` is row ``band_row + j`` of ``wh[group]``; its columns
    ``[corr_lo, corr_hi)`` (empty if equal) lie in the correction band."""

    group: int
    src: int
    col: int
    lo: int
    hi: int
    band_row: int
    corr_lo: int
    corr_hi: int


class MagsplitTilePlan:
    """Kernel B4/B5's K tiles (host numpy, once per plan).  Each group's
    pass-1 band ``[r0, r0 + rows)`` of ``x2 = [prev | cur]`` is cut at
    ``N`` into its ``prev`` and ``cur`` parts, and each part into tiles of
    ``TILE_K`` columns, so no tile reads both tensors.  A part's first tile
    starts at its first column rounded down to a multiple of 4: a TMA
    box's innermost coordinate must sit on 16 bytes, and a band starts
    where the plan puts it (``294 q`` at the bench pair); the kernel
    selects the tile's columns outside ``[lo, hi)`` to zero.  The
    correction band ``[rb, rb + wc)`` lies inside the pass-1 band (``b0 <=
    g + 1 - w_p``), so every correction column sits in exactly one tile,
    which serves all three passes.

    - ``tiles``: the ``MagsplitTile`` list, group by group;
    - ``starts [s + 1]`` int32: group ``q``'s tiles are ``starts[q] ..
      starts[q + 1]``;
    - ``table [n_tiles, 8]`` int32, the kernel's copy: ``src, col, lo, hi,
      wh tile, t2l tile (-1: none), corr_lo, corr_hi``, the tile indices
      into the packed weights (``pack``): each tile's ``wh`` rows, then,
      where it meets the correction band, its ``t2l`` rows;
    - ``cols_pad``: ``cols`` rounded up to whole ``TILE_COLS`` tiles."""

    def __init__(self, plan: MagsplitPlan):
        n, lp = plan.n_in, plan.lp
        tiles, starts, table = [], [0], []
        n_w = 0
        for q in range(plan.s):
            r0 = q * plan.bps * lp
            rb = r0 + plan.b0 * lp
            if not (r0 <= rb and rb + plan.wc <= r0 + plan.rows):
                raise ValueError(f"group {q}'s correction band leaves its pass-1 band")
            for b_lo, b_hi, src in ((r0, min(r0 + plan.rows, n), 0), (max(r0, n), r0 + plan.rows, 1)):
                for c in range(b_lo - (b_lo - src * n) % 4, b_hi, TILE_K):
                    lo, hi = max(b_lo - c, 0), min(b_hi - c, TILE_K)
                    clo, chi = min(max(rb - c, lo), hi), min(max(rb + plan.wc - c, lo), hi)
                    if chi <= clo:
                        clo = chi = 0
                    tile = MagsplitTile(q, src, c - src * n, lo, hi, c - r0, clo, chi)
                    tiles.append(tile)
                    corr = chi > clo
                    table.append((src, tile.col, lo, hi, n_w, n_w + 1 if corr else -1, clo, chi))
                    n_w += 1 + corr
            starts.append(len(tiles))
        self.plan = plan
        self.tiles = tiles
        self.starts = np.asarray(starts, np.int32)
        self.table = np.asarray(table, np.int32)
        self.n_wtiles = n_w
        self.cols_pad = -(-plan.cols // TILE_COLS) * TILE_COLS

    def issued_k(self) -> int:
        """The tensor cores' k per output column, summed over the groups:
        16 per k16 step below a tile's ``hi`` (``hi * wh``; ``lo < 4``), and 32
        more per step that meets its correction band (``hi * t2l``, ``lo
        * wh``), as the kernel skips the others."""
        k = 0
        for t in self.tiles:
            for k0 in range(0, t.hi, 16):
                k += 16 + (32 if t.corr_lo < k0 + 16 and k0 < t.corr_hi else 0)
        return k

    def issued_flop(self, R: int) -> float:
        """bf16 tensor-core operations one call issues at ``R`` rows (every
        row and column tile full, as the kernel runs them)."""
        return 2.0 * (-(-R // TILE_ROWS) * TILE_ROWS) * self.issued_k() * self.cols_pad

    def staged_bytes(self, R: int) -> int:
        """Bytes one call brings from L2 into shared memory: each block
        stages its group's tiles (x, ``wh`` and, where the tile meets the
        correction band, ``t2l``)."""
        blocks = -(-R // TILE_ROWS) * (self.cols_pad // TILE_COLS)
        per_tile = _X_TILE_BYTES + _W_TILE_BYTES * (1 + (self.table[:, 5] >= 0))
        return int(blocks * per_tile.sum())

    def pack(self, wh: torch.Tensor, wcorr: torch.Tensor) -> torch.Tensor:
        """The kernel-side weight copy ``[n_wtiles * TILE_K, cols_pad]``
        bf16 on ``wh``'s device: per tile its ``wh`` rows (zero outside
        ``[lo, hi)``) and, where it meets the correction band, its ``t2l`` rows
        (``wcorr[q, :wc]``) at their columns, zero elsewhere; columns past
        ``cols`` zero.  The ``t2h`` half of ``wcorr`` is not copied: ``lo``
        multiplies the ``wh`` tile, which the kernel may do only because
        ``wcorr[:, wc:]`` is bit for bit ``wh[:, b0*lp : b0*lp + wc]``; that
        is checked here and raises ``ValueError`` otherwise."""
        p = self.plan
        off = p.b0 * p.lp
        if not torch.equal(wcorr[:, p.wc :].view(torch.int16), wh[:, off : off + p.wc].view(torch.int16)):
            raise ValueError(
                "wcorr's t2h half is not bit for bit wh's rows b0*lp .. b0*lp + wc: the kernel "
                "multiplies lo by the staged wh tile (magsplit_weights builds such a pair)"
            )
        packed = torch.zeros((self.n_wtiles, TILE_K, self.cols_pad), dtype=torch.bfloat16, device=wh.device)
        for t, row in zip(self.tiles, self.table):
            b = t.band_row
            packed[row[4], t.lo : t.hi, : p.cols] = wh[t.group, b + t.lo : b + t.hi]
            if row[5] >= 0:
                c0 = b - off  # local column 0's row in the correction band
                packed[row[5], t.corr_lo : t.corr_hi, : p.cols] = wcorr[t.group, c0 + t.corr_lo : c0 + t.corr_hi]
        return packed.reshape(self.n_wtiles * TILE_K, self.cols_pad)


#: kernel-side weights per (plan, device): (wh, wcorr, tile plan, packed,
#: and on a CUDA device the table, the starts and the packed weights' map)
_packed: dict[tuple, tuple] = {}
_packed_lock = threading.Lock()
#: encoded x maps per (pointer, R, N); a fleet's pool slots and chunks recur
_x_maps: dict[tuple, ctypes.Array] = {}
_X_MAPS_MAX = 256


@functools.lru_cache(maxsize=None)
def tile_plan(plan: MagsplitPlan) -> MagsplitTilePlan:
    return MagsplitTilePlan(plan)


def _encode(ptr: int, kind: int, rows: int, cols: int) -> ctypes.Array:
    """A TMA map (128 bytes) of ``csrc/fft_magsplit.cu``: kind 0, f32 x
    ``[rows, cols]``; kind 1, the packed weights."""
    buf = ctypes.create_string_buffer(128)
    err = build()["fft_magsplit_encode"].fft_magsplit_encode(
        ctypes.c_void_p(ptr), kind, rows, cols, ctypes.c_void_p(ctypes.addressof(buf)))
    if err != 0:
        raise RuntimeError(f"fft_magsplit_encode failed: error {err}")
    return buf


def _kernel_weights(wh, wcorr, plan: MagsplitPlan):
    """The kernel-side copy of ``(wh, wcorr)`` and the tile plan
    (``MagsplitTilePlan.pack``): built once per (plan, device) from the
    arrays given, and rebuilt if other arrays come.  Returns ``(tile plan,
    packed, on_card)``: ``on_card`` is the table, the starts and the packed
    weights' map on a CUDA device, else None."""
    key = (plan, str(wh.device))
    with _packed_lock:
        hit = _packed.get(key)
    if hit is not None and hit[0] is wh and hit[1] is wcorr:
        return hit[2:]
    tp = tile_plan(plan)
    packed = tp.pack(wh, wcorr)
    on_card = None
    if wh.device.type == "cuda":
        on_card = (torch.from_numpy(tp.table).to(wh.device), torch.from_numpy(tp.starts).to(wh.device),
                   _encode(packed.data_ptr(), 1, packed.shape[0], packed.shape[1]))
    with _packed_lock:
        _packed[key] = (wh, wcorr, tp, packed, on_card)
    return tp, packed, on_card


def _check(prev, cur, wh, wcorr, plan: MagsplitPlan, out=None) -> None:
    for what, t in (("prev", prev), ("cur", cur)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.ndim != 2:
            raise TypeError(f"{what} must be a 2-D float32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    R, n = prev.shape
    if n != plan.n_in or tuple(cur.shape) != (R, n):
        raise ValueError(
            f"prev and cur must both be [R, {plan.n_in}], got "
            f"{tuple(prev.shape)} and {tuple(cur.shape)}"
        )
    shapes = ((plan.s, plan.rows, plan.cols), (plan.s, 2 * plan.wc, plan.cols))
    for what, t, shape in (("wh", wh, shapes[0]), ("wcorr", wcorr, shapes[1])):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.bfloat16:
            raise TypeError(f"{what} must be a bfloat16 tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} must be {list(shape)}, got {list(t.shape)}")
    for t in (cur, wh, wcorr):
        if t.device != prev.device:
            raise ValueError(f"operands on {t.device} and {prev.device}")
    if not 1 <= R < 1 << 31:
        raise ValueError(f"the kernel takes 1 to 2**31 - 1 rows, got {R}")
    if out is None:
        return
    if not isinstance(out, torch.Tensor) or out.dtype != torch.float32:
        raise TypeError("out must be a float32 tensor")
    if tuple(out.shape) != (R, plan.n_out):
        raise ValueError(f"out must be [{R}, {plan.n_out}], got {list(out.shape)}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    if out.device != prev.device:
        raise ValueError(f"out on {out.device}, the operands on {prev.device}")
    lo, hi = out.data_ptr(), out.data_ptr() + out.nbytes
    for t in (prev, cur):  # contiguous, so each spans [data_ptr, + nbytes)
        if t.data_ptr() < hi and lo < t.data_ptr() + t.nbytes:
            raise ValueError("out overlaps prev or cur: the kernel would read what it writes")


def magsplit_projector_reference(prev, cur, wh, wcorr, *, plan: MagsplitPlan):
    """Plain PyTorch version of B4 (and, on two pool slots, B5):
    ``split_hi_lo`` of ``x2 = [prev | cur]`` as tensors of bf16 values,
    then per group ``hi[:, band] @ wh[q] + [hi | lo][:, correction band]
    @ wcorr[q]``.  Every product is exact; the sums run in float64 and are
    rounded once to float32, so this is the kernel's function with the
    least rounding.  (Summed in float32 instead, in cuBLAS's order, the
    3234-term sums of the bench pair over 16384 x 1280 outputs drift
    further from the exact sum than the kernel's do, past the 1e-5
    kernel-vs-plain limit: PERF.md.)  ``[R, M]`` f32."""
    _check(prev, cur, wh, wcorr, plan)
    hi, lo = (t.double() for t in split_hi_lo(torch.cat([prev, cur], dim=1)))
    lp = plan.lp
    outs = []
    for q in range(plan.s):
        r0 = q * plan.bps * lp
        rb = r0 + plan.b0 * lp
        y = hi[:, r0 : r0 + plan.rows] @ wh[q].double()
        hl = torch.cat([hi[:, rb : rb + plan.wc], lo[:, rb : rb + plan.wc]], dim=1)
        outs.append(y + hl @ wcorr[q].double())
    return torch.cat(outs, dim=1).float()


def _x_map(t: torch.Tensor) -> ctypes.Array:
    """The TMA map of an x operand ``[R, N]`` f32, cached per (pointer, R,
    N).  TMA needs 16-byte rows and a 16-byte aligned base."""
    R, n = t.shape
    if n % 4 != 0:
        raise ValueError(
            f"kernel B4/B5 reads prev and cur through TMA, whose row stride must be a multiple of "
            f"16 bytes: N = {n} is not a multiple of 4"
        )
    if t.data_ptr() % 16 != 0:
        raise ValueError("kernel B4/B5 reads prev and cur through TMA: their data must start on 16 bytes")
    key = (t.data_ptr(), R, n)
    with _packed_lock:
        buf = _x_maps.get(key)
    if buf is None:
        buf = _encode(t.data_ptr(), 0, R, n)
        with _packed_lock:
            if len(_x_maps) >= _X_MAPS_MAX:
                _x_maps.clear()
            _x_maps[key] = buf
    return buf


def _launch_projector(prev, cur, wh, wcorr, plan, out=None):
    """Launch B4's kernel on ``prev``, ``cur`` (``[R, N]`` views, for B5
    two slots of the pool) on the current stream, into ``out`` (checked
    by ``_check``) or, without it, a new ``[R, M]``.  The kernel stores
    through a plain pointer, row ``r`` at ``out + r * M``, a float2 per
    column pair where ``cols`` and ``M`` are even: such an ``out`` starts
    on 8 bytes."""
    mp, mc = _x_map(prev), _x_map(cur)
    tp, _, (table, starts, wmap) = _kernel_weights(wh, wcorr, plan)
    R = prev.shape[0]
    if out is None:
        out = torch.empty((R, plan.n_out), dtype=torch.float32, device=prev.device)
    elif (plan.cols | plan.n_out) % 2 == 0 and out.data_ptr() % 8 != 0:
        raise ValueError("kernel B4/B5 stores column pairs as 8-byte words: out must start on 8 bytes")
    launch(
        "fft_magsplit_projector", prev.device,
        *(ctypes.c_void_p(ctypes.addressof(m)) for m in (mp, mc, wmap)),
        ctypes.c_void_p(table.data_ptr()), ctypes.c_void_p(starts.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), R, plan.n_out, plan.s, plan.cols, tp.cols_pad,
    )
    return out


def _plain_into(out, prev, cur, wh, wcorr, plan):
    """The plain version's result, copied into ``out`` where one is given."""
    got = magsplit_projector_reference(prev, cur, wh, wcorr, plan=plan)
    return got if out is None else out.copy_(got)


def magsplit_projector(prev, cur, wh, wcorr, *, plan: MagsplitPlan, out=None):
    """``[prev | cur] @ T2`` by the banded magsplit:
    ``prev, cur [R, N] f32 -> [R, M] f32``.  CUDA tensors launch kernel
    B4 on the current stream; CPU tensors run the plain version; anything
    else raises.

    ``out``, if given, receives the result and is returned: an ``[R, M]``
    f32 tensor on the inputs' device, contiguous, sharing no byte with
    ``prev`` or ``cur`` (``TypeError`` / ``ValueError`` before anything is
    written).  A slot ``t`` of a contiguous ``[T, R, M]`` is such a
    tensor.  Without it the result is a new tensor."""
    _check(prev, cur, wh, wcorr, plan, out)
    if device_kind(prev) == "cpu":
        return _plain_into(out, prev, cur, wh, wcorr, plan)
    out = _launch_projector(prev, cur, wh, wcorr, plan, out)
    LAUNCHES["magsplit_projector"] += 1
    return out


def magsplit_projector_pool(pool, idx_prev: int, idx_cur: int, wh, wcorr, *,
                            plan: MagsplitPlan, out=None):
    """Rotating-pool form of ``magsplit_projector``: ``prev =
    pool[idx_prev]``, ``cur = pool[idx_cur]``, read in place from the
    caller's ``[P, R, N]`` f32 pool (no staging copy).  Slot indices are
    host ints.  ``[R, M]`` f32, into ``out`` if given (its conditions are
    ``magsplit_projector``'s; it may share no byte with either slot).
    CUDA tensors launch kernel B5 (B4's kernel on two slot pointers); CPU
    tensors run the plain version."""
    if not isinstance(pool, torch.Tensor) or pool.ndim != 3:
        raise TypeError("pool must be a 3-D [P, R, N] tensor")
    P = pool.shape[0]
    for what, idx in (("idx_prev", idx_prev), ("idx_cur", idx_cur)):
        if not isinstance(idx, int) or isinstance(idx, bool):
            raise TypeError(f"{what} must be a Python int, got {type(idx).__name__}")
        if not 0 <= idx < P:
            raise IndexError(f"{what}={idx} outside the pool of {P} slots")
    prev, cur = pool[idx_prev], pool[idx_cur]
    _check(prev, cur, wh, wcorr, plan, out)
    if device_kind(pool) == "cpu":
        return _plain_into(out, prev, cur, wh, wcorr, plan)
    out = _launch_projector(prev, cur, wh, wcorr, plan, out)
    LAUNCHES["magsplit_projector_pool"] += 1
    return out
