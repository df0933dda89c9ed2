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
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import threading

import numpy as np
import torch

from ._build import LAUNCHES, device_kind, launch
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

#: the kernel's K step and its column tile unit (``csrc/fft_magsplit.cu``)
_BK = 32
_COL_UNIT = 64
_MAX_COL_FRAGS = 5
#: kernel-side weight copies: (plan, device) -> (wh, wcorr, packed, col_frags)
_packed: dict[tuple, tuple] = {}
_packed_lock = threading.Lock()


def _col_frags(cols: int) -> int:
    """Column tile of the kernel, in units of 64: one tile per group where
    ``cols <= 320``, else tiles of 320."""
    return min(-(-cols // _COL_UNIT), _MAX_COL_FRAGS)


def _kernel_weights(wh, wcorr, plan: MagsplitPlan):
    """The kernel-side copy of ``(wh, wcorr)``: ``[s, k_pad, cols_pad]``
    bf16, the two stacks concatenated along K and zero-padded (K to a
    multiple of 32, columns to whole tiles).  Built once per (plan,
    device) from the arrays given, and rebuilt if other arrays come."""
    key = (plan, str(wh.device))
    with _packed_lock:
        hit = _packed.get(key)
    if hit is not None and hit[0] is wh and hit[1] is wcorr:
        return hit[2], hit[3]
    nf = _col_frags(plan.cols)
    cols_pad = -(-plan.cols // (_COL_UNIT * nf)) * _COL_UNIT * nf
    ktot = plan.rows + 2 * plan.wc
    k_pad = -(-ktot // _BK) * _BK
    packed = torch.zeros((plan.s, k_pad, cols_pad), dtype=torch.bfloat16, device=wh.device)
    packed[:, : plan.rows, : plan.cols] = wh
    packed[:, plan.rows : ktot, : plan.cols] = wcorr
    with _packed_lock:
        _packed[key] = (wh, wcorr, packed, nf)
    return packed, nf


def _check(prev, cur, wh, wcorr, plan: MagsplitPlan) -> None:
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


def _launch_projector(prev_ptr: int, cur_ptr: int, R: int, wh, wcorr, plan, device):
    packed, nf = _kernel_weights(wh, wcorr, plan)
    out = torch.empty((R, plan.n_out), dtype=torch.float32, device=device)
    _I = ctypes.c_int
    launch(
        "fft_magsplit_projector", device,
        ctypes.c_void_p(prev_ptr), ctypes.c_void_p(cur_ptr),
        ctypes.c_void_p(packed.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        _I(R), _I(plan.n_in), _I(plan.n_out), _I(plan.s), _I(plan.cols),
        _I(packed.shape[2]), _I(packed.shape[1]), _I(plan.bps * plan.lp),
        _I(plan.b0 * plan.lp), _I(plan.rows), _I(plan.wc), _I(nf),
    )
    return out


def magsplit_projector(prev, cur, wh, wcorr, *, plan: MagsplitPlan):
    """``[prev | cur] @ T2`` by the banded magsplit:
    ``prev, cur [R, N] f32 -> [R, M] f32``.  CUDA tensors launch kernel
    B4 on the current stream; CPU tensors run the plain version; anything
    else raises."""
    _check(prev, cur, wh, wcorr, plan)
    if device_kind(prev) == "cpu":
        return magsplit_projector_reference(prev, cur, wh, wcorr, plan=plan)
    out = _launch_projector(
        prev.data_ptr(), cur.data_ptr(), prev.shape[0], wh, wcorr, plan, prev.device
    )
    LAUNCHES["magsplit_projector"] += 1
    return out


def magsplit_projector_pool(pool, idx_prev: int, idx_cur: int, wh, wcorr, *,
                            plan: MagsplitPlan):
    """Rotating-pool form of ``magsplit_projector``: ``prev =
    pool[idx_prev]``, ``cur = pool[idx_cur]``, read in place from the
    caller's ``[P, R, N]`` f32 pool (no staging copy).  Slot indices are
    host ints.  ``[R, M]`` f32.  CUDA tensors launch kernel B5 (B4's
    kernel on two slot pointers); CPU tensors run the plain version."""
    if not isinstance(pool, torch.Tensor) or pool.ndim != 3:
        raise TypeError("pool must be a 3-D [P, R, N] tensor")
    P = pool.shape[0]
    for what, idx in (("idx_prev", idx_prev), ("idx_cur", idx_cur)):
        if not isinstance(idx, int) or isinstance(idx, bool):
            raise TypeError(f"{what} must be a Python int, got {type(idx).__name__}")
        if not 0 <= idx < P:
            raise IndexError(f"{what}={idx} outside the pool of {P} slots")
    prev, cur = pool[idx_prev], pool[idx_cur]
    _check(prev, cur, wh, wcorr, plan)
    if device_kind(pool) == "cpu":
        return magsplit_projector_reference(prev, cur, wh, wcorr, plan=plan)
    out = _launch_projector(
        prev.data_ptr(), cur.data_ptr(), prev.shape[0], wh, wcorr, plan, pool.device
    )
    LAUNCHES["magsplit_projector_pool"] += 1
    return out
