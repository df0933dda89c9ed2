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

from ._build import LAUNCHES, device_kind, launch
from .matmul3 import bf16_round_np, split_hi_lo

__all__ = [
    "AsyncCombinePlan", "async_combine", "async_combine_plan", "async_combine_reference", "degree_cut",
]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_U32 = (1 << 32) - 1
#: rows per band of the plain version's banded einsum (the XLA step's ``Lb``)
_LB = 64
#: correction products are dropped for basis rows at or below this share
#: of the basis maximum (the TPU kernel's degree cut)
_DEGREE_CUT = 1e-3


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


class AsyncCombinePlan:
    """Static tables of B6 / B6b for one fleet: ``A [d1, taps]`` (the
    Farrow basis), ``j``, ``s`` ``[out_cap]`` int64, ``M``,
    ``skew_periods``, ``precision`` (``"highest"``: B6, f32; ``"bf16x4"``:
    B6b, with the split basis ``a_hi``, ``a_lo`` and the degree cut
    ``dc``).  ``reach`` is the highest ring row, relative to ``base0``,
    that a call may read: the ring must hold ``[base0, base0 + reach)``."""

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
        # B6b's weight split (XLA's astype: round to nearest even, in f32)
        # and degree cut
        self.dc = degree_cut(self.A)
        self.a_hi = bf16_round_np(self.A)
        self.a_lo = bf16_round_np(self.A - self.a_hi)
        self.a_lo[self.dc + 1 :] = 0.0
        # the plain version's banded atlases: ab[p*d1 + d, p + t] = A[d, t]
        self._ab = {name: self._banded(a) for name, a in (
            ("ab", self.A), ("ab_hi", self.a_hi), ("ab_lo", self.a_lo),
            # a_hi on the degrees that take corrections, zero on the rest
            ("ab_hi_c", np.where(np.arange(self.d1)[:, None] <= self.dc, self.a_hi, 0.0)),
        )}
        p_pad = -(-(int(self.j[-1]) + 2) // _LB) * _LB
        self.reach = p_pad + self.taps - 1 + self.skew
        self._dev: dict = {}

    def _banded(self, a: np.ndarray) -> np.ndarray:
        ab = np.zeros((_LB * self.d1, _LB + self.taps - 1), np.float32)
        for p in range(_LB):
            ab[p * self.d1 : (p + 1) * self.d1, p : p + self.taps] = a
        return ab

    def tables(self, device: torch.device) -> dict:
        """The tables on ``device``, uploaded once."""
        tabs = self._dev.get(device)
        if tabs is None:
            host = dict(
                a_t=self.A.T, a_hi_t=self.a_hi.T, a_lo_t=self.a_lo.T, j=self.j, s=self.s,
                **self._ab,
            )
            tabs = self._dev[device] = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()
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
    _check(buffer, base0, n_out, lanes, plan)
    R = buffer.shape[1]
    out = buffer.new_zeros((plan.out_cap, R))
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
    u = 2.0 * frac - 1.0
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
        ).to(torch.float32)
    else:
        y = torch.einsum("qs,ksr->kqr", tabs["ab"], segs)
    y = y.reshape(p_pad, plan.d1, R)

    # ---- wrap select and Chebyshev combine ----
    y0 = y[j]
    y1 = y[j + 1]
    out[:n_out] = (torch.where(wrap[:, None, :], y1, y0) * v).sum(dim=1)
    return out


def async_combine(buffer, base0: int, n_out: int, lanes, plan: AsyncCombinePlan):
    """B6 (or B6b for a ``"bf16x4"`` plan), ``[out_cap, R]`` f32 (lanes
    ``n >= n_out`` are zero).  CUDA tensors launch the kernel on the
    current stream; CPU tensors run the plain version.  Anything else
    raises."""
    _check(buffer, base0, n_out, lanes, plan)
    if device_kind(buffer) == "cpu":
        return async_combine_reference(buffer, base0, n_out, lanes, plan)
    R = buffer.shape[1]
    tabs = plan.tables(buffer.device)
    out = torch.empty((plan.out_cap, R), dtype=torch.float32, device=buffer.device)
    common = (
        _P(tabs["j"].data_ptr()), _P(tabs["s"].data_ptr()), _P(lanes.data_ptr()), _P(out.data_ptr()),
        _I(R), _I64(base0), _I(n_out), _I(plan.out_cap), _I(plan.taps), _I64(plan.M), _I(plan.skew),
    )
    if plan.precision == "bf16x4":
        launch(
            "fir_async_combine_bf16x4", buffer.device, _P(buffer.data_ptr()),
            _P(tabs["a_hi_t"].data_ptr()), _P(tabs["a_lo_t"].data_ptr()), *common, _I(plan.dc),
        )
        LAUNCHES["async_combine_bf16x4"] += 1
    else:
        launch("fir_async_combine", buffer.device, _P(buffer.data_ptr()), _P(tabs["a_t"].data_ptr()),
               *common)
        LAUNCHES["async_combine"] += 1
    return out
