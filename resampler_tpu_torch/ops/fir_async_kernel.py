"""Kernel B6: the fused contraction and combine of the async FIR fleet.

Port of ``resampler_tpu/ops/fir_async_kernel.py:294 build_async_combine``.
It computes the function the JAX package's XLA async step computes
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

- ``async_combine_plan`` holds the static tables (``A``, ``j``, ``s``,
  ``M``, the skew) and their per-device copies.
- ``async_combine`` launches the CUDA kernel (``csrc/fir_async_combine.cu``)
  for CUDA tensors, counted in ``LAUNCHES``; ``async_combine_reference``,
  the plain PyTorch version (the XLA step's region select, banded einsum,
  wrap takes and Chebyshev combine), runs for CPU tensors.  There is no
  fallback between the two.

What does not carry over from the TPU kernel: the per-block atlas and its
shift/dual forms, the 8-row DMA remainder switch (Mosaic cannot gather;
any row is addressable here), the wide u/wrap planes (the CUDA kernel has
native u32 and computes the wide residues itself), the ``R % 128`` and
``MAX_SDMA`` gates, and the bf16x4 contraction (B6 is f32 FMA).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import LAUNCHES, device_kind, launch

__all__ = ["AsyncCombinePlan", "async_combine", "async_combine_plan", "async_combine_reference"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_U32 = (1 << 32) - 1
#: rows per band of the plain version's banded einsum (the XLA step's ``Lb``)
_LB = 64


class AsyncCombinePlan:
    """Static tables of B6 for one fleet: ``A [d1, taps]`` (the Farrow
    basis), ``j``, ``s`` ``[out_cap]`` int64, ``M``, ``skew_periods``.
    ``reach`` is the highest ring row, relative to ``base0``, that a call
    may read: the ring must hold ``[base0, base0 + reach)``."""

    def __init__(self, A: np.ndarray, j: np.ndarray, s: np.ndarray, M: int, skew_periods: int):
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
        # the plain version's banded atlas: ab[p*d1 + d, p + t] = A[d, t]
        ab = np.zeros((_LB * self.d1, _LB + self.taps - 1), np.float32)
        for p in range(_LB):
            ab[p * self.d1 : (p + 1) * self.d1, p : p + self.taps] = self.A
        self._ab = ab
        p_pad = -(-(int(self.j[-1]) + 2) // _LB) * _LB
        self.reach = p_pad + self.taps - 1 + self.skew
        self._dev: dict = {}

    def tables(self, device: torch.device) -> dict:
        """The tables on ``device``, uploaded once."""
        tabs = self._dev.get(device)
        if tabs is None:
            tabs = self._dev[device] = dict(
                a_t=torch.from_numpy(np.ascontiguousarray(self.A.T)).to(device),
                ab=torch.from_numpy(self._ab).to(device),
                j=torch.from_numpy(self.j).to(device),
                s=torch.from_numpy(self.s).to(device),
            )
        return tabs


def async_combine_plan(*, A, L: int, M: int, out_cap: int, skew_periods: int, clamp_j=None):
    """The plan of an async fleet: lane tables ``j = (n*L)//M`` (clamped at
    ``clamp_j`` on wide pairs, as the JAX step clamps at
    ``input_capacity + 2``) and ``s = (n*L)%M`` for ``n < out_cap``."""
    n = np.arange(out_cap, dtype=np.int64)
    j = (n * L) // M
    if clamp_j is not None:
        j = np.minimum(j, clamp_j)
    return AsyncCombinePlan(A, j, (n * L) % M, M, skew_periods)


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
    """Plain PyTorch version of B6, the JAX XLA step's form: the region read
    with each lane's frame skew selected in, the banded basis-response
    einsum (f32), the takes at ``j`` and ``j + 1``, the select on the wrap
    bit and the Chebyshev combine.  ``[out_cap, R]``."""
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
    y = torch.einsum("qs,ksr->kqr", tabs["ab"], segs).reshape(p_pad, plan.d1, R)

    # ---- wrap select and Chebyshev combine ----
    y0 = y[j]
    y1 = y[j + 1]
    out[:n_out] = (torch.where(wrap[:, None, :], y1, y0) * v).sum(dim=1)
    return out


def async_combine(buffer, base0: int, n_out: int, lanes, plan: AsyncCombinePlan):
    """B6, ``[out_cap, R]`` f32 (lanes ``n >= n_out`` are zero).  CUDA
    tensors launch the kernel on the current stream; CPU tensors run the
    plain version.  Anything else raises."""
    _check(buffer, base0, n_out, lanes, plan)
    if device_kind(buffer) == "cpu":
        return async_combine_reference(buffer, base0, n_out, lanes, plan)
    R = buffer.shape[1]
    tabs = plan.tables(buffer.device)
    out = torch.empty((plan.out_cap, R), dtype=torch.float32, device=buffer.device)
    launch(
        "fir_async_combine", buffer.device,
        _P(buffer.data_ptr()), _P(tabs["a_t"].data_ptr()), _P(tabs["j"].data_ptr()),
        _P(tabs["s"].data_ptr()), _P(lanes.data_ptr()), _P(out.data_ptr()),
        _I(R), _I64(base0), _I(n_out), _I(plan.out_cap), _I(plan.taps), _I64(plan.M),
        _I(plan.skew),
    )
    LAUNCHES["async_combine"] += 1
    return out
