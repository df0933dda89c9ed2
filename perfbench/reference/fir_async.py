"""Plain reference of the async multi-tenant FIR fleet: tenants that share
the rate pair, the chunk cadence and the frames taken, each at its own
position (its join phase, then its drift slews), from the published
description of the crate (hasenbanck/resampler, src/resampler_fir.rs) and
of the fleet (README, ``BatchedResamplerFir(..., sync_variant="async_tm")``
and ``slew``).

Nothing here comes from the program: the filter is designed again in
float64 (``fir.polyphase_table``), the schedule is kept in exact integers,
and every output is a direct sum over its taps on its own residue's row.

Semantics, frames counted per channel from the tenants' first input frame,
positions in 1/M frames (``L/M`` the reduced rate ratio).  Tenant ``b``'s
output ``i`` of a step sits at ``P = F*M + pos[b] + i*L``, where ``F`` is
the frames dropped before the step and ``pos[b]`` the tenant's position
from the first frame kept; with ``j = P // M`` and ``rho = P % M``

    y[i] = sum_t W[rho, t] * x[j + t]        (t < taps)

A step (``AsyncSchedule.feed``) takes ``min(n_valid, capacity - avail)``
frames of every tenant, emits the outputs of the laggard, the largest ``n``
with ``max(pos) + (n-1)*L < (avail - taps + 1)*M`` capped by ``out_cap``
(every tenant emits ``n``), then drops ``min(min(pos + n*L) // M, avail)``
frames.  A slew (``AsyncSchedule.slew``) of ``v`` 1/M frames is clamped to
the buffered history: ``clip(v, -pos, max(0, capacity*M - pos))``.

**Rows, and the one departure from the crate.**  ``W[rho]`` blends two
polyphase branches around ``rho * P / M`` (``P`` branches) linearly, as the
crate's table lerp does.  The crate clamps the second branch to ``min(p1 +
1, P - 1)``, so that between its last branch and the end of a period it
holds the row still.  Here the blend goes on to the prototype's next point,
which is branch 0 one tap later (``row[t] = table[0, t-1]``, and 0 before
the prototype's first point): the filter's continuous kernel, which the
fleet evaluates through its Farrow basis.  The two differ only at residues
whose ``p1`` is ``P - 1``: 43 of the 44101 at 44100 -> 44101 Hz, none at
44100 -> 48000 Hz (whose largest ``p1`` is 1017).  There the crate's clamp
reads ~2e-3 against the fleet (1.9-2.6e-3 on the CPU tests' inputs), the
continued blend under 5e-6: a limit wide enough for the clamp would let a
real fault of the fleet through.
``phase_weights(..., clamped=True)`` gives the crate's rows, which the
tests use to pin the departure.
"""

from __future__ import annotations

import numpy as np
import torch

from .fir import polyphase_table, reduced_ratio
from .precision import tf32_round


def phase_weights(config: dict, clamped: bool = False) -> tuple[np.ndarray, int, int]:
    """``(W [M, taps] float64, L, M)``: the blended row of every residue,
    continued past the last branch (``clamped``: the crate's clamp)."""
    L, M = reduced_ratio(config["input_rate"], config["output_rate"])
    P, taps = config["phases"], config["taps"]
    table = polyphase_table(taps, P, config["kaiser_beta"],
                            config["input_rate"] / config["output_rate"])
    # branch P: the prototype's next point, branch 0 one tap later
    after = np.concatenate([[0.0], table[0, :-1]])
    ext = np.concatenate([table, (table[P - 1] if clamped else after)[None]])
    rho = np.arange(M, dtype=np.int64)
    p1 = rho * P // M
    frac = (rho * P - p1 * M) / M
    return (1.0 - frac)[:, None] * ext[p1] + frac[:, None] * ext[p1 + 1], L, M


class AsyncSchedule:
    """The fleet's schedule in exact integers: ``feed(n_valid)`` returns
    ``(taken, emitted, start)``, ``start [B]`` each tenant's first output
    of the step, absolute (1/M frames from the first input frame);
    ``slew(v)`` returns the applied ``[B]`` slews.  ``pos`` counts from
    the first frame kept, ``dropped`` frames after the first input frame."""

    def __init__(self, L: int, M: int, taps: int, capacity: int, out_cap: int, pos0):
        self.L, self.M, self.taps, self.capacity, self.out_cap = L, M, taps, capacity, out_cap
        self.pos = np.asarray(pos0, np.int64).copy()
        self.avail = 0
        self.dropped = 0

    def feed(self, n_valid: int):
        L, M = self.L, self.M
        taken = min(int(n_valid), self.capacity - self.avail)
        self.avail += taken
        room = (self.avail - self.taps + 1) * M - int(self.pos.max())
        emitted = min(max(-(-room // L), 0), self.out_cap)
        start = self.dropped * M + self.pos
        after = self.pos + emitted * L
        drop = min(int(after.min()) // M, self.avail)
        self.avail -= drop
        self.dropped += drop
        self.pos = after - drop * M
        return taken, emitted, start

    def slew(self, v) -> np.ndarray:
        v = np.asarray(v, np.int64)
        ceiling = self.capacity * self.M
        applied = np.clip(v, -self.pos, np.maximum(0, ceiling - self.pos))
        self.pos = self.pos + applied
        return applied


def outputs(x: torch.Tensor, frame0: int, start: np.ndarray, count: int, W: torch.Tensor,
            L: int, M: int, channels: int, control: bool = False,
            block: int = 1 << 22) -> torch.Tensor:
    """Outputs ``0 .. count`` of the lanes in ``x [R, frames]`` (float64; its
    column 0 is frame ``frame0``; lane ``b*channels + c``), tenant ``b``'s
    output ``i`` at ``start[b] + i*L`` (absolute, 1/M frames), as ``[R,
    count]`` float64.  ``control`` rounds samples and weights to TF32
    first: the products a TF32 tensor core would form, summed exactly."""
    R = x.shape[0]
    taps = W.shape[1]
    if control:
        x, W = tf32_round(x), tf32_round(W)
    dev = x.device
    lane0 = torch.from_numpy(np.repeat(np.asarray(start, np.int64), channels)).to(dev)
    first = lane0 // M - frame0
    last = (lane0 + (count - 1) * L) // M - frame0
    if count and (int(first.min()) < 0 or int(last.max()) + taps > x.shape[1]):
        raise ValueError("the reference was not given every frame these outputs read")
    out = torch.empty((R, count), dtype=torch.float64, device=dev)
    rows = torch.arange(R, device=dev)[:, None, None]
    t = torch.arange(taps, device=dev)
    step = max(1, block // max(1, R * taps))
    for s in range(0, count, step):
        e = min(count, s + step)
        P = lane0[:, None] + torch.arange(s, e, device=dev)[None, :] * L  # [R, n]
        j = P // M - frame0
        win = x[rows, j[..., None] + t]  # [R, n, taps]
        out[:, s:e] = (win * W[P % M]).sum(dim=2)
    return out
