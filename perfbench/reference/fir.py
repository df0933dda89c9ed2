"""Plain reference of the polyphase FIR resampler, from its published
description (hasenbanck/resampler, src/resampler_fir.rs and src/window.rs).

Nothing here comes from the program: the filter is designed again from the
configuration in float64, the schedule follows the crate's streaming loop,
and every output is a direct sum over its taps.

Semantics of one stream, frames counted per channel from the stream's first
input frame: output ``i`` sits at input position ``i * L / M`` (``L/M`` the
reduced rate ratio), ``j = (i*L) // M`` and ``rho = (i*L) % M``, and

    y[i] = sum_t W[rho, t] * x[j + t]        (t < taps)

where ``W[rho]`` blends the two polyphase branches around ``rho * P / M``
(``P`` branches) linearly.  An output is emitted once its window lies inside
the frames received: ``j + taps <= frames``.
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import tf32_round


def kaiser_cutoff(taps: int, beta: float) -> float:
    """Kaiser transition-width cutoff (a fraction of Nyquist) with the
    crate's 0.5% margin, clamped to [0.7, 1]."""
    a_db = beta / 0.1102 + 8.7
    cutoff = 1.0 - (a_db - 7.95) / (14.36 * taps) * 1.005
    return min(max(cutoff, 0.7), 1.0)


def polyphase_table(taps: int, phases: int, beta: float, ratio: float) -> np.ndarray:
    """``[phases, taps]`` float64 branches of one windowed sinc of ``taps *
    phases`` points (symmetric Kaiser window), each branch summing to ~1.
    Branch ``p`` takes the prototype's points ``t * phases + (phases - 1 -
    p)``.  Downsampling scales the cutoff by the rate ratio."""
    cutoff = kaiser_cutoff(taps, beta)
    if ratio > 1.0:
        cutoff = cutoff / ratio
    cutoff = float(np.float32(cutoff))  # the crate designs at an f32 cutoff
    n = taps * phases
    window = np.kaiser(n, beta)
    x = (np.arange(n, dtype=np.float64) - n // 2) * (cutoff / phases)
    proto = window * np.sinc(x)
    proto /= proto.sum() / phases
    return proto.reshape(taps, phases).T[::-1].copy()


def phase_weights(config: dict) -> tuple[np.ndarray, int, int]:
    """``(W [M, taps] float64, L, M)``: the blended row of every residue."""
    L, M = reduced_ratio(config["input_rate"], config["output_rate"])
    P, taps = config["phases"], config["taps"]
    table = polyphase_table(taps, P, config["kaiser_beta"],
                            config["input_rate"] / config["output_rate"])
    rho = np.arange(M, dtype=np.int64)
    p1 = rho * P // M
    frac = (rho * P - p1 * M) / M
    p2 = np.minimum(p1 + 1, P - 1)
    return (1.0 - frac)[:, None] * table[p1] + frac[:, None] * table[p2], L, M


def reduced_ratio(a: int, b: int) -> tuple[int, int]:
    g = int(np.gcd(a, b))
    return a // g, b // g


class Schedule:
    """The crate's streaming schedule for one stream, step by step:
    ``feed(n_valid)`` takes the frames offered, returns ``(taken,
    emitted)``.  The buffer holds at most ``capacity`` frames; a step emits
    every output whose window is complete, at most ``out_cap``; then it
    drops the frames that no later output needs.  Works on int64 arrays
    (one entry per stream) or on Python ints."""

    def __init__(self, L: int, M: int, taps: int, capacity: int, out_cap: int, n: int = 1):
        self.L, self.M, self.taps, self.capacity, self.out_cap = L, M, taps, capacity, out_cap
        self.avail = np.zeros(n, np.int64)
        self.pos = np.zeros(n, np.int64)  # in 1/M frames, from the buffer's first frame

    def feed(self, n_valid):
        L, M = self.L, self.M
        taken = np.minimum(np.asarray(n_valid, np.int64), self.capacity - self.avail)
        self.avail = self.avail + taken
        # outputs k with pos + k*L + taps*M <= avail*M, i.e. pos + k*L < (avail - taps + 1)*M
        room = (self.avail - self.taps + 1) * M - self.pos
        emitted = np.clip(-(-room // L), 0, self.out_cap)
        after = self.pos + emitted * L
        dropped = np.minimum(after // M, self.avail)
        self.avail = self.avail - dropped
        self.pos = after - dropped * M
        return taken, emitted


def out_capacity(config: dict) -> int:
    """Most outputs one step may emit: a full buffer's worth, plus two."""
    L, M = reduced_ratio(config["input_rate"], config["output_rate"])
    usable = config["input_capacity"] - config["taps"]
    return -(-usable * M // L) + 2


def outputs(x: torch.Tensor, frame0: int, first: int, count: int, W: torch.Tensor,
            L: int, M: int, control: bool = False, block: int = 1 << 22) -> torch.Tensor:
    """Outputs ``first .. first+count`` of the lanes in ``x [R, frames]``
    (float64; its column 0 is the stream's frame ``frame0``), as ``[R,
    count]`` float64.  ``control`` rounds samples and weights to TF32 first:
    the products a TF32 tensor core would form, summed exactly."""
    R = x.shape[0]
    taps = W.shape[1]
    if control:
        x, W = tf32_round(x), tf32_round(W)
    dev = x.device
    idx = torch.arange(first, first + count, dtype=torch.int64, device=dev)
    j = idx * L // M - frame0
    rho = idx * L % M
    if count and (int(j[0]) < 0 or int(j[-1]) + taps > x.shape[1]):
        raise ValueError("the reference was not given every frame these outputs read")
    out = torch.empty((R, count), dtype=torch.float64, device=dev)
    step = max(1, block // max(1, R * taps))
    t = torch.arange(taps, device=dev)
    for s in range(0, count, step):
        e = min(count, s + step)
        cols = j[s:e, None] + t[None, :]  # [n, taps]
        win = x[:, cols]  # [R, n, taps]
        out[:, s:e] = (win * W[rho[s:e]][None]).sum(dim=2)
    return out
