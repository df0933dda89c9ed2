"""Plain reference of the phase-locked FIR fleet at a rate pair whose
reduced ``L/M`` lies past the int32 envelope (the program's wide two-word
schedule), as a clock-domain bridge that states its rates in millihertz
needs: 48,000,000 -> 48,000,066 mHz reduces to 8,000,000 / 8,000,011.

Nothing here comes from the program: the filter is designed again in
float64 (``fir.polyphase_table``), the schedule is ``fir.Schedule`` in
exact integers, and every output is a direct sum over its taps.

The semantics are ``fir.py``'s: output ``i`` of a stream sits at ``i*L``
1/M frames, ``j = (i*L) // M``, ``rho = (i*L) % M`` and ``y[i] = sum_t
W[rho, t] * x[j + t]``.  The rows are ``fir_async.phase_weights``': the
two polyphase branches around ``rho * P / M`` blended linearly, continued
past the last branch to the prototype's next point (branch 0 one tap
later), the one departure from the crate that ``fir_async.py`` states.
There the whole table ``[M, taps]`` would take 8.2 GB at M 8,000,011,
so a row is formed only for the residues of the outputs compared, in
blocks of outputs, by the same float64 operations in the same order:
``rows`` equals ``phase_weights``' rows bit for bit (the CPU tests hold
them equal at 44100 -> 44101 Hz).
"""

from __future__ import annotations

import numpy as np
import torch

from .fir import polyphase_table, reduced_ratio
from .precision import tf32_round


def branches(config: dict) -> tuple[np.ndarray, int, int]:
    """``(ext [P + 1, taps] float64, L, M)``: the ``P`` polyphase branches
    and, as branch ``P``, the prototype's next point (branch 0 one tap
    later, 0 before the prototype's first point)."""
    L, M = reduced_ratio(config["input_rate"], config["output_rate"])
    P = config["phases"]
    table = polyphase_table(config["taps"], P, config["kaiser_beta"],
                            config["input_rate"] / config["output_rate"])
    after = np.concatenate([[0.0], table[0, :-1]])
    return np.concatenate([table, after[None]]), L, M


def rows(ext: np.ndarray, rho: np.ndarray, M: int) -> np.ndarray:
    """``[n, taps]`` float64: the blended row of each residue in ``rho``
    (int64, each in ``[0, M)``)."""
    P = ext.shape[0] - 1
    rho = np.asarray(rho, np.int64)
    p1 = rho * P // M
    frac = (rho * P - p1 * M) / M
    return (1.0 - frac)[:, None] * ext[p1] + frac[:, None] * ext[p1 + 1]


def outputs(x: torch.Tensor, frame0: int, first: int, count: int, ext: np.ndarray,
            L: int, M: int, control: bool = False, block: int = 1 << 22) -> torch.Tensor:
    """Outputs ``first .. first+count`` of the lanes in ``x [R, frames]``
    (float64; its column 0 is the stream's frame ``frame0``), as ``[R,
    count]`` float64, each row formed from its residue as the block that
    holds it is summed.  ``control`` rounds samples and rows to TF32 first:
    the products a TF32 tensor core would form, summed exactly."""
    R = x.shape[0]
    taps = ext.shape[1]
    if control:
        x = tf32_round(x)
    dev = x.device
    idx = np.arange(first, first + count, dtype=np.int64)
    j = idx * L // M - frame0
    rho = idx * L % M
    if count and (int(j[0]) < 0 or int(j[-1]) + taps > x.shape[1]):
        raise ValueError("the reference was not given every frame these outputs read")
    out = torch.empty((R, count), dtype=torch.float64, device=dev)
    step = max(1, block // max(1, R * taps))
    t = torch.arange(taps, device=dev)
    for s in range(0, count, step):
        e = min(count, s + step)
        W = torch.from_numpy(rows(ext, rho[s:e], M)).to(dev)  # [n, taps]
        if control:
            W = tf32_round(W)
        cols = torch.from_numpy(j[s:e]).to(dev)[:, None] + t[None, :]  # [n, taps]
        out[:, s:e] = (x[:, cols] * W[None]).sum(dim=2)
    return out
