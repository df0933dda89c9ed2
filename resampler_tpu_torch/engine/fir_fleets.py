"""Synchronized time-major FIR fleet: PyTorch port of the periodic branch
of ``resampler_tpu.engine.fir_fleets.make_fir_fleet_step_sync_tm``.

``n_streams`` phase-locked streams share one exact schedule.  Their
frames live in a TIME-MAJOR ring ``[ring, B*C]`` (frames on the major
axis, stream-channel lanes ``b*C + c`` on the minor one), so a step is:
one contiguous append at row ``fill``, one fleet-wide banded contraction
(kernel B1, ``ops/fir_dma_kernel.py``), and a consume that only advances
``start``.  Every ~``horizon`` steps the live window is compacted to the
front of the ring.

The schedule scalars (``start``, ``fill``, ``pos_num``, and per step
``to_copy``, ``n_out``, ``consumed``) are Python ints computed with the
JAX package's integer formulas, so a step needs no device-to-host sync.
The ring is updated IN PLACE (the JAX wrappers donate their state for the
same reason): a 1024-stream stereo fleet's ring is ~600 MB.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.fir_dma_kernel import dma_banded_contract
from .fir import (
    FirConfig,
    _compute_n_out,
    _periodic_group_factor,
    check_window,
    require_periodic,
    resolve_device,
)

__all__ = ["make_fir_fleet_step_sync_tm", "fir_fleet_init_sync_tm"]


def _sync_atlas(config: FirConfig, coeffs) -> np.ndarray:
    """Doubled banded-kernel atlas ``[2M, 2L + taps + 1]``:
    ``A2[i, s] = W[(i*L) % M][s - (i*L)//M]`` with ``W[rho]`` the table
    row blended for residue ``rho`` (numpy, same arithmetic as the JAX
    package's ``_sync_atlas``)."""
    L, M, taps = config.ratio_num, config.ratio_den, config.taps
    table = np.asarray(coeffs, np.float32)
    rho = np.arange(M, dtype=np.int64)
    pf = rho * config.phases
    p1 = pf // M
    p2 = np.minimum(p1 + 1, config.phases - 1)
    frac = ((pf - p1 * M) / M).astype(np.float32)[:, None]
    w_resid = (1.0 - frac) * table[p1] + frac * table[p2]
    i = np.arange(2 * M, dtype=np.int64)
    a2 = np.zeros((2 * M, 2 * L + taps + 1), np.float32)
    for ii in range(2 * M):
        off = int((i[ii] * L) // M)
        a2[ii, off : off + taps] = w_resid[int((i[ii] * L) % M)]
    return a2


def _ring_rows(config: FirConfig, max_chunk: int, horizon: int) -> int:
    return -(
        -(config.input_capacity + config.read_slack + horizon * max_chunk) // 256
    ) * 256


def make_fir_fleet_step_sync_tm(
    config: FirConfig,
    coeffs: np.ndarray,
    n_streams: int,
    *,
    max_chunk: int,
    horizon: int = 16,
    precision: str = "highest",
    path: str = "auto",
    out_layout: str = "bm",
    device="cpu",
):
    """Time-major synchronized-fleet step (periodic ratios).

    ``step(state, chunks_tm [n <= max_chunk, B*C] f32, n_valid) ->
    (state', out, consumed, produced)``; ``out`` is ``[B, out_cap, C]``
    for ``out_layout="bm"`` or the raw time-major ``[out_cap, B*C]`` for
    ``"tm"``.  Per-stream semantics equal ``make_fir_step``.

    On a CUDA device the contraction always launches kernel B1; on the
    CPU it runs B1's plain PyTorch version.  Small-M families (reduced
    M < 128) contract against a grouped ``(gL, gM)`` atlas whose rows are
    bit-identical to the reduced one (``_periodic_group_factor``), while
    the atlas window is still indexed with the reduced ``L, M``."""
    if precision == "bf16x4":
        raise NotImplementedError(
            "precision='bf16x4' needs the split_hi_lo port (ROADMAP B7)"
        )
    if precision != "highest":
        raise ValueError(f"precision must be 'highest', not {precision!r}")
    require_periodic(config, path)
    if out_layout not in ("bm", "tm"):
        raise ValueError(
            f"out_layout must be 'bm' ([B, out_cap, C]) or 'tm' "
            f"(time-major [out_cap, B*C]), not {out_layout!r}"
        )
    device = resolve_device(device)
    L, M, taps = config.ratio_num, config.ratio_den, config.taps
    C = config.channels
    B = n_streams
    R = B * C
    cap = config.input_capacity
    out_cap = config.out_capacity
    slack = config.read_slack
    ring = _ring_rows(config, max_chunk, horizon)

    g = _periodic_group_factor(L, M)
    Lg, Mg = L * g, M * g
    span = Lg + taps + 1
    K = -(-out_cap // Mg)
    n_blk = 1 + -(-(span - Lg) // Lg)
    # the contraction reads (K-1)*Lg + span <= (K+n_blk)*Lg rows from
    # base <= fill - taps; this bound keeps them inside the ring
    assert (K + n_blk) * Lg <= slack, ((K + n_blk) * Lg, slack)
    atlas_cfg = (
        dataclasses.replace(config, ratio_num=Lg, ratio_den=Mg) if g > 1 else config
    )
    a2 = torch.from_numpy(_sync_atlas(atlas_cfg, coeffs)).to(device)
    l_inv = pow(L, -1, M) if M > 1 else 0

    def contract(buffer, start: int, pos_num: int):
        d_min, r = divmod(pos_num, M)
        i0 = (r * l_inv) % M
        c0 = (i0 * L) // M
        a = a2[i0 : i0 + Mg, c0 : c0 + span].contiguous()
        out = dma_banded_contract(
            buffer, start + d_min, a, L=Lg, M=Mg, span=span, K=K
        )  # [K, Mg, R]
        return out.reshape(K * Mg, R)[:out_cap]

    def step(state: dict, chunks_tm, n_valid: int):
        chunks_tm = torch.as_tensor(chunks_tm, dtype=torch.float32, device=device)
        n_in = chunks_tm.shape[0]
        if chunks_tm.shape != (n_in, R) or n_in > max_chunk:
            raise ValueError(
                f"chunks must be [n <= {max_chunk}, {R}], got "
                f"{tuple(chunks_tm.shape)}"
            )
        if n_valid < 0:
            raise ValueError(f"n_valid must be >= 0, got {n_valid}")
        n_valid = min(int(n_valid), n_in)

        buffer = state["buffer"]
        start, fill, pos = state["start"], state["fill"], state["pos_num"]
        avail = fill - start

        # ---- append: only the to_copy valid rows are written.  That is
        # the NaN fence: the contraction reads rows past fill against the
        # atlas's structural zeros, and 0 * NaN = NaN.  Rows at or past
        # fill are always zero (init, this append, the compaction's zero
        # tail), as in the JAX ring, whose fixed-shape update writes the
        # masked rows as zeros ----
        to_copy = min(n_valid, cap - avail)
        check_window(fill, n_in, buffer.shape[0], "ring append")
        buffer[fill : fill + to_copy] = chunks_tm[:to_copy]
        fill += to_copy
        avail += to_copy

        # ---- shared schedule ----
        n_out = _compute_n_out(config, pos, avail, out_cap)

        # ---- fleet-wide contraction; a step that emits nothing skips it
        # (all its lanes are masked) ----
        if n_out:
            out = contract(buffer, start, pos)
            out[n_out:] = 0.0
        else:
            out = buffer.new_zeros((out_cap, R))
        if out_layout == "bm":
            out = out.reshape(out_cap, B, C).permute(1, 0, 2).contiguous()

        # ---- consume: advance start, no data movement ----
        pos_after = pos + n_out * L
        consumed = min(pos_after // M, avail)
        start += consumed
        pos = pos_after - consumed * M

        # ---- amortized compaction: the live window moves to the front;
        # the source overlaps the destination, so it is cloned first ----
        if fill + max_chunk + slack > ring:
            ws = min(start, ring - cap)
            buffer[:cap] = buffer[ws : ws + cap].clone()
            buffer[cap:] = 0.0
            start -= ws
            fill -= ws

        new_state = dict(buffer=buffer, start=start, fill=fill, pos_num=pos)
        return new_state, out, to_copy, n_out

    return step


def fir_fleet_init_sync_tm(
    config: FirConfig,
    n_streams: int,
    *,
    max_chunk: int,
    horizon: int = 16,
    device="cpu",
) -> dict:
    """Zero fleet state: ring ``buffer [ring, B*C]`` f32 on ``device``;
    ``start``, ``fill``, ``pos_num`` Python ints."""
    if config.wide:
        raise NotImplementedError(
            "the wide u32 schedule is not ported yet (ROADMAP A5)"
        )
    return dict(
        buffer=torch.zeros(
            (_ring_rows(config, max_chunk, horizon), n_streams * config.channels),
            dtype=torch.float32,
            device=resolve_device(device),
        ),
        start=0,
        fill=0,
        pos_num=0,
    )
