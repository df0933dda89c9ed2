"""FIR fleets: PyTorch ports of
``resampler_tpu.engine.fir_fleets.make_fir_fleet_step_sync_tm``
(periodic, farrow and lerp paths; the wide u32 schedule),
``make_fir_fleet_step_async_tm`` (per-stream positions, kernel B6, or B6b
for ``kernel="pallas"``; see its docstring) and the end-aligned slide
fleet ``make_fir_fleet_step_sync`` (kernel B8; see its docstring).

``n_streams`` phase-locked streams share one exact schedule.  Their
frames live in a TIME-MAJOR ring ``[ring, B*C]`` (frames on the major
axis, stream-channel lanes ``b*C + c`` on the minor one), so a step is:
one contiguous append at row ``fill``, one fleet-wide contraction, and a
consume that only advances ``start``.  Every ~``horizon`` steps the live
window is compacted to the front of the ring.  The contraction is kernel
B1 on periodic ratios (kernel B7 in four bf16 passes for
``precision="bf16x4"``, ``ops/matmul3.py``), and on coprime ones the
Farrow positioning matmul followed by kernel B2 (blocks of q >= 8 outputs)
or B3 (q < 8) (``ops/fir_dma_kernel.py``).

The schedule scalars (``start``, ``fill``, ``pos_num`` or the wide
``pos_hi``/``pos_lo``, and per step ``to_copy``, ``n_out``, ``consumed``)
are Python ints computed with the JAX package's integer formulas, and the
per-lane residues, Chebyshev or lerp coefficients and wide emission mask
come from static host tables, so a step needs no device-to-host sync.
The ring is updated IN PLACE (the JAX wrappers donate their state for the
same reason): a 1024-stream stereo fleet's ring is ~600 MB.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.fir_async_kernel import (
    async_combine,
    async_combine_plan,
    async_combine_reference,
)
from ..ops.fir_dma_kernel import (
    BandPlan,
    dma_banded_contract,
    dma_banded_contract_reference,
    dma_farrow_contract,
    dma_farrow_contract_packed,
    dma_farrow_contract_reference,
)
from ..ops.fir_kernel import FleetStepPlan, SpareBuffer
from ..ops.fir_sync_kernel import fir_fleet_step_sync
from ..ops.matmul3 import matmul3, matmul3_reference, split_weight
from ..utils import tracing
from .fir import (
    FARROW_DEGREE,
    FirConfig,
    WideSchedule,
    _compute_n_out,
    _periodic_group_factor,
    _sync_atlas,
    _table_svd_basis,
    check_window,
    combine_basis,
    farrow_block_size,
    farrow_matrix,
    lane_residues,
    resolve_convolve_path,
    resolve_device,
    resolve_path,
    stream_words,
    upload,
    zero_position,
)

__all__ = [
    "make_fir_fleet_step_sync",
    "fir_fleet_init_sync",
    "make_fir_fleet_step_sync_tm",
    "fir_fleet_init_sync_tm",
    "make_fir_fleet_step_async_tm",
    "fir_fleet_init_async_tm",
]


def make_fir_fleet_step_sync(
    config: FirConfig,
    coeffs: np.ndarray,
    n_streams: int,
    *,
    channel_major: bool = False,
    device="cuda",
):
    """Synchronized slide-fleet step (the JAX package's
    ``make_fir_fleet_step_sync``): ``n_streams`` streams in phase lockstep
    on the end-aligned buffer ``[B, C, alloc]`` of ``make_fir_step``.

    ``step(state, chunks, n_valid) -> (state', out [B, out_cap, C],
    consumed, produced)``; ``chunks`` is ``[B, n, C]``, or ``[B, C, n]``
    with ``channel_major=True``; ``state`` is ``{"buffer": [B, C, alloc],
    "available_frames", "pos_num"}`` with one shared schedule as Python
    ints.  Periodic ratios only (``ValueError`` otherwise, as in JAX).

    The step is kernel B8 (``ops/fir_sync_kernel.py``: the masked copy-in
    and the banded contraction, one step on the card, its plain version
    on the CPU).  It writes the next buffer into a second tensor and
    recycles the previous state's buffer as the one after, as
    ``make_fir_step_batched`` does."""
    if resolve_convolve_path(config) != "periodic":
        raise ValueError(
            "synchronized fleet step requires the periodic convolve path"
        )
    device = resolve_device(device)
    plan = FleetStepPlan(config, coeffs)
    spare = SpareBuffer()
    shape = (n_streams, config.channels, config.buffer_alloc)

    def step(state: dict, chunks, n_valid: int):
        chunks = torch.as_tensor(chunks, dtype=torch.float32, device=device)
        buffer = state["buffer"]
        if tuple(buffer.shape) != shape:
            raise ValueError(f"state buffer must be {list(shape)}, got {tuple(buffer.shape)}")
        buffer, out, avail, pos, to_copy, n_out = fir_fleet_step_sync(
            plan, buffer, chunks, state["available_frames"], state["pos_num"], n_valid,
            channel_major=channel_major, out_buffers=spare.swap(buffer),
        )
        return dict(buffer=buffer, available_frames=avail, pos_num=pos), out, to_copy, n_out

    return step


def fir_fleet_init_sync(config: FirConfig, n_streams: int, device="cuda") -> dict:
    """Zero slide-fleet state: ``buffer [B, C, alloc]`` f32 on ``device``,
    the shared ``available_frames`` and ``pos_num`` as Python ints."""
    return dict(
        buffer=torch.zeros(
            (n_streams, config.channels, config.buffer_alloc),
            dtype=torch.float32,
            device=resolve_device(device),
        ),
        available_frames=0,
        pos_num=0,
    )


def _farrow_tm_plan(config: FirConfig, coeffs, basis: str = "cheb") -> dict:
    """Static precompute of the fleet's Farrow contraction (the JAX
    package's ``_farrow_tm_plan`` with ``widen=0``, its XLA-form plan: the
    port's kernels read any row, so no room is reserved for the TPU's
    8-row DMA remainder).  Output ``i = k*q + l`` sits at local offset
    ``j_loc + wrap`` of block ``k``, whose ``w_blk`` rows start at
    ``block_base[k]``; ``ashift2[(d, j), s] = A[d, s - j]`` positions the
    basis rows ``A`` (Chebyshev fit, or the SVD table basis for
    ``basis="lerp"``, whose ``U`` factor the plan also returns)."""
    L, M, taps = config.ratio_num, config.ratio_den, config.taps
    N = config.out_capacity
    if basis == "lerp":
        U, A = _table_svd_basis(coeffs)  # [P, r], [r, taps]
    else:
        U, (A, _) = None, farrow_matrix(coeffs, FARROW_DEGREE)
    d1 = A.shape[0]
    q = farrow_block_size(L, M)
    K = -(-N // q)
    n_pad = K * q
    i = np.arange(N, dtype=np.int64)
    j_np = (i * L) // M
    s_np = (i * L) % M
    if config.wide:
        # lanes whose row offset exceeds the buffer can never be emitted
        j_np = np.minimum(j_np, config.input_capacity + 2)
    j_pad = np.concatenate([j_np, np.full(n_pad - N, j_np[-1], np.int64)])
    s_pad = np.concatenate([s_np, np.zeros(n_pad - N, np.int64)])
    block_base = j_pad.reshape(K, q)[:, 0]
    j_loc = (j_pad.reshape(K, q) - block_base[:, None]).astype(np.int32)
    n_jl = int(j_loc.max()) + 2  # +1 wrap carry
    w_blk = n_jl - 1 + taps
    ashift2 = np.zeros((d1 * n_jl, w_blk), np.float32)
    for d in range(d1):
        for j in range(n_jl):
            ashift2[d * n_jl + j, j : j + taps] = A[d]
    return dict(
        q=q, K=K, n_pad=n_pad, d1=d1, n_jl=n_jl, w_blk=w_blk,
        block_base=block_base.astype(np.int64),
        j_loc=j_loc, s_pad=s_pad.reshape(K, q),
        ashift2=ashift2, region_rows=int(block_base.max()) + w_blk, U=U,
    )


def farrow_weights(fp: dict, M: int, pos, ashift2: torch.Tensor) -> torch.Tensor:
    """Every output's banded weight row for the shared position ``pos``,
    ``a_blk [K, q, w_blk]`` on ``ashift2``'s device.  The host turns
    ``pos`` into per-output residues, combine coefficients (Chebyshev
    values, or lerped rows of the SVD factor) and local offsets
    ``j_loc + wrap``, uploaded without a stream sync (``upload``); on
    the device the offsets' one-hot times the
    coefficients goes through ONE positioning matmul with ``ashift2``
    (f32, TF32 off), shared by every stream of the fleet."""
    K, q, d1, n_jl = fp["K"], fp["q"], fp["d1"], fp["n_jl"]
    device = ashift2.device
    wrap, rem = lane_residues(fp["s_pad"], M, pos)  # [K, q]
    coef = upload(combine_basis(rem, M, fp["U"]), device)  # [K, q, d1]
    jl = upload(fp["j_loc"] + wrap, device)  # [K, q] in [0, n_jl)
    onehot = (jl[..., None] == torch.arange(n_jl, device=device)).to(torch.float32)
    p_mat = (coef[..., :, None] * onehot[..., None, :]).reshape(K * q, d1 * n_jl)
    return (p_mat @ ashift2).reshape(K, q, fp["w_blk"])


def _ring_rows(config: FirConfig, max_chunk: int, horizon: int) -> int:
    return -(
        -(config.input_capacity + config.read_slack + horizon * max_chunk) // 256
    ) * 256


def _split_atlas_t(a2_np: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16x4 tm fleet's weight: the atlas ``[rows, cols]`` split once
    (``split_weight``) and stored transposed, ``[cols, rows]``, so that a
    window's transpose ``[span, Mg]`` is a view with contiguous columns
    (B7's weight layout).  B7's tensor maps need a 16-byte aligned base and
    row stride, so each half is kept as 8 copies ``[8, cols, rows8]``
    shifted by 0-7 columns (``t[r][:, j] = atlas_t[:, j + r]``, zero past
    the end) with the row stride ``rows8`` padded to a multiple of 8: the
    window at column ``i0`` starts on 16 bytes in copy ``i0 % 8``
    (``_atlas_window``).  ~4 MB at 44.1 -> 48 kHz."""
    rows, cols = a2_np.shape
    rows8 = -(-rows // 8) * 8
    out = []
    for t in split_weight(torch.from_numpy(a2_np.T)):
        shifted = torch.zeros((8, cols, rows8), dtype=t.dtype)
        for r in range(8):
            shifted[r, :, : rows - r] = t[:, r:]
        out.append(shifted.to(device))
    return tuple(out)


def _atlas_window(t: torch.Tensor, c0: int, i0: int, span: int, Mg: int) -> torch.Tensor:
    """The transposed atlas window ``[c0 : c0 + span, i0 : i0 + Mg]`` of a
    ``_split_atlas_t`` half, from the copy in which it starts on 16 bytes."""
    r = i0 % 8
    return t[r, c0 : c0 + span, i0 - r : i0 - r + Mg]


def make_fir_fleet_step_sync_tm(
    config: FirConfig,
    coeffs: np.ndarray,
    n_streams: int,
    *,
    max_chunk: int,
    horizon: int = 16,
    precision: str = "highest",
    path: str = "auto",
    contraction: str = "auto",
    mesh=None,
    out_layout: str = "bm",
    device="cuda",
):
    """Time-major synchronized-fleet step.

    ``step(state, chunks_tm [n <= max_chunk, B*C] f32, n_valid) ->
    (state', out, consumed, produced)``; ``out`` is ``[B, out_cap, C]``
    for ``out_layout="bm"`` or the raw time-major ``[out_cap, B*C]`` for
    ``"tm"``.  Per-stream semantics equal ``make_fir_step``.

    ``contraction`` (the JAX package's keyword, resolved as there):

    - ``"auto"``: on a CUDA device the contraction launches a kernel (B1,
      B7, B2 or B3); on the CPU it runs that kernel's plain PyTorch
      version.
    - ``"dma"``: the f32 contraction kernel whatever ``precision`` says
      (B1 on the periodic path, B2/B3 on farrow and lerp), launched; it
      raises off a CUDA device.
    - ``"dma_interpret"``: the plain version of that f32 contraction, on
      any device (the TPU's interpret mode runs a kernel's reference).
    - ``"xla"``: the plain version of the contraction ``precision``
      selects, on any device (B1's, or B7's in four passes for
      ``"bf16x4"``; B2/B3's on farrow and lerp).

    ``mesh`` (the JAX package's stream sharding) raises
    ``NotImplementedError`` (ROADMAP A11).

    - ``path="periodic"``: small-M families (reduced M < 128) contract
      against a grouped ``(gL, gM)`` atlas whose rows are bit-identical
      to the reduced one (``_periodic_group_factor``), while the atlas
      window is still indexed with the reduced ``L, M``.  The contraction
      is B1 (f32) for ``precision="highest"``: the atlas is stored
      transposed, B1 reads each step's window in place (a strided view,
      no copy) and only the columns its ``BandPlan`` gives each tile of
      rows; for ``"bf16x4"`` the atlas
      is split once at build (``split_hi_lo``, stored transposed) and B7
      contracts each step's window of both halves with the ring window
      view in four bf16 passes (the JAX form's four products,
      ``resampler_tpu/engine/fir_fleets.py:594-617``).
    - ``path="farrow"`` / ``"lerp"`` (every ratio the periodic path does
      not take, and selectable on any): ``farrow_weights`` builds every
      output's banded weights ``a_blk [K, q, w]`` once for the whole
      fleet, and B2 (q >= 8) or B3 (q < 8) contracts them with the ring.
      ``precision`` does not apply there (the JAX package's farrow
      contractions are fixed at HIGHEST), so ``"bf16x4"`` runs B2/B3."""
    if mesh is not None:
        raise NotImplementedError("mesh sharding is not ported yet (ROADMAP A11)")
    if precision not in ("highest", "bf16x4"):
        raise ValueError(f"precision must be 'highest' or 'bf16x4', not {precision!r}")
    if contraction not in ("auto", "xla", "dma", "dma_interpret"):
        raise ValueError(
            f"contraction must be 'auto', 'xla', 'dma' or 'dma_interpret', not {contraction!r}"
        )
    if resolve_convolve_path(config, path) == "gather":
        raise ValueError(
            "synchronized tm fleet step supports the periodic, farrow and "
            "lerp convolve paths, not 'gather'"
        )
    path = resolve_path(config, path)
    if out_layout not in ("bm", "tm"):
        raise ValueError(
            f"out_layout must be 'bm' ([B, out_cap, C]) or 'tm' "
            f"(time-major [out_cap, B*C]), not {out_layout!r}"
        )
    device = resolve_device(device)
    if contraction == "dma" and device.type != "cuda":
        raise ValueError(
            f"contraction='dma' launches the CUDA kernels, and the device is {device}; "
            "use 'dma_interpret' or 'xla' for their plain versions"
        )
    # "dma" and "dma_interpret" take the f32 contraction whatever precision
    # says (the JAX package's dispatch); "xla" and the interpret mode run
    # the plain versions on any device
    if contraction in ("dma", "dma_interpret"):
        precision = "highest"
    plain = contraction in ("xla", "dma_interpret")
    L, M, taps = config.ratio_num, config.ratio_den, config.taps
    C = config.channels
    B = n_streams
    R = B * C
    cap = config.input_capacity
    out_cap = config.out_capacity
    slack = config.read_slack
    wide = WideSchedule(config) if config.wide else None

    if path == "periodic":
        g = _periodic_group_factor(L, M)
        Lg, Mg = L * g, M * g
        span = Lg + taps + 1
        K = -(-out_cap // Mg)
        n_blk = 1 + -(-(span - Lg) // Lg)
        # the contraction reads (K-1)*Lg + span <= (K+n_blk)*Lg rows from
        # base <= fill - taps; this bound keeps them inside the ring
        region_rows = (K + n_blk) * Lg
        atlas_cfg = (
            dataclasses.replace(config, ratio_num=Lg, ratio_den=Mg) if g > 1 else config
        )
        a2_np = _sync_atlas(atlas_cfg, coeffs)
        l_inv = pow(L, -1, M) if M > 1 else 0
        if precision == "bf16x4":
            t_hi, t_lo = _split_atlas_t(a2_np, device)
        else:
            # [cols, rows]: a window's transpose is a view whose rows (the
            # band columns) are contiguous, read coalesced by B1
            a2_t = torch.from_numpy(np.ascontiguousarray(a2_np.T)).to(device)
            band_plan = BandPlan(Lg, Mg, taps)

        def contract(buffer, start: int, pos_num: int, avail: int):
            d_min, r = divmod(pos_num, M)
            i0 = (r * l_inv) % M
            c0 = (i0 * L) // M
            base = start + d_min
            if precision == "bf16x4":
                check_window(base, (K - 1) * Lg + span, buffer.shape[0], "contraction window")
                # the overlapping window [K, R, span] and the time-major
                # output [K, Mg, R] written as [K, R, Mg]: views, no copies
                x = buffer[base:].as_strided((K, R, span), (Lg * R, 1, R))
                out = buffer.new_empty((K, Mg, R))
                (matmul3_reference if plain else matmul3)(
                    x, _atlas_window(t_hi, c0, i0, span, Mg), _atlas_window(t_lo, c0, i0, span, Mg),
                    passes=4, out=out.permute(0, 2, 1))
            else:
                a = a2_t[c0 : c0 + span, i0 : i0 + Mg].T  # [Mg, span] view
                geo = dict(L=Lg, M=Mg, span=span, K=K)
                if plain:
                    out = dma_banded_contract_reference(buffer, base, a, **geo)
                else:
                    out = dma_banded_contract(buffer, base, a, band=(band_plan, i0), **geo)  # [K, Mg, R]
            return out.reshape(K * Mg, R)[:out_cap]

    else:
        fp = _farrow_tm_plan(config, coeffs, basis="lerp" if path == "lerp" else "cheb")
        region_rows = fp["region_rows"]
        ashift2 = torch.from_numpy(fp["ashift2"]).to(device)  # [d1*n_jl, w_blk]
        if plain:
            kernel = dma_farrow_contract_reference
        else:
            kernel = dma_farrow_contract if fp["q"] >= 8 else dma_farrow_contract_packed

        def contract(buffer, start: int, pos, avail: int):
            # the wide base is clamped to the buffered frames, the narrow
            # one is not (as in the JAX package); both are < avail on an
            # emitting step, the only steps that contract
            base = min(pos[0], avail) if wide else pos // M
            a_blk = farrow_weights(fp, M, pos, ashift2)
            out = kernel(buffer, start + base, a_blk, fp["block_base"])  # [K, q, R]
            return out.reshape(fp["n_pad"], R)[:out_cap]

    assert region_rows <= slack, (region_rows, slack)

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
        start, fill = state["start"], state["fill"]
        pos = (state["pos_hi"], state["pos_lo"]) if wide else state["pos_num"]
        avail = fill - start

        # ---- append: only the to_copy valid rows are written.  That is
        # the NaN fence: the contraction reads rows past fill against the
        # weights' structural zeros, and 0 * NaN = NaN.  Rows at or past
        # fill are always zero (init, this append, the compaction's zero
        # tail), as in the JAX ring, whose fixed-shape update writes the
        # masked rows as zeros ----
        to_copy = min(n_valid, cap - avail)
        check_window(fill, n_in, buffer.shape[0], "ring append")
        with tracing.span("fir.append"):
            buffer[fill : fill + to_copy] = chunks_tm[:to_copy]
        fill += to_copy
        avail += to_copy

        # ---- shared schedule; the wide one counts its emission mask ----
        with tracing.span("fir.schedule"):
            if wide:
                n_out = min(wide.emitted(*pos, avail), out_cap)
            else:
                n_out = _compute_n_out(config, pos, avail, out_cap)

        # ---- fleet-wide contraction; a step that emits nothing skips it
        # (all its lanes are masked, and heavy downsampling carries pos
        # past the buffered frames there) ----
        if n_out:
            with tracing.span("fir.contract"):
                out = contract(buffer, start, pos, avail)
            with tracing.span("fir.mask"):
                out[n_out:] = 0.0
        else:
            with tracing.span("fir.mask"):
                out = buffer.new_zeros((out_cap, R))
        if out_layout == "bm":
            with tracing.span("fir.relayout_out"):
                out = out.reshape(out_cap, B, C).permute(1, 0, 2).contiguous()

        # ---- consume: advance start, no data movement ----
        with tracing.span("fir.schedule"):
            if wide:
                consumed, hi, lo = wide.advance(*pos, n_out, avail)
                pos_state = dict(pos_hi=hi, pos_lo=lo)
            else:
                pos_after = pos + n_out * L
                consumed = min(pos_after // M, avail)
                pos_state = dict(pos_num=pos_after - consumed * M)
        start, fill = _compact(buffer, start + consumed, fill, cap, max_chunk, slack)

        new_state = dict(buffer=buffer, start=start, fill=fill, **pos_state)
        return new_state, out, to_copy, n_out

    return step


def _compact(buffer, start: int, fill: int, cap: int, max_chunk: int, slack: int):
    """The amortized compaction: when the next append could pass the ring,
    the live window moves to the front (cloned first: the source overlaps
    the destination).  Returns ``(start, fill)``."""
    ring = buffer.shape[0]
    if fill + max_chunk + slack > ring:
        ws = min(start, ring - cap)
        with tracing.span("fir.compact"):
            buffer[:cap] = buffer[ws : ws + cap].clone()
            buffer[cap:] = 0.0
        tracing.count("fir.compactions")
        start -= ws
        fill -= ws
    return start, fill


def make_fir_fleet_step_async_tm(
    config: FirConfig,
    coeffs: np.ndarray,
    n_streams: int,
    *,
    max_chunk: int,
    horizon: int = 16,
    skew_periods: int = 1,
    out_layout: str = "bm",
    max_out: int | None = None,
    kernel: str = "auto",
    mesh=None,
    device="cuda",
):
    """Time-major ASYNCHRONOUS fleet step (the JAX package's
    ``make_fir_fleet_step_async_tm``): the streams share the rate pair, the
    ring and the chunk cadence, but each keeps its own exact position
    (join phase, per-stream drift slew).

    Per step only two numbers per stream diverge, the frame skew
    ``base_rel`` and the subframe residue ``r`` (``pos_lo`` when wide), so
    the schedule stays on the host in ``[B]`` numpy: ``n_out`` from the
    laggard (``max(pos)``; wide: the lexicographic laggard's emission
    mask), the shared frame ``b0 = min(min(pos) // M, avail)``, and the
    consume by ``min(pos_after)``.  The device gets one ``[2, R]`` lane
    upload (residue, skew) through pinned memory, the append, kernel B6
    (``ops/fir_async_kernel.py``) with the ``n_out`` mask, and the output
    relayout; no device-to-host sync.

    ``kernel``: ``"auto"`` and ``"pallas_highest"`` launch B6 on the card
    (its plain version on the CPU); ``"pallas"`` launches B6b, the TPU
    default's bf16x4 degree-banded split contraction (its plain version on
    the CPU); ``"xla"`` runs B6's plain version on any device (the
    differential).  ``"pallas_interpret"`` is a TPU-only mode.

    ``max_out`` bounds the output lanes per step below
    ``config.out_capacity``; production beyond it is deferred, never
    dropped.  **Skew invariant**: ``max(pos) - min(pos) < skew_periods *
    M`` (``fir_fleet_init_async_tm`` checks it; the step preserves the
    spread).

    ``step(state, chunks_tm [n <= max_chunk, B*C], n_valid) -> (state',
    out, consumed, produced)``, ``out`` ``[B, out_cap, C]`` ("bm") or
    ``[out_cap, B*C]`` ("tm"); every stream produces ``produced``."""
    if mesh is not None:
        raise NotImplementedError("mesh sharding is not ported yet (ROADMAP A11)")
    if out_layout not in ("bm", "tm"):
        raise ValueError(
            f"out_layout must be 'bm' ([B, out_cap, C]) or 'tm' "
            f"(time-major [out_cap, B*C]), not {out_layout!r}"
        )
    if skew_periods < 1:
        raise ValueError("skew_periods must be >= 1")
    if kernel not in ("auto", "xla", "pallas", "pallas_highest"):
        raise ValueError(
            f"kernel must be 'auto', 'xla', 'pallas' or 'pallas_highest' "
            f"('pallas_interpret' is a TPU mode), not {kernel!r}"
        )
    combine = async_combine_reference if kernel == "xla" else async_combine
    device = resolve_device(device)
    L, M, taps = config.ratio_num, config.ratio_den, config.taps
    C = config.channels
    B = n_streams
    R = B * C
    cap = config.input_capacity
    out_cap = config.out_capacity
    if max_out is not None:
        out_cap = min(out_cap, max(int(max_out), 1))
    slack = config.read_slack
    wide = WideSchedule(config, out_cap) if config.wide else None
    A, _ = farrow_matrix(coeffs, FARROW_DEGREE)
    plan = async_combine_plan(
        A=A, L=L, M=M, out_cap=out_cap, skew_periods=skew_periods,
        clamp_j=cap + 2 if wide else None,
        precision="bf16x4" if kernel == "pallas" else "highest",
    )
    assert plan.reach <= slack, (plan.reach, slack)

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
        start, fill = state["start"], state["fill"]
        avail = fill - start

        # ---- append, with the NaN fence of the sync fleet ----
        to_copy = min(n_valid, cap - avail)
        check_window(fill, n_in, buffer.shape[0], "ring append")
        with tracing.span("fir.append"):
            buffer[fill : fill + to_copy] = chunks_tm[:to_copy]
        fill += to_copy
        avail += to_copy

        # ---- the per-stream schedule, [B] numpy on the host ----
        with tracing.span("fir.schedule"):
            if wide:
                pos_hi = stream_words(state["pos_hi"], B, "pos_hi")
                pos_lo = stream_words(state["pos_lo"], B, "pos_lo")
                mx_hi = int(pos_hi.max())
                mx_lo = int(pos_lo[pos_hi == mx_hi].max())
                n_out = min(wide.emitted(mx_hi, mx_lo, avail), out_cap)
                b0 = min(int(pos_hi.min()), avail)
                base_rel, res = pos_hi - b0, pos_lo
            else:
                pos = stream_words(state["pos_num"], B, "pos_num")
                n_out = _compute_n_out(config, int(pos.max()), avail, out_cap)
                b0 = min(int(pos.min()) // M, avail)
                base_rel, res = np.divmod(pos - b0 * M, M)

        # the lanes' upload and the kernel (its mask included)
        with tracing.span("fir.contract"):
            lanes = upload(np.stack([np.repeat(res, C), np.repeat(base_rel, C)]), device)
            out = combine(buffer, start + b0, n_out, lanes, plan)  # [out_cap, R], masked
        if out_layout == "bm":
            with tracing.span("fir.relayout_out"):
                out = out.reshape(out_cap, B, C).permute(1, 0, 2).contiguous()

        # ---- consume: the shared scalar, the per-stream rest into pos ----
        with tracing.span("fir.schedule"):
            if wide:
                consumed, hi, lo = wide.advance(pos_hi, pos_lo, n_out, avail)
                pos_state = dict(pos_hi=hi, pos_lo=lo)
            else:
                pos_after = pos + n_out * L
                consumed = min(int(pos_after.min()) // M, avail)
                pos_state = dict(pos_num=pos_after - consumed * M)
        start, fill = _compact(buffer, start + consumed, fill, cap, max_chunk, slack)

        new_state = dict(buffer=buffer, start=start, fill=fill, **pos_state)
        return new_state, out, to_copy, n_out

    return step


def fir_fleet_init_async_tm(
    config: FirConfig,
    n_streams: int,
    *,
    max_chunk: int,
    horizon: int = 16,
    pos_num=None,
    skew_periods: int = 1,
    device="cuda",
) -> dict:
    """Zero async fleet state: the ring as in ``fir_fleet_init_sync_tm``
    and per-stream positions, ``[B]`` int64 numpy: ``pos_num``, or the
    wide words ``pos_hi`` / ``pos_lo``.  ``pos_num`` (optional, ``[B]``
    exact ints, in 1/M input frames) sets the initial positions; the skew
    invariant ``max - min < skew_periods * M`` is checked here."""
    M = config.ratio_den
    if pos_num is None:
        pos = [0] * n_streams
    else:
        pos = [int(p) for p in np.asarray(pos_num).reshape(-1)]
        if len(pos) != n_streams:
            raise ValueError(
                f"pos_num must have shape ({n_streams},), got ({len(pos)},)"
            )
        if min(pos) < 0:
            raise ValueError("initial positions must be non-negative")
        if max(pos) - min(pos) >= skew_periods * M:
            raise ValueError(
                f"position spread {max(pos) - min(pos)} violates the skew "
                f"invariant (< skew_periods*M = {skew_periods * M}); widen "
                "skew_periods or use the vmapped engine"
            )
    state = fir_fleet_init_sync_tm(
        config, n_streams, max_chunk=max_chunk, horizon=horizon, device=device
    )
    if config.wide:
        state.update(
            pos_hi=np.asarray([p // M for p in pos], np.int64),
            pos_lo=np.asarray([p % M for p in pos], np.int64),
        )
    else:
        state.update(pos_num=np.asarray(pos, np.int64))
    return state


def fir_fleet_init_sync_tm(
    config: FirConfig,
    n_streams: int,
    *,
    max_chunk: int,
    horizon: int = 16,
    device="cuda",
) -> dict:
    """Zero fleet state: ring ``buffer [ring, B*C]`` f32 on ``device``;
    ``start``, ``fill`` and the position (``pos_num``, or ``pos_hi`` /
    ``pos_lo`` when wide) as Python ints."""
    return dict(
        buffer=torch.zeros(
            (_ring_rows(config, max_chunk, horizon), n_streams * config.channels),
            dtype=torch.float32,
            device=resolve_device(device),
        ),
        start=0,
        fill=0,
        **zero_position(config),
    )
