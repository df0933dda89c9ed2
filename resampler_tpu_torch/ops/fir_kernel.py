"""Kernel B9: the fused per-stream step of the vmapped FIR fleet.

Port of ``resampler_tpu/ops/fir_kernel.py:116 make_fir_fleet_step_pallas``:
``vmap(make_fir_step)`` on the periodic path, every stream with its own
``avail``, ``pos_num``, ``n_valid`` and ``budget``::

    (buffers [B, C, alloc], chunks [B, n_in, C], avail, pos_num, n_valid, budget [B])
    -> (buffers', out [B, out_cap, C], avail', pos_num', consumed, produced [B])

Per stream ``b``, with ``to_copy = min(n_valid, valid_end - avail)`` and
``new = [old[to_copy:valid_end] | chunk[:to_copy] | 0]`` (the end-aligned
copy-in; frames past ``to_copy`` are never read, the NaN fence)::

    out[i, c] = sum_{t < taps} W[rem_i, t] * new[c, base + off_i + t]    i < n_out, else 0

with ``off_i, rem_i = divmod(r + i*L, M)``, ``d_min, r = divmod(pos_num,
M)``, ``base = valid_end - (avail + to_copy) + d_min`` and ``W = phase_rows``
the blended phase rows; then the exact consume.  It equals the JAX
step's banded-atlas contraction ``A(r)[j, s] = W[..][s - d_j]``: the
atlas adds only structural zeros.

- ``FleetStepPlan`` holds the static tables (``W`` and ``W`` transposed
  for the kernel, the doubled atlas for the plain version) and the band
  tile (``BandTile``).
- The schedule (``to_copy``, ``n_out``, ``base``, ``r`` and the consume)
  is whole-fleet numpy on the host (``engine.fir.stream_schedule``), so
  a step never waits on the device.
- ``fir_fleet_step`` launches the CUDA kernel
  (``csrc/fir_fleet_step.cu``) for CUDA tensors, counted once per step in
  ``LAUNCHES``; ``fir_fleet_step_reference``, the plain PyTorch version
  (the JAX XLA step's form: the slide, then each stream's atlas window
  against the stride-``L`` windows of its region), runs for CPU tensors.
  There is no fallback between the two.

The kernel has two forms, picked by a shape rule alone (``plan.form``):

- ``"band"``: two launches, the copy-in, then the atlas cut into narrow
  bands.  Output ``i`` of stream ``b`` is the atlas's canonical ``q = i0 +
  i`` (``i0 = r L^-1 mod M``); a thread keeps ``R = min(8, M)``
  consecutive ``q`` of one row ``(b, c)`` in registers against a band of
  the phase rows ``taps + delta`` wide, the 32 lanes of a warp take 32
  rows at one ``q`` (so they share the band), and a block of 8 warps
  stages its bands and its rows' windows of the new buffer in shared
  memory (``BandTile`` holds the index map);
- ``"thread"``: one launch, one output per thread, each output's
  taps-wide dot with its phase row read from global memory; only where
  the band tile's shared memory would pass 227 KB (heavy downsampling).

The kernel writes the next buffer into ``out_buffers``, a second
``[B, C, alloc]`` tensor: written in place, one block's slide would land
on columns another block still reads.  Both buffers' columns past
``valid_end`` are zero in every state and are neither read nor written.
What does not carry over from the TPU kernel: its six Mosaic workarounds
(rolls at power-of-two widths, the 8-row aligned atlas load, the static
im2col rolls), the ``+8`` rows and power-of-two width of its atlas, and
the atlas's zero band, which the bands skip.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..engine.fir import (
    FirConfig,
    _sync_atlas,
    phase_rows,
    slide_in,
    stream_consume,
    stream_schedule,
    stream_words,
    upload,
)
from ..utils import tracing
from ._build import LAUNCHES, SMEM_MAX, device_kind, launch

__all__ = [
    "FleetStepPlan",
    "SpareBuffer",
    "fir_fleet_step",
    "fir_fleet_step_reference",
]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

#: the band tile: outputs per thread (``min(8, M)``), warps per block,
#: rows ``(b, c)`` per group (one per lane) and the row groups one block
#: contracts in turn (its bands are staged once for both)
TILE_R, TILE_WARPS, TILE_ROWS, TILE_GROUPS = 8, 8, 32, 2


class BandTile:
    """The band form's tile for one configuration: a thread computes ``R``
    consecutive canonical outputs ``q0 .. q0 + R - 1`` of one row ``(b,
    c)``, the 32 lanes of a warp take 32 rows at the same ``q0``, and the
    ``warps`` warps of a block take consecutive runs of ``R``, so a block
    covers ``q_tile = warps * R`` canonical outputs of a group of 32 rows,
    for ``groups`` groups in turn.

    With ``d(q) = floor(q L / M)`` (``d(q + M) = d(q) + L``), everything of
    a tile but its rows' read starts depends on its first ``q`` mod ``M``
    alone.  Tables, per start phase ``ph`` in ``[0, M)``:

    - ``d_tab [M]``: ``d(ph)``, so ``d(q) = (q // M) * L + d_tab[q % M]``;
    - ``band_ph``, ``band_off [M, R]``: output ``q0 + r``'s phase row
      ``((ph + r) L) mod M`` and its band offset ``d(ph + r) - d(ph)``;
      ``delta [M]`` is the last offset;
    - ``bands [M, band_w, Rp]``: the band ``G[s, r] = W[band_ph[r], s -
      band_off[r]]``, zero outside the phase row's taps and past ``R``;
    - ``warp_start [M, warps]``: each warp's read start in the block's
      window, ``d(ph + g R) - d(ph)``.

    A band is ``band_w = taps + max(delta)`` wide, and ``out[q0 + r] =
    sum_s G[s, r] * x[start + warp_start + s]``.  Each
    row's window of the new buffer is ``win`` columns, staged at an odd
    ``pitch`` (the 32 lanes' reads at one offset fall in 32 banks); bands
    are padded to ``Rp`` (a multiple of 4) for 16-byte loads.
    ``smem_bytes`` is the block's dynamic shared memory: a table of 24
    bytes per row, the warps' bands and the rows' windows."""

    def __init__(self, config: FirConfig, w: np.ndarray):
        L, M, taps = config.ratio_num, config.ratio_den, config.taps
        self.config = config
        R, warps = min(TILE_R, M), TILE_WARPS
        self.R, self.warps, self.groups = R, warps, TILE_GROUPS
        self.Rp = -(-R // 4) * 4
        self.q_tile = warps * R
        ph = np.arange(M, dtype=np.int64)
        self.d_tab = ph * L // M
        q = ph[:, None] + np.arange(R)
        self.band_ph = q * L % M
        self.band_off = self.d(q) - self.d_tab[:, None]
        self.delta = self.band_off[:, -1]
        self.band_w = taps + int(self.delta.max())
        t = np.arange(self.band_w)[None, :, None] - self.band_off[:, None, :]  # [M, band_w, R]
        inside = (t >= 0) & (t < taps)
        bands = np.zeros((M, self.band_w, self.Rp), np.float32)
        bands[:, :, :R] = np.where(inside, w[self.band_ph[:, None, :], np.clip(t, 0, taps - 1)], 0.0)
        self.bands = bands
        self.warp_start = self.d(ph[:, None] + R * np.arange(warps)) - self.d_tab[:, None]
        self.win = int(self.warp_start[:, -1].max()) + self.band_w
        self.pitch = self.win | 1
        self.smem_bytes = 24 * TILE_ROWS + 4 * (
            warps * self.Rp * self.band_w + TILE_ROWS * self.pitch)
        self._dev: dict = {}

    def d(self, q):
        """``floor(q L / M)`` through the table (``q >= 0``, ints or arrays)."""
        M = self.config.ratio_den
        return (q // M) * self.config.ratio_num + self.d_tab[q % M]

    def q_tiles(self, shared: bool) -> int:
        """Blocks along ``q``: from the shared ``i0`` over ``out_cap``
        (one shared schedule), else from 0 over every stream's ``[i0, i0 +
        out_cap)`` with ``i0 < M``."""
        cfg = self.config
        extent = cfg.out_capacity if shared else cfg.ratio_den - 1 + cfg.out_capacity
        return -(-extent // self.q_tile)

    def tables(self, device: torch.device) -> dict:
        """``bands`` and ``d_tab`` (int32) on ``device``, uploaded once."""
        tabs = self._dev.get(device)
        if tabs is None:
            tabs = self._dev[device] = dict(
                bands=torch.from_numpy(self.bands).to(device),
                d_tab=torch.from_numpy(self.d_tab.astype(np.int32)).to(device),
            )
        return tabs


class FleetStepPlan:
    """Static tables of B8 and B9 for one configuration: the blended
    phase rows ``W [M, taps]`` (the band form's) and transposed (the
    per-output form's), the doubled atlas ``[2M, 2L + taps + 1]`` (the
    plain version's), the atlas window geometry ``span``, ``K``,
    ``l_inv``, the band tile (``R = min(8, M)``, 8 warps) and the form
    the kernel takes: ``"band"``, or ``"thread"`` (one output per thread)
    where the band tile's shared memory would pass ``SMEM_MAX``."""

    def __init__(self, config: FirConfig, coeffs):
        L, M, taps = config.ratio_num, config.ratio_den, config.taps
        if (M - 1) + config.out_capacity * L >= 1 << 31 or config.buffer_alloc >= 1 << 31:
            raise ValueError("the kernel takes 32-bit positions and columns")
        self.config = config
        self.span = L + taps + 1
        self.K = -(-config.out_capacity // M)
        self.l_inv = pow(L, -1, M) if M > 1 else 0
        w = phase_rows(config, coeffs)
        self._w_t = np.ascontiguousarray(w.T)
        self._a2 = _sync_atlas(config, coeffs)
        self.tile = BandTile(config, w)
        self.form = "band" if self.tile.smem_bytes <= SMEM_MAX else "thread"
        self._dev: dict = {}

    def tables(self, device: torch.device) -> dict:
        """The tables on ``device``, uploaded once."""
        tabs = self._dev.get(device)
        if tabs is None:
            tabs = self._dev[device] = dict(
                w_t=torch.from_numpy(self._w_t).to(device),
                a2=torch.from_numpy(self._a2).to(device),
            )
        return tabs


class SpareBuffer:
    """The second buffer of a fused fleet step: ``swap(buffer)`` returns
    the tensor the step writes next (the previous step's input, or fresh
    zeros) and keeps ``buffer`` as the one after."""

    def __init__(self):
        self._spare = None

    def swap(self, buffer: torch.Tensor) -> torch.Tensor:
        spare = self._spare
        if (
            spare is None or spare is buffer or spare.shape != buffer.shape
            or spare.device != buffer.device
        ):
            with tracing.span("fir.contract"):
                spare = torch.zeros_like(buffer)
        self._spare = buffer
        return spare


def schedule(plan: FleetStepPlan, avail, pos_num, n_valid, budget, n_in: int) -> dict:
    """The host schedule of one step for ``[S]`` streams (``S`` is ``B``,
    or 1 for the slide fleet's shared schedule): ``to_copy``, ``n_out``,
    the read start ``base`` and the residue ``r`` the kernel takes, and
    ``avail'``, ``pos'``."""
    cfg = plan.config
    M = cfg.ratio_den
    S = np.shape(avail)[0]
    avail = stream_words(avail, S, "available_frames")
    pos_num = stream_words(pos_num, S, "pos_num")
    n_valid = stream_words(n_valid, S, "n_valid")
    if (n_valid < 0).any():
        raise ValueError(f"n_valid must be >= 0, got {n_valid.min()}")
    if (avail < 0).any() or (avail > cfg.input_capacity).any() or (pos_num < 0).any():
        raise ValueError("available_frames must lie in [0, input_capacity], pos_num >= 0")
    to_copy, avail2, n_out = stream_schedule(
        cfg, avail, pos_num, np.minimum(n_valid, n_in), stream_words(budget, S, "budget")
    )
    d_min, r = np.divmod(pos_num, M)
    base = cfg.input_capacity - avail2 + d_min
    alloc = cfg.buffer_alloc
    # the plain version's region ((K-1)*L + span rows) bounds the kernel's
    # reads; the JAX step's read slack keeps it inside every emitting
    # stream's buffer, where ``dynamic_slice`` would clamp it instead
    reach = base + (plan.K - 1) * cfg.ratio_num + plan.span
    bad = (n_out > 0) & (reach > alloc)
    if bad.any():
        b = int(np.flatnonzero(bad)[0])
        raise IndexError(f"stream {b}: region [{base[b]}, {reach[b]}) outside [0, {alloc})")
    avail_next, pos_next = stream_consume(cfg, pos_num, n_out, avail2)
    return dict(to_copy=to_copy, n_out=n_out, base=np.where(n_out > 0, base, 0), r=r,
                avail=avail_next, pos=pos_next)


def check_step(plan: FleetStepPlan, buffers, view, out_buffers) -> None:
    """``buffers [B, C, alloc]`` contiguous f32; ``view [B, n, C]`` f32 on
    the same device (any strides); ``out_buffers`` like ``buffers`` and
    not overlapping it."""
    cfg = plan.config
    if not isinstance(buffers, torch.Tensor) or buffers.dtype != torch.float32:
        raise TypeError("buffers must be a float32 tensor")
    B = buffers.shape[0]
    if buffers.ndim != 3 or tuple(buffers.shape[1:]) != (cfg.channels, cfg.buffer_alloc):
        raise ValueError(
            f"buffers must be [B, {cfg.channels}, {cfg.buffer_alloc}], got {tuple(buffers.shape)}"
        )
    if not buffers.is_contiguous() or B < 1 or B >= 1 << 16:
        raise ValueError("buffers must be contiguous, with 1 <= B < 65536 streams")
    if not isinstance(view, torch.Tensor) or view.dtype != torch.float32:
        raise TypeError("chunks must be a float32 tensor")
    if view.ndim != 3 or view.shape[0] != B or view.shape[2] != cfg.channels or (
        view.shape[1] > cfg.input_capacity
    ):
        raise ValueError(
            f"chunks must be [{B}, n <= {cfg.input_capacity}, {cfg.channels}] frames-major "
            f"(or its channel-major transpose), got {tuple(view.shape)}"
        )
    if view.device != buffers.device:
        raise ValueError(f"chunks are on {view.device}, buffers on {buffers.device}")
    if out_buffers is not None:
        if (
            not isinstance(out_buffers, torch.Tensor) or out_buffers.dtype != torch.float32
            or out_buffers.shape != buffers.shape or not out_buffers.is_contiguous()
            or out_buffers.device != buffers.device
        ):
            raise ValueError("out_buffers must be a contiguous tensor like buffers")
        a0, b0 = buffers.data_ptr(), out_buffers.data_ptr()
        if abs(a0 - b0) < buffers.numel() * 4:
            raise ValueError("out_buffers overlaps buffers: the step cannot write in place")


def step_reference(plan: FleetStepPlan, buffers, view, sched: dict, out_buffers):
    """The plain version of B8 and B9 on a checked step: the slide
    (``slide_in``), then each stream's atlas window ``a2[i0 : i0 + M, c0 :
    c0 + span]`` against the stride-``L`` windows of its region (the JAX
    XLA step's form), lanes past ``n_out`` zero.  ``(buffers', out [B,
    out_cap, C])``.  The products are summed in f64 and rounded once:
    f32 sums in another order than XLA's are up to ~1.4e-6 off at 64
    taps, over the 1e-6 the JAX suite holds its own kernel to."""
    cfg = plan.config
    L, M = cfg.ratio_num, cfg.ratio_den
    B, C, _ = buffers.shape
    span, K, out_cap = plan.span, plan.K, cfg.out_capacity
    dev = buffers.device
    sched = {k: np.broadcast_to(v, (B,)) for k, v in sched.items()}
    new = slide_in(buffers, view, sched["to_copy"], cfg.input_capacity)
    i0 = (sched["r"] * plan.l_inv) % M
    c0 = (i0 * L) // M
    rows = torch.from_numpy(i0[:, None] + np.arange(M)).to(dev)
    cols = torch.from_numpy(c0[:, None] + np.arange(span)).to(dev)
    a = plan.tables(dev)["a2"][rows[:, :, None], cols[:, None, :]]  # [B, M, span]
    region_len = (K - 1) * L + span
    idx = torch.from_numpy(sched["base"][:, None] + np.arange(region_len)).to(dev)
    region = new.gather(2, idx[:, None, :].expand(B, C, region_len))
    segs = region.unfold(2, span, L)  # [B, C, K, span]
    out = torch.einsum("bjs,bcks->bkjc", a.double(), segs.double()).float()
    out = out.reshape(B, K * M, C)[:, :out_cap]
    n_out = torch.from_numpy(np.array(sched["n_out"])).to(dev)
    keep = torch.arange(out_cap, device=dev)[None, :] < n_out[:, None]
    out = torch.where(keep[:, :, None], out, 0.0)
    if out_buffers is None:
        return new, out
    out_buffers.copy_(new)
    return out_buffers, out


def step_kernel(plan: FleetStepPlan, buffers, view, sched: dict, out_buffers, counter: str):
    """Upload the kernel's schedule rows and ``launch_step``."""
    rows = np.stack([sched[k] for k in ("to_copy", "n_out", "base", "r")], axis=1)
    sched_dev = upload(np.ascontiguousarray(rows, np.int32), buffers.device)
    return launch_step(plan, buffers, view, sched_dev, out_buffers, counter)


def launch_step(plan: FleetStepPlan, buffers, view, sched_dev, out_buffers, counter: str, *,
                _form: str | None = None):
    """Launch ``csrc/fir_fleet_step.cu`` on a checked step of CUDA tensors
    and count it in ``LAUNCHES[counter]``.  ``sched_dev`` is int32 ``[S,
    4]`` on the device, rows ``(to_copy, n_out, base, r)``: one row (the
    slide fleet's shared schedule, read by every stream) or one per
    stream.  The plan's form picks the entry: ``"band"`` is the copy-in
    and the band contraction, two launches counted as one step;
    ``"thread"`` is one launch.  ``_form`` forces a form (to time both on
    one step).  ``(buffers', out [B, out_cap, C])``."""
    cfg = plan.config
    B, C, alloc = buffers.shape
    dev = buffers.device
    if out_buffers is None:
        out_buffers = torch.zeros_like(buffers)
    out = torch.empty((B, cfg.out_capacity, C), dtype=torch.float32, device=dev)
    sb, sf, sc = view.stride()
    stride = 4 if sched_dev.shape[0] == B and B > 1 else 0
    head = (_P(buffers.data_ptr()), _P(view.data_ptr()), _P(sched_dev.data_ptr()), _I(stride))
    steps = (_I(B), _I(C), _I(alloc), _I(cfg.input_capacity), _I64(sb), _I64(sf), _I64(sc),
             _I(cfg.out_capacity))
    L, M = _I(cfg.ratio_num), _I(cfg.ratio_den)
    form = _form or plan.form
    if form == "band":
        tile = plan.tile
        tt = tile.tables(dev)
        launch(
            "fir_fleet_step_band", dev, *head, _P(tt["bands"].data_ptr()),
            _P(tt["d_tab"].data_ptr()), _P(out_buffers.data_ptr()), _P(out.data_ptr()), *steps,
            L, M, _I(plan.l_inv), _I(tile.R), _I(tile.warps), _I(tile.groups),
            _I(tile.band_w), _I(tile.win), _I(tile.pitch), _I(tile.q_tiles(stride == 0)),
        )
    elif form == "thread":
        launch("fir_fleet_step", dev, *head, _P(plan.tables(dev)["w_t"].data_ptr()),
               _P(out_buffers.data_ptr()), _P(out.data_ptr()), *steps, _I(cfg.taps), L, M)
    else:
        raise ValueError(f"unknown form {form!r}")
    LAUNCHES[counter] += 1
    return out_buffers, out


def _fleet_step(plan, buffers, chunks, avail, pos_num, n_valid, budget, out_buffers, plain):
    check_step(plan, buffers, chunks, out_buffers)
    with tracing.span("fir.schedule"):
        sched = schedule(plan, avail, pos_num, n_valid, budget, chunks.shape[1])
    with tracing.span("fir.contract"):
        if plain:
            new, out = step_reference(plan, buffers, chunks, sched, out_buffers)
        else:
            new, out = step_kernel(plan, buffers, chunks, sched, out_buffers, "fir_fleet_step")
    return new, out, sched["avail"], sched["pos"], sched["to_copy"], sched["n_out"]


def fir_fleet_step_reference(
    plan: FleetStepPlan, buffers, chunks, avail, pos_num, n_valid, budget, *, out_buffers=None
):
    """Plain PyTorch version of B9 (see ``fir_fleet_step``)."""
    return _fleet_step(plan, buffers, chunks, avail, pos_num, n_valid, budget, out_buffers, True)


def fir_fleet_step(
    plan: FleetStepPlan, buffers, chunks, avail, pos_num, n_valid, budget, *, out_buffers=None
):
    """One step of ``B`` independent streams: ``buffers [B, C, alloc]``,
    ``chunks [B, n_in, C]`` f32 (any strides), ``avail``, ``pos_num``,
    ``n_valid``, ``budget`` ``[B]`` ints.  Returns ``(buffers', out [B,
    out_cap, C], avail', pos_num', consumed, produced)``, the counts as
    ``[B]`` int64 numpy.  ``buffers'`` is ``out_buffers`` when given
    (written, never ``buffers`` itself), else a new tensor.  CUDA tensors
    launch kernel B9 on the current stream; CPU tensors run the plain
    version.  Anything else raises."""
    plain = device_kind(buffers) == "cpu"
    return _fleet_step(plan, buffers, chunks, avail, pos_num, n_valid, budget, out_buffers, plain)
