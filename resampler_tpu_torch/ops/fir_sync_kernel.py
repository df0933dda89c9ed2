"""Kernel B8: the fused step of the synchronized slide fleet.

Port of ``resampler_tpu/ops/fir_sync_kernel.py:52
make_fir_fleet_step_sync_pallas``: the step of ``make_fir_fleet_step_sync``
(masked copy-in, end-aligned re-window, banded contraction, output mask),
every stream on ONE shared schedule::

    (buffers [B, C, alloc], chunks [B, C, n_in] or [B, n_in, C], avail, pos_num, n_valid)
    -> (buffers', out [B, out_cap, C], avail', pos_num', consumed, produced)

with the schedule as Python ints.  It is B9's function (``ops/fir_kernel.py``)
with one schedule row read by every stream, so it shares B9's CUDA kernel
(``csrc/fir_fleet_step.cu``, schedule stride 0: the band form's q tiles
start at the shared canonical start), plan and plain version, and counts
its own launches in ``LAUNCHES["fir_fleet_step_sync"]``, once per step.  The
chunk layout is read through its strides, so channel-major and
frames-major feeds take no relayout.  The TPU kernel's row tiles, its
power-of-two roll widths and its 8-row aligned atlas load do not carry
over.
"""

from __future__ import annotations

import numpy as np

from ..utils import tracing
from ._build import device_kind
from .fir_kernel import FleetStepPlan, check_step, schedule, step_kernel, step_reference

__all__ = ["fir_fleet_step_sync", "fir_fleet_step_sync_reference"]


def _sync_step(plan, buffers, chunks, avail, pos_num, n_valid, channel_major, out_buffers, plain):
    with tracing.span("fir.check"):  # the transpose is a view: no data moves
        for what, v in (("available_frames", avail), ("pos_num", pos_num), ("n_valid", n_valid)):
            if not isinstance(v, (int, np.integer)) or isinstance(v, bool):
                raise TypeError(
                    f"{what} must be an int (one shared schedule), got {type(v).__name__}"
                )
        view = chunks.transpose(1, 2) if channel_major and chunks.ndim == 3 else chunks
        check_step(plan, buffers, view, out_buffers)
    with tracing.span("fir.schedule"):
        sched = schedule(plan, [avail], [pos_num], [n_valid], [plan.config.out_capacity],
                         view.shape[1])
    with tracing.span("fir.contract"):
        if plain:
            new, out = step_reference(plan, buffers, view, sched, out_buffers)
        else:
            new, out = step_kernel(plan, buffers, view, sched, out_buffers, "fir_fleet_step_sync")
    return (new, out, int(sched["avail"][0]), int(sched["pos"][0]),
            int(sched["to_copy"][0]), int(sched["n_out"][0]))


def fir_fleet_step_sync_reference(
    plan: FleetStepPlan, buffers, chunks, avail: int, pos_num: int, n_valid: int, *,
    channel_major: bool = False, out_buffers=None,
):
    """Plain PyTorch version of B8 (see ``fir_fleet_step_sync``)."""
    return _sync_step(plan, buffers, chunks, avail, pos_num, n_valid, channel_major,
                      out_buffers, True)


def fir_fleet_step_sync(
    plan: FleetStepPlan, buffers, chunks, avail: int, pos_num: int, n_valid: int, *,
    channel_major: bool = False, out_buffers=None,
):
    """One step of ``B`` streams on one shared schedule: ``buffers [B, C,
    alloc]``, ``chunks [B, n_in, C]`` (``[B, C, n_in]`` with
    ``channel_major=True``) f32, the schedule as ints.  Returns
    ``(buffers', out [B, out_cap, C], avail', pos_num', consumed,
    produced)``; ``buffers'`` is ``out_buffers`` when given, else a new
    tensor.  CUDA tensors launch kernel B8 on the current stream; CPU
    tensors run the plain version.  Anything else raises."""
    plain = device_kind(buffers) == "cpu"
    return _sync_step(plan, buffers, chunks, avail, pos_num, n_valid, channel_major,
                      out_buffers, plain)
