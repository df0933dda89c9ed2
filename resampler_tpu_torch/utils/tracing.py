"""Spans and counters of the port's own stages.

``span(name)`` marks a stage of a serving or fleet step.  While a
``torch.profiler.profile`` runs it records the range ``"rtt." + name`` in
the profiler's host timeline, on the clock of the device events, nested
in the ranges open around it: one step's stages share its root span.
With no profiler running it returns one shared object that does nothing,
after a single read of torch's profiler flag: no clock, no allocation, no
torch call.  An active profiler is the only switch.

The stages, each one span: ``runtime.push``; ``runtime.step`` and in it
``runtime.drain``, ``.stage``, ``.recarry``, ``.fetch``, ``.deliver``;
``fir.step`` (``BatchedResamplerFir.resample`` and ``resample_many``) and
in it ``fir.upload``, ``fir.relayout_in``, ``fir.append``,
``fir.schedule``, ``fir.lanes`` (the async fleet's ``[2, R]`` lane
upload), ``fir.contract`` (on the tm fleet's farrow and lerp paths with
``fir.weights`` nested in it, the step's Farrow weights: on the card one
launch of the weights kernel and its output's allocation, elsewhere
``farrow_weights``' host residues and basis values, their uploads and the
positioning matmul; so ``fir.contract``'s own launch is the
contraction's), ``fir.check`` (the step's argument and geometry checks:
the chunks' shape in ``fir.step``, the ring append's in ``fir.step``, the
contraction wrappers' in ``fir.contract``; it holds no launch and no op
that moves data, so ``fir.contract``'s self time is the launch path's),
``fir.mask``, ``fir.relayout_out``,
``fir.compact``, ``fir.peak`` (on the tm fleet's fused epilogue
``fir.contract`` holds kernel B1, which does the mask's, the relayout's
and the peak's work, ``fir.relayout_out`` the output's allocation and
``fir.peak`` the peak's reset; no ``fir.mask``);
``fir.slew`` (``BatchedResamplerFir.slew``,
a root of its own); ``fft.step`` and in it ``fft.upload``,
``fft.contract``, ``fft.keep`` (on ``resample_many``'s pool path
``fft.contract`` holds chunk 0's fleet step alone, ``fft.pool`` the other
chunks' pool steps, kernel B5, and ``fft.stack`` the result's
allocation alone, no device work: B4 and B5 store into its slots).

The ranges are recorded as operator-scope events
(``torch._C._profiler._RecordFunctionFast``), not as user annotations
(``torch.profiler.record_function``): the profiler mirrors a user
annotation onto the device timeline as an event of its own, and a reader
of the device events would count that mirror as device work.  A device
event is attributed to a span through the launch that made it.

``count(name, n)`` adds to one of the always-on counters; ``counters()``
snapshots them together with the kernel wrappers' launch counts
(``ops._build.LAUNCHES``, as ``"launches.<wrapper>"``):

- ``runtime.steps``: ``StreamingFleet.step`` calls;
- ``runtime.carried_frames``: frames per stream left in the host carry
  after each step, summed over streams and steps;
- ``runtime.fetch_reuses``: ``StreamingFleet`` fetches of a card fleet's
  output that landed in the fleet's pinned host buffer without allocating
  it (0 on the CPU, where the output is read in place);
- ``runtime.values_refused``: values ``StreamingFleet.push`` did not
  queue (a full queue, or a trailing part of a frame);
- ``fir.steps``: FIR fleet steps (each chunk of ``resample_many`` is one);
- ``fir.host_ns``: host nanoseconds inside ``BatchedResamplerFir.resample``
  and ``resample_many`` (the ``fir.step`` root; ``slew`` is not in it),
  summed over the calls that returned: ``fir.host_ns / fir.steps / 1e3``
  is the host us a step costs, with no profiler running;
- ``fir.schedule_ns``: host nanoseconds in the tm fleet step's schedule,
  both ``fir.schedule`` sites (the emission count before the contraction,
  the consume's advance after it), on the int32 envelope and on the wide
  schedule alike, summed over the steps that returned: ``fir.schedule_ns /
  fir.steps / 1e3`` is the host us a step spends there (a closed form on
  Python ints, on the wide schedule the count and the two-word stride of
  ``WideSchedule``);
- ``fir.wide_steps``: tm fleet steps on the wide two-word u32 schedule
  (``FirConfig.wide``); 0 on the int32 envelope, ``fir.steps`` where
  every step of the process is one;
- ``fir.compactions``: ring compactions of the time-major fleets;
- ``fir.fused_epilogue``: tm fleet steps whose outputs, zeroed rows and
  peak the contraction kernel wrote itself, B1 on the periodic path or B2
  on the farrow / lerp / wide paths (the fused epilogue; the engaged share is
  ``fir.fused_epilogue / fir.steps``);
- ``fir.farrow_steps``: tm fleet steps that ran the Farrow contraction
  (B2 or B3 on the card, their plain version off it; the farrow, lerp
  and wide paths; over ``fir.steps``, 1 where every step emits);
- ``fir.banded_steps``: tm fleet steps whose B2 launch read the plan's
  band table (each row tile's columns alone); the engaged share is
  ``fir.banded_steps / fir.farrow_steps``, 1 on the card's B2, 0 on B3 and
  off the card;
- ``fir.slews``: streams whose applied slew was non-zero, summed over
  ``BatchedResamplerFir.slew`` calls;
- ``fir.async.spread``: the async fleet's position spread ``max(pos) -
  min(pos)`` in 1/M frames after each step, summed over steps;
- ``fft.chunks``: chunks stepped by the FFT fleet, 1 per ``resample`` and
  ``T`` per ``resample_many``;
- ``fft.host_ns``: the same as ``fir.host_ns`` inside
  ``BatchedResamplerFft.resample`` and ``resample_many`` (``fft.host_ns /
  fft.chunks / 1e3``: host us a chunk);
- ``fft.pool_steps``: those of them that took the pool step (kernel B5 on
  the card, its plain version off it; the engaged share ``fft.pool_steps /
  fft.chunks`` is ``(T - 1) / T`` where ``resample_many`` pools, 0 where
  it loops the fleet step);
- ``fft.in_place``: chunks whose output B4 or B5 (their plain version
  off the card) stored straight into its slot of ``resample_many``'s
  result (the engaged share ``fft.in_place / fft.chunks`` is 1 where
  ``resample_many`` pools, 0 on ``resample`` and where it loops).
"""

from __future__ import annotations

import threading

import torch
from torch.autograd import profiler as _profiler

from ..ops._build import LAUNCHES

__all__ = ["PREFIX", "count", "counters", "reset_counters", "span"]

PREFIX = "rtt."

_COUNTS = dict.fromkeys(
    ("runtime.steps", "runtime.carried_frames", "runtime.fetch_reuses",
     "runtime.values_refused", "fir.steps", "fir.host_ns", "fir.schedule_ns",
     "fir.wide_steps", "fir.compactions", "fir.fused_epilogue", "fir.farrow_steps",
     "fir.banded_steps", "fir.slews", "fir.async.spread",
     "fft.chunks", "fft.host_ns", "fft.pool_steps", "fft.in_place"),
    0,
)
_LOCK = threading.Lock()  # producers push from threads of their own


class _Off:
    """The span of an unprofiled process: enters and exits, nothing else."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


def span(name: str):
    """A context manager over one stage, recorded as ``"rtt." + name``
    while a profiler runs."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (one of the module docstring's)."""
    with _LOCK:
        _COUNTS[name] += n


def counters() -> dict[str, int]:
    """A snapshot of every counter and of ``LAUNCHES``."""
    snap = dict(_COUNTS)
    snap.update(("launches." + k, v) for k, v in LAUNCHES.items())
    return snap


def reset_counters() -> None:
    """Zero every counter and every launch count (``LAUNCHES`` in place)."""
    for table in (_COUNTS, LAUNCHES):
        for k in table:
            table[k] = 0
