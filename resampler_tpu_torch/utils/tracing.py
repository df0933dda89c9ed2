"""Spans and counters of the port's own stages.

``span(name)`` marks a stage of a serving or fleet step.  While a
``torch.profiler.profile`` runs it records the range ``"rtt." + name`` in
the profiler's host timeline, on the clock of the device events, nested
in the ranges open around it: one step's stages share its root span.
With no profiler running it returns one shared object that does nothing,
after a single read of torch's profiler flag: no clock, no allocation, no
torch call.  An active profiler is the only switch.

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
- ``runtime.staged_streams``: streams whose batch row a step packed from
  the host carry, summed over steps (the rest pass through as drained);
- ``runtime.values_refused``: values ``StreamingFleet.push`` did not
  queue (a full queue, or a trailing part of a frame);
- ``fir.steps``: FIR fleet steps (each chunk of ``resample_many`` is one);
- ``fir.compactions``: ring compactions of the time-major fleets.
"""

from __future__ import annotations

import threading

import torch
from torch.autograd import profiler as _profiler

from ..ops._build import LAUNCHES

__all__ = ["PREFIX", "count", "counters", "reset_counters", "span"]

PREFIX = "rtt."

_COUNTS = dict.fromkeys(
    ("runtime.steps", "runtime.carried_frames", "runtime.staged_streams",
     "runtime.values_refused", "fir.steps", "fir.compactions"),
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
