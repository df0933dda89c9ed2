"""Reduction of a torch.profiler trace to the numbers the per-layer metrics
read: device intervals and their union, time per kernel name, copies, and
the longest idle gaps with the host op that ran in each."""

from __future__ import annotations

import dataclasses

#: the harness's own label around every traced step; every label of the
#: harness starts with ``LABEL_PREFIX``
LABEL_PREFIX = "perfbench."
STEP_LABEL = LABEL_PREFIX + "step"


@dataclasses.dataclass
class Trace:
    """One traced stretch: device events ``(name, start_us, end_us)``, host
    events likewise, the stretch ``[t0_us, t1_us]`` and its step count."""

    device: list[tuple[str, float, float]]
    host: list[tuple[str, float, float]]
    t0_us: float
    t1_us: float
    steps: int

    @property
    def window_s(self) -> float:
        return (self.t1_us - self.t0_us) / 1e6

    @property
    def busy_s(self) -> float:
        return union_length(self.device, self.t0_us, self.t1_us) / 1e6

    def kernel_us(self, pattern: str) -> tuple[float, int]:
        """Total device microseconds and count of the events whose name
        holds ``pattern``."""
        hits = [e - s for name, s, e in self.device if pattern in name]
        return sum(hits), len(hits)

    def copy_us(self) -> float:
        """Device microseconds of host-device copies (both directions)."""
        return sum(e - s for name, s, e in self.device if is_transfer(name))

    def top_ops(self, n: int = 10) -> list[list]:
        totals: dict[str, float] = {}
        for name, s, e in self.device:
            totals[name] = totals.get(name, 0.0) + (e - s)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], us / 1e6] for name, us in top]

    def idle_gaps(self, n: int = 10) -> list[list]:
        gaps = []
        edge = self.t0_us
        for s, e in merged(self.device, self.t0_us, self.t1_us):
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, e)
        if self.t1_us > edge:
            gaps.append((edge, self.t1_us))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.host_op_at((s + e) / 2)[:160], (e - s) / 1e6] for s, e in gaps[:n]]

    def host_op_at(self, t_us: float) -> str:
        """The innermost host event running at ``t_us`` (the latest
        started among those that cover it)."""
        best = None
        for name, s, e in self.host:
            if s <= t_us <= e and (best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else "(no host op)"


def is_transfer(name: str) -> bool:
    n = name.lower()
    return "memcpy" in n and ("htod" in n or "dtoh" in n)


def merged(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of ``(name, start, end)`` intervals clipped to ``[lo, hi]``,
    as sorted disjoint ``(start, end)`` pairs."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in intervals if e > lo and s < hi)
    out: list[list[float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals, lo: float, hi: float) -> float:
    return sum(e - s for s, e in merged(intervals, lo, hi))


def from_profiler(prof, steps: int) -> Trace:
    """A ``Trace`` from a finished ``torch.profiler.profile``: the stretch
    runs from the first labelled step's start to the last one's end."""
    from torch.autograd import DeviceType

    device, host, marks = [], [], []
    for ev in prof.events():
        span = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == DeviceType.CUDA:
            # a label's mirror on the device's timeline is no device work
            if not ev.name.startswith(LABEL_PREFIX):
                device.append(span)
        else:
            host.append(span)
            if ev.name == STEP_LABEL:
                marks.append(span)
    if not marks:
        raise RuntimeError("the trace holds no labelled step")
    return Trace(device, host, min(s for _, s, _ in marks), max(e for _, _, e in marks), steps)
