"""Readings of the program's own spans in a traced stretch.

The program records each stage of a step as a host range named ``rtt.<stage>``
(``resampler_tpu_torch/utils/tracing.py``), an operator-scope event with no
mirror on the device's timeline, so the device events of the trace are the
device's work alone.  From a ``trace.Trace`` this reads:

- a span's self time: its length less the time of the spans nested in it;
- the device time of a span: the device events of the launches that ran
  inside it, innermost span first (``attribute``);
- the device's idle time under a span: the stretch's gaps between device
  events that fall inside the span's host ranges.

A launch and its device event are paired by order: one stream runs its work
in the order it was launched, so the n-th host call that launches device
work made the n-th device event.  Each pair must agree in kind (kernel, copy or
memset); where the two sequences disagree anywhere, nothing is attributed.
Time never goes to a span because a device event overlapped it on the clock.
"""

from __future__ import annotations

import bisect

from .trace import merged

PREFIX = "rtt."

#: host calls that launch device work, by the kind of device event they make
_LAUNCHES = (
    ("kernel", ("cudaLaunchKernel", "cuLaunchKernel")),
    ("copy", ("cudaMemcpy",)),
    ("set", ("cudaMemset",)),
)


def launch_kind(name: str):
    """The kind of device event the host call ``name`` makes, or ``None``."""
    for kind, prefixes in _LAUNCHES:
        if name.startswith(prefixes):
            return kind
    return None


def device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "set"
    return "kernel"


def spans(trace, names=None) -> list[tuple[str, float, float]]:
    """The stretch's ``rtt.`` host ranges as ``(stage, start_us, end_us)``,
    sorted by start (outer before inner at one start); ``names`` keeps only
    those stages."""
    out = [(n[len(PREFIX):], s, e) for n, s, e in trace.host
           if n.startswith(PREFIX) and trace.t0_us <= s <= trace.t1_us]
    if names is not None:
        out = [sp for sp in out if sp[0] in names]
    return sorted(out, key=lambda sp: (sp[1], -sp[2]))


def self_us(trace, names) -> float:
    """Summed self time of the spans of ``names``: each one's length less
    the length of the spans directly inside it."""
    every = spans(trace)
    inner = [0.0] * len(every)
    stack: list[int] = []
    for i, (_, s, e) in enumerate(every):
        while stack and every[stack[-1]][2] < e:
            stack.pop()
        if stack:
            inner[stack[-1]] += e - s
        stack.append(i)
    return sum(e - s - inner[i] for i, (n, s, e) in enumerate(every) if n in names)


def innermost(every, t_us: float):
    """The stage of the innermost span of ``every`` (sorted by ``spans``)
    open at ``t_us``, or ``None``."""
    for k in range(bisect.bisect_right(every, t_us, key=lambda sp: sp[1]) - 1, -1, -1):
        if every[k][2] >= t_us:
            return every[k][0]
    return None


def attribute(trace):
    """``{stage: device us}`` over the stretch: each device event given to
    the innermost span around the host call that launched it (``None`` for
    a launch outside every span), or ``None`` where launches and device
    events do not pair up."""
    launches = sorted((s, e, k) for n, s, e in trace.host if (k := launch_kind(n)))
    work = sorted((s, e, device_kind(n)) for n, s, e in trace.device)
    if len(launches) != len(work) or any(l[2] != w[2] for l, w in zip(launches, work)):
        return None
    every = spans(trace)
    out: dict = {}
    for (ls, le, _), (ws, we, _) in zip(launches, work):
        if trace.t0_us <= ls <= trace.t1_us:
            stage = innermost(every, ls)
            out[stage] = out.get(stage, 0.0) + (we - ws)
    return out


def idle_under_us(trace, names) -> float:
    """Device idle time of the stretch inside the host ranges of ``names``."""
    lo, hi = trace.t0_us, trace.t1_us
    gaps, edge = [], lo
    for s, e in merged(trace.device, lo, hi):
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if hi > edge:
        gaps.append((edge, hi))
    under = merged([(n, s, e) for n, s, e in spans(trace, names)], lo, hi)
    total = 0.0
    for s, e in under:
        for gs, ge in gaps:
            total += max(0.0, min(e, ge) - max(s, gs))
    return total


def counters():
    """The program's counters (``tracing.counters()``), or ``None`` for a
    program that keeps none."""
    try:
        from resampler_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.counters()


def per_step_device_us(rec, names):
    """Device us per traced step attributed to the spans of ``names``, or
    ``None`` off the card, without the spans, or where nothing pairs."""
    t = rec.trace
    if t is None or not t.device or not spans(t, names):
        return None
    got = attribute(t)
    if got is None:
        return None
    return sum(got.get(n, 0.0) for n in names) / t.steps


def per_step_self_ms(rec, names):
    """Host self time per traced step of the spans of ``names``, in ms, or
    ``None`` without them."""
    t = rec.trace
    if t is None or not spans(t, names):
        return None
    return self_us(t, names) / t.steps / 1e3


def idle_pct_under(rec, names):
    """Share of the stretch in which the device idles under the spans of
    ``names``, in %, or ``None`` off the card or without them."""
    t = rec.trace
    if t is None or not t.device or not spans(t, names):
        return None
    return 100.0 * idle_under_us(t, names) / (t.t1_us - t.t0_us)
