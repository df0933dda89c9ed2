"""Device us per ring compaction in the traced stretch: the events launched
inside ``rtt.fir.compact`` over the number of those spans (``None`` where the
stretch held none)."""

from perfbench import spans


def read(rec):
    t = rec.trace
    n = 0 if t is None else len(spans.spans(t, {"fir.compact"}))
    us = spans.per_step_device_us(rec, {"fir.compact"})
    return None if us is None or not n else us * t.steps / n
