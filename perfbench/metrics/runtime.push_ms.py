"""Host time per traced step of ``StreamingFleet.push`` (its ``rtt.runtime.push``
spans' self time: the pool's queue concatenation), in ms."""

from perfbench import spans


def read(rec):
    return spans.per_step_self_ms(rec, {"runtime.push"})
