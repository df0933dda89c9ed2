"""Host time per traced step of ``StreamingFleet.step``'s per-stream output
slices (self time of ``rtt.runtime.deliver``), in ms."""

from perfbench import spans


def read(rec):
    return spans.per_step_self_ms(rec, {"runtime.deliver"})
