"""Host time per traced step of ``StreamingFleet.step``'s carry staging:
self time of ``rtt.runtime.stage`` (the carry and the drained frames gathered
into the batch) and ``rtt.runtime.recarry`` (the carry rebuilt), in ms."""

from perfbench import spans


def read(rec):
    return spans.per_step_self_ms(rec, {"runtime.stage", "runtime.recarry"})
