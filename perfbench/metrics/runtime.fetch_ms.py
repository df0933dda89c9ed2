"""Host time per traced step of ``StreamingFleet.step``'s fetch of the fleet's
output (self time of ``rtt.runtime.fetch``: a pageable device-to-host copy
that first waits for the device), in ms."""

from perfbench import spans


def read(rec):
    return spans.per_step_self_ms(rec, {"runtime.fetch"})
