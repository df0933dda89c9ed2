"""Host time per traced step of the pool's drain in ``StreamingFleet.step``
(self time of ``rtt.runtime.drain``: the per-stream fill loop), in ms."""

from perfbench import spans


def read(rec):
    return spans.per_step_self_ms(rec, {"runtime.drain"})
