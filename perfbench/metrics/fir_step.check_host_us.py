"""Host us per traced step of the FIR step's argument and geometry checks:
the self time of ``rtt.fir.check`` (the chunks' shape, the ring append's,
the contraction wrappers')."""

from perfbench import spans


def read(rec):
    ms = spans.per_step_self_ms(rec, {"fir.check"})
    return None if ms is None else ms * 1e3
