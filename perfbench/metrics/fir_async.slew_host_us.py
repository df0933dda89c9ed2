"""Host us per traced step of the async fleet's slew: the self time of
``rtt.fir.slew`` (``BatchedResamplerFir.slew``'s bookkeeping, the history
clamp and the skew check)."""

from perfbench import spans


def read(rec):
    ms = spans.per_step_self_ms(rec, {"fir.slew"})
    return None if ms is None else ms * 1e3
