"""Host us per traced step of the farrow tm step's weights: the self time
of ``rtt.fir.weights`` (``farrow_weights``: the host residues and basis
values, their uploads, the launches of the one-hot and the positioning
matmul)."""

from perfbench import spans


def read(rec):
    ms = spans.per_step_self_ms(rec, {"fir.weights"})
    return None if ms is None else ms * 1e3
