"""Device us per traced step of the farrow tm step's weights: the events
launched inside ``rtt.fir.weights`` (``farrow_weights``: the residues' and
basis values' uploads, the one-hot and the positioning matmul)."""

from perfbench import spans


def read(rec):
    return spans.per_step_device_us(rec, {"fir.weights"})
