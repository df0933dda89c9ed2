"""Device us per traced step of the FIR fleet step's epilogue: the events
launched inside ``rtt.fir.mask`` (lanes past the step's outputs zeroed),
``rtt.fir.relayout_out`` (outputs to ``[B, out_cap, C]``) and ``rtt.fir.peak``
(the fleet's peak meter)."""

from perfbench import spans


def read(rec):
    return spans.per_step_device_us(rec, {"fir.mask", "fir.relayout_out", "fir.peak"})
