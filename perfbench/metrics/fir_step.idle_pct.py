"""The share of the traced stretch in which the device idles while the host
is inside a FIR fleet step (``rtt.fir.step``), in %."""

from perfbench import spans


def read(rec):
    return spans.idle_pct_under(rec, {"fir.step"})
