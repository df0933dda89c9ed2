"""The share of the traced stretch in which the device idles while the host
is inside the FIR step's checks (``rtt.fir.check``), in %: the checks'
share of the device's idle gaps, on the profiler's one clock."""

from perfbench import spans


def read(rec):
    return spans.idle_pct_under(rec, {"fir.check"})
