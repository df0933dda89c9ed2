"""The share of the traced stretch in which the device idles while the host
is inside an FFT fleet step (``rtt.fft.step``), in %."""

from perfbench import spans


def read(rec):
    return spans.idle_pct_under(rec, {"fft.step"})
