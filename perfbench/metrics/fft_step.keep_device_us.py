"""Device us per traced step of the FFT fleet's carry clone: the events
launched inside ``rtt.fft.keep``."""

from perfbench import spans


def read(rec):
    return spans.per_step_device_us(rec, {"fft.keep"})
