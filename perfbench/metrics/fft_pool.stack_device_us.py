"""Device us per traced step of the assembly of ``resample_many``'s
``[T, B, C, M]`` output: the events launched inside ``rtt.fft.stack``."""

from perfbench import spans


def read(rec):
    return spans.per_step_device_us(rec, {"fft.stack"})
