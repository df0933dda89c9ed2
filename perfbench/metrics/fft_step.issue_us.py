"""The host's cost of issuing one FFT chunk, in us, as the program times
it: ``fft.host_ns / fft.chunks / 1e3`` from the program's counters (host
nanoseconds inside ``BatchedResamplerFft.resample`` and ``resample_many``,
no synchronise inside, no profiler needed; a ``resample_many`` call of T
chunks counts T).

The counters run over the whole process: the warm calls and the traced
stretch count beside the window's, which biases the reading by under
~1%."""

from perfbench import spans


def read(rec):
    c = spans.counters()
    if c is None or not c.get("fft.chunks") or "fft.host_ns" not in c:
        return None
    return c["fft.host_ns"] / c["fft.chunks"] / 1e3
