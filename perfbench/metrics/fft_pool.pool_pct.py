"""The share of the FFT fleet's chunks that took the pool step (kernel
B5), over the whole process: the program's counters ``100 x
fft.pool_steps / fft.chunks``.  ``(T - 1) / T`` where ``resample_many``
pools its ``T`` chunks, 0 where it silently loops the fleet step."""

from perfbench import spans


def read(rec):
    c = spans.counters()
    if c is None or not c.get("fft.chunks") or "fft.pool_steps" not in c:
        return None
    return 100.0 * c["fft.pool_steps"] / c["fft.chunks"]
