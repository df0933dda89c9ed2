"""The host's cost of issuing one FIR fleet step, in us, as the program
times it: ``fir.host_ns / fir.steps / 1e3`` from the program's counters
(host nanoseconds inside ``BatchedResamplerFir.resample`` and
``resample_many``, no synchronise inside, no profiler needed).

The counters run over the whole process: the warm steps and the traced
stretch count beside the window's steps, some 200 of them against tens of
thousands, which biases the reading by under ~1% (about 1% where a window
holds only ~1,000 steps, as ``fir.ragged``'s does)."""

from perfbench import spans


def read(rec):
    c = spans.counters()
    if c is None or not c.get("fir.steps") or "fir.host_ns" not in c:
        return None
    return c["fir.host_ns"] / c["fir.steps"] / 1e3
