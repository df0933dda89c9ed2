"""The share of FIR fleet steps that compacted the ring, over the whole
process: the program's counters ``100 x fir.compactions / fir.steps``."""

from perfbench import spans


def read(rec):
    c = spans.counters()
    if c is None or not c.get("fir.steps"):
        return None
    return 100.0 * c["fir.compactions"] / c["fir.steps"]
