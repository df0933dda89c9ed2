"""The async fleet's mean position spread after a step, in input frames:
the program's counters ``fir.async.spread / (fir.steps x M)``, over the
process's steps."""

from perfbench import spans
from perfbench.reference.fir import reduced_ratio


def read(rec):
    c = spans.counters()
    if c is None or not c.get("fir.steps") or "fir.async.spread" not in c:
        return None
    _, M = reduced_ratio(rec.cell.config["input_rate"], rec.cell.config["output_rate"])
    return c["fir.async.spread"] / (c["fir.steps"] * M)
