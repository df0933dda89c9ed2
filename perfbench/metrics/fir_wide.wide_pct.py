"""The share of the FIR fleet's steps that ran on the wide two-word u32
schedule, over the whole process: the program's counters ``100 x
fir.wide_steps / fir.steps``.  100 where every step carries its position
in two words, 0 on a silent fall to the int32 envelope; ``None`` where the
program keeps no such counter."""

from perfbench import spans


def read(rec):
    c = spans.counters()
    if c is None or not c.get("fir.steps") or "fir.wide_steps" not in c:
        return None
    return 100.0 * c["fir.wide_steps"] / c["fir.steps"]
