"""The host us a tm fleet step spends in its schedule, as the program times
it: ``fir.schedule_ns / fir.steps / 1e3`` from the program's counters
(both ``fir.schedule`` sites: the emission count before the contraction
and the consume's advance after it; no profiler needed).  On the wide
two-word schedule that is the emission count and the two-word stride,
whether the program forms them lane by lane in numpy or in closed form.

The counters run over the whole process (the warm steps and the traced
stretch count beside the window's steps).  ``None`` where the program
keeps no such counter."""

from perfbench import spans


def read(rec):
    c = spans.counters()
    if c is None or not c.get("fir.steps") or "fir.schedule_ns" not in c:
        return None
    return c["fir.schedule_ns"] / c["fir.steps"] / 1e3
