"""Frames a stream holds in ``StreamingFleet``'s host carry after a step, on
average over the process's steps and streams: the program's counters
``runtime.carried_frames / (runtime.steps x streams)``."""

from perfbench import spans


def read(rec):
    c = spans.counters()
    if c is None or not c.get("runtime.steps"):
        return None
    return c["runtime.carried_frames"] / (c["runtime.steps"] * rec.cell.config["streams"])
