"""Device us per traced step of the async fleet's lane upload: the events
launched inside ``rtt.fir.lanes`` (each lane's residue and frame skew, ``[2,
R]`` through pinned memory)."""

from perfbench import spans


def read(rec):
    return spans.per_step_device_us(rec, {"fir.lanes"})
