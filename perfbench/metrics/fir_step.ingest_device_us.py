"""Device us per traced step of the FIR fleet step's ingest: the events
launched inside ``rtt.fir.relayout_in`` (chunks to the time-major feed) and
``rtt.fir.append`` (the ring append)."""

from perfbench import spans


def read(rec):
    return spans.per_step_device_us(rec, {"fir.relayout_in", "fir.append"})
