"""Kernel B5's share of its roofline: the bound of the cell's shapes
(``rooflines/b5.py``) over B5's mean device time a call.  That time is the
device us of the launches inside ``rtt.fft.pool`` per traced step, over
the ``chunks_per_call - 1`` pool steps of a step: B4 and B5 share a device
kernel, so the span tells them apart, not the kernel's name."""

from perfbench import spans
from perfbench.core import HERE, load_module


def read(rec):
    roof = load_module(HERE / "rooflines" / "b5.py")
    us = spans.per_step_device_us(rec, {roof.SPAN})
    if not us:
        return None
    calls = rec.cell.traffic["chunks_per_call"] - 1
    return 100.0 * roof.bound_seconds(rec.cell.config, rec.cell.traffic) / (us / calls / 1e6)
