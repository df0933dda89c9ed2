"""The 95th percentile over all steps of the window of one step's time,
from the call to its outputs being ready, on the device's clock (a CUDA
event before the call and one after it, then a synchronise)."""

from perfbench.core import quantile


def read(rec):
    return quantile(rec.step_ms, 95) if rec.step_ms else None
