"""Kernel B1's share of its roofline: the bound of the cell's shapes
(``rooflines/b1.py``) over B1's mean device time per call in the trace."""

from perfbench.core import HERE, load_module


def read(rec):
    roof = load_module(HERE / "rooflines" / "b1.py")
    if rec.trace is None:
        return None
    us, calls = rec.trace.kernel_us(roof.KERNEL)
    if not calls or us <= 0:
        return None
    return 100.0 * roof.bound_seconds(rec.cell.config, rec.cell.traffic) / (us / calls / 1e6)
