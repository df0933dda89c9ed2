"""Kernel B4's share of its roofline: the frozen bound of the cell's shapes
(``rooflines/b4.py``) over B4's mean device time per call in the trace."""

from perfbench.core import HERE, load_module


def read(rec):
    roof = load_module(HERE / "rooflines" / "b4.py")
    bound = roof.bound_seconds(rec.cell.config, rec.cell.traffic)
    if rec.trace is None:
        return None
    us, calls = rec.trace.kernel_us(roof.KERNEL)
    if not calls or us <= 0:
        return None
    return 100.0 * bound / (us / calls / 1e6)
