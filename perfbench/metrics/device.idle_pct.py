"""The share of the traced stretch in which the device ran no kernel and no
copy: one less the union of the trace's device intervals over the
stretch."""


def read(rec):
    t = rec.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
