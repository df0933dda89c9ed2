"""Output samples (frames x streams x channels) produced in the window, in
millions per second of the window (host clock over the whole window)."""


def read(rec):
    return rec.samples / rec.window_s / 1e6
