"""Device milliseconds per traced step of host-device copies (memcpy
events, host to device and device to host)."""


def read(rec):
    t = rec.trace
    if t is None or not t.device:
        return None
    us = t.copy_us()
    return us / t.steps / 1e3 if us > 0 else None
