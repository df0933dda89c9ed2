"""The serving runtime's own host time per step, in ms: the pushes plus
``StreamingFleet.step()``, less the fleet call inside it, over the window's
steps (host clock, summed over the whole window)."""


def read(rec):
    L = rec.layers
    if not L.calls.get("runtime_step"):
        return None
    own = L.total.get("runtime_push", 0.0) + L.total["runtime_step"] - L.total.get("fir_resample", 0.0)
    return own / L.calls["runtime_step"] * 1e3
