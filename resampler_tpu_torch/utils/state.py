"""Carry stream state between numpy (and so the JAX package or a
``resampler_tpu.utils.checkpoint`` ``.npz``) and the port.

The port keeps a state as a dict: ``buffer`` is a float32 tensor, the
schedule scalars are Python ints.  The numpy form follows the JAX
package's keys and dtypes exactly: ``buffer`` f32, and ``available_frames``
/ ``pos_num`` (per-stream ``FirState``) or ``start`` / ``fill`` /
``pos_num`` (sync tm fleet state) as 0-d int32 arrays, and on the wide
schedule ``pos_hi`` / ``pos_lo`` as 0-d uint32 arrays.  So
``jax.tree.map(np.asarray, jax_state)`` loads into the port, and
``state_to_numpy`` output saves with ``save_state`` unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.fir import resolve_device

__all__ = ["state_from_numpy", "state_to_numpy"]

#: schedule scalars and their numpy dtype
_INT_KEYS = {
    "available_frames": np.int32,
    "pos_num": np.int32,
    "start": np.int32,
    "fill": np.int32,
    "pos_hi": np.uint32,
    "pos_lo": np.uint32,
}


def state_from_numpy(state_np: dict, device="cuda") -> dict:
    """A port state on ``device`` from a dict of numpy arrays (the buffer
    is copied, never aliased)."""
    dev = resolve_device(device)
    if "buffer" not in state_np:
        raise ValueError("state has no 'buffer'")
    state = {}
    for key, value in state_np.items():
        arr = np.asarray(value)
        if key == "buffer":
            if arr.dtype != np.float32 or arr.ndim != 2:
                raise TypeError(
                    f"buffer must be 2-D float32, got {arr.ndim}-D {arr.dtype}"
                )
            state[key] = torch.tensor(arr, dtype=torch.float32, device=dev)
        elif key in _INT_KEYS:
            dtype = np.dtype(_INT_KEYS[key])
            if arr.shape != () or arr.dtype != dtype:
                raise TypeError(
                    f"{key} must be a 0-d {dtype} array (shared schedule), "
                    f"got shape {arr.shape} {arr.dtype}; per-stream schedules "
                    "belong to the vmapped fleet (ROADMAP A6)"
                )
            state[key] = int(arr)
        else:
            raise ValueError(f"unknown state key {key!r}")
    return state


def state_to_numpy(state: dict) -> dict:
    """The numpy form of a port state: ``buffer`` f32 on the host, each
    schedule scalar a 0-d int32 (or, ``pos_hi`` / ``pos_lo``, uint32)
    array; raises if one left its type's range."""
    out = {}
    for key, value in state.items():
        if key == "buffer":
            out[key] = value.detach().cpu().numpy().astype(np.float32, copy=True)
        elif key in _INT_KEYS:
            info = np.iinfo(_INT_KEYS[key])
            if not info.min <= value <= info.max:
                raise OverflowError(f"{key}={value} does not fit {info.dtype}")
            out[key] = np.asarray(value, info.dtype)
        else:
            raise ValueError(f"unknown state key {key!r}")
    return out
