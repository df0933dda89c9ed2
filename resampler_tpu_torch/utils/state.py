"""Carry stream state between numpy (and so the JAX package or a
``resampler_tpu.utils.checkpoint`` ``.npz``) and the port.

The port keeps a state as a dict: the carry tensors are float32, the
schedule scalars are Python ints.  The numpy form follows the JAX
package's keys and dtypes exactly:

- FIR: ``buffer`` f32 ``[rows, lanes]``, and ``available_frames`` /
  ``pos_num`` (per-stream ``FirState``) or ``start`` / ``fill`` /
  ``pos_num`` (sync tm fleet state) as 0-d int32 arrays, and on the wide
  schedule ``pos_hi`` / ``pos_lo`` as 0-d uint32 arrays.  The async tm
  fleet keeps its positions per stream: ``pos_num`` ``[B]`` int32, or
  ``pos_hi`` / ``pos_lo`` ``[B]`` uint32, beside a 0-d ``start`` /
  ``fill`` (the port holds them as ``[B]`` int64 numpy arrays).  The
  vmapped fleet's state has a rank-3 ``buffer [B, C, alloc]`` and no
  ``start``: ``available_frames`` and ``pos_num`` (or ``pos_hi`` /
  ``pos_lo``) are ``[B]`` arrays, held as ``[B]`` int64 numpy; the slide
  fleet's has the same buffer beside 0-d schedule scalars;
- FFT: ``prev`` (magsplit, conv) or ``overlap`` (matmul, fft) f32
  ``[C, *]`` per stream or ``[B, C, *]`` per fleet, or the pool step's
  ``prev_idx`` as a 0-d int32 array.

So ``jax.tree.map(np.asarray, jax_state)`` loads into the port, and
``state_to_numpy`` output saves with ``save_state`` unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.fir import resolve_device

__all__ = ["state_from_numpy", "state_to_numpy"]

#: carry tensors and the ranks they may have
_FLOAT_KEYS = {"buffer": (2, 3), "prev": (2, 3), "overlap": (2, 3)}
#: schedule scalars and their numpy dtype
_INT_KEYS = {
    "available_frames": np.int32,
    "pos_num": np.int32,
    "start": np.int32,
    "fill": np.int32,
    "pos_hi": np.uint32,
    "pos_lo": np.uint32,
    "prev_idx": np.int32,
}
#: the position words the async tm fleet keeps per stream
_STREAM_KEYS = ("pos_num", "pos_hi", "pos_lo")


def _per_stream(key: str, arr: np.ndarray, state_np: dict) -> bool:
    """Whether ``arr`` is a legal ``[B]`` schedule array: the async tm
    fleet's positions beside ``start``, or any schedule word of the
    vmapped fleet (a ``[B, C, alloc]`` buffer, no ``start``)."""
    if arr.ndim != 1:
        return False
    if "start" in state_np:
        return key in _STREAM_KEYS
    buf = np.asarray(state_np.get("buffer", np.zeros(())))
    return buf.ndim == 3 and arr.shape[0] == buf.shape[0]


def state_from_numpy(state_np: dict, device="cuda") -> dict:
    """A port state on ``device`` from a dict of numpy arrays (carry
    tensors are copied, never aliased)."""
    dev = resolve_device(device)
    if not ({"buffer", "prev", "overlap", "prev_idx"} & state_np.keys()):
        raise ValueError(
            "state has no carry ('buffer', 'prev', 'overlap' or 'prev_idx')"
        )
    state = {}
    for key, value in state_np.items():
        arr = np.asarray(value)
        if key in _FLOAT_KEYS:
            if arr.dtype != np.float32 or arr.ndim not in _FLOAT_KEYS[key]:
                raise TypeError(
                    f"{key} must be float32 of rank {_FLOAT_KEYS[key]}, got "
                    f"{arr.ndim}-D {arr.dtype}"
                )
            state[key] = torch.tensor(arr, dtype=torch.float32, device=dev)
        elif key in _INT_KEYS:
            dtype = np.dtype(_INT_KEYS[key])
            if arr.dtype == dtype and arr.shape == ():
                state[key] = int(arr)
            elif arr.dtype == dtype and _per_stream(key, arr, state_np):
                state[key] = arr.astype(np.int64)  # one per stream
            else:
                raise TypeError(
                    f"{key} must be a 0-d {dtype} array (a shared schedule), or "
                    f"a [B] one: the async tm fleet's positions beside 'start', "
                    f"or the vmapped fleet's schedule beside a [B, C, alloc] "
                    f"buffer; got shape {arr.shape} {arr.dtype}"
                )
        else:
            raise ValueError(f"unknown state key {key!r}")
    return state


def state_to_numpy(state: dict) -> dict:
    """The numpy form of a port state: each carry tensor f32 on the host,
    each schedule scalar a 0-d int32 (or, ``pos_hi`` / ``pos_lo``, uint32)
    array, and per-stream positions ``[B]`` arrays of the same types;
    raises if one left its type's range."""
    out = {}
    for key, value in state.items():
        if key in _FLOAT_KEYS:
            out[key] = value.detach().cpu().numpy().astype(np.float32, copy=True)
        elif key in _INT_KEYS:
            info = np.iinfo(_INT_KEYS[key])
            arr = np.asarray(value)
            if arr.size and not info.min <= arr.min() <= arr.max() <= info.max:
                raise OverflowError(f"{key}={value} does not fit {info.dtype}")
            out[key] = arr.astype(info.dtype)
        else:
            raise ValueError(f"unknown state key {key!r}")
    return out
