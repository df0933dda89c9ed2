"""The fleet's host staging pool: a copy of the pure-Python path of
``resampler_tpu.utils.native.HostStreamPool`` (``push``, ``pending``,
``fill``).  It is the pool's plain form.  The JAX package's native C++ pool
(``csrc/resampler_host.cpp``) is not ported yet (ROADMAP A10).
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["HostStreamPool"]


class HostStreamPool:
    """Ragged per-stream FIFO queues drained into fixed-shape batches.

    Producers push interleaved audio per stream (thread-safe); the consumer
    calls :meth:`fill` to get the ``[n_streams, chunk_frames, channels]``
    zero-padded batch plus per-stream valid counts that the batched fleet
    step takes."""

    def __init__(self, n_streams: int, channels: int, capacity_frames: int = 1 << 16):
        self.n_streams = n_streams
        self.channels = channels
        self.capacity_frames = capacity_frames
        self._queues = [np.zeros(0, np.float32) for _ in range(n_streams)]
        self._lock = threading.Lock()

    def push(self, stream: int, values: np.ndarray) -> int:
        """Queue interleaved values; returns the number accepted (whole
        frames, up to the stream's capacity)."""
        values = np.ascontiguousarray(values, np.float32)
        with self._lock:
            q = self._queues[stream]
            room = self.capacity_frames * self.channels - q.size
            take = min(values.size - values.size % self.channels, max(room, 0))
            take -= take % self.channels
            self._queues[stream] = np.concatenate([q, values[:take]])
            return int(take)

    def pending(self, stream: int) -> int:
        with self._lock:
            return int(self._queues[stream].size)

    def fill(self, chunk_frames: int) -> tuple[np.ndarray, np.ndarray]:
        """Drain into ``(batch [B, chunk_frames, C], n_valid [B])``."""
        B, C = self.n_streams, self.channels
        batch = np.zeros((B, chunk_frames, C), np.float32)
        n_valid = np.zeros(B, np.int32)
        with self._lock:
            for s in range(B):
                q = self._queues[s]
                frames = min(q.size // C, chunk_frames)
                batch[s, :frames] = q[: frames * C].reshape(frames, C)
                self._queues[s] = q[frames * C :]
                n_valid[s] = frames
        return batch, n_valid
