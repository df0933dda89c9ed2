"""Fleet serving runtime: host staging pool + batched device resampling
(port of ``resampler_tpu.runtime``).

Producers push interleaved audio into per-stream queues
(``utils.native.HostStreamPool``); ``step()`` drains one fixed-shape
batch, runs one fleet step on the device and returns each stream's newly
produced samples as numpy.  Frames the fleet could not accept are held in
a per-stream host carry and fed first on the next step: nothing is lost,
order is preserved.

    fleet = StreamingFleet(n_streams=64, channels=8, input_rate=44100,
                           output_rate=48000)
    fleet.push(stream_id, interleaved_f32)
    outputs = fleet.step()     # list of n_streams interleaved arrays
"""

from __future__ import annotations

import numpy as np
import torch

from .engine.batched import BatchedResamplerFir
from .types import Attenuation, Latency
from .utils.native import HostStreamPool
from .utils import tracing

__all__ = ["StreamingFleet"]


class StreamingFleet:
    """N streaming FIR resamplers fed through a staging pool.

    ``synchronized=True`` drives the time-major ring fleet under a SHARED
    per-step valid count: each step feeds the fleet minimum and holds the
    excess in the per-stream carry (right for uniform producers).
    ``synchronized="async"`` keeps the shared cadence but gives every
    stream its own phase (``initial_positions``; per-stream ``slew`` on
    ``self.engine``).  ``synchronized=False`` (the default) drives the
    vmapped fleet: each stream's schedule and valid count are its own, so
    ragged producers never wait for the slowest."""

    def __init__(
        self,
        n_streams: int,
        channels: int,
        input_rate,
        output_rate,
        latency: Latency = Latency.Sample64,
        attenuation: Attenuation = Attenuation.Db120,
        *,
        chunk_frames: int = 2048,
        queue_capacity_frames: int = 1 << 16,
        mesh=None,
        synchronized: bool | str = False,
        initial_positions=None,
        device="cuda",
    ) -> None:
        if synchronized not in (True, False, "async"):
            # only the exact string "async" selects the async fleet; any
            # other truthy string would silently fall through to the
            # phase-locked fleet and drop initial_positions
            raise ValueError(
                f"synchronized must be True, False, or 'async', "
                f"not {synchronized!r}"
            )
        self.n_streams = n_streams
        self.channels = channels
        self.chunk_frames = chunk_frames
        self.synchronized = synchronized
        self.pool = HostStreamPool(
            n_streams, channels, capacity_frames=queue_capacity_frames
        )
        self.engine = BatchedResamplerFir(
            n_streams,
            channels,
            input_rate,
            output_rate,
            latency,
            attenuation,
            mesh=mesh,
            synchronized=bool(synchronized),
            sync_variant="async_tm" if synchronized == "async" else "tm",
            max_chunk=chunk_frames,
            initial_positions=initial_positions,
            device=device,
        )
        # Unconsumed frames awaiting the next device step, staged in ONE
        # left-aligned [B, cap, C] array + per-stream lengths so every
        # step's carry handling is a few whole-batch numpy ops instead of
        # an O(B) python loop of per-stream concats.
        self._carry = np.zeros((n_streams, 2 * chunk_frames, channels),
                               np.float32)
        self._carry_len = np.zeros(n_streams, np.int64)

    def push(self, stream: int, interleaved: np.ndarray) -> int:
        """Queue interleaved f32 audio for one stream (thread-safe).
        Returns the number of values accepted."""
        if not 0 <= stream < self.n_streams:
            raise IndexError(
                f"stream {stream} out of range [0, {self.n_streams})"
            )
        with tracing.span("runtime.push"):
            accepted = self.pool.push(stream, interleaved)
        refused = np.size(interleaved) - accepted
        if refused:
            tracing.count("runtime.values_refused", refused)
        return accepted

    def pending(self, stream: int) -> int:
        """Values queued (pool + carry) but not yet consumed on device."""
        return int(
            self.pool.pending(stream)
            + self._carry_len[stream] * self.channels
        )

    def _ensure_carry_capacity(self, needed: int) -> None:
        cap = self._carry.shape[1]
        if needed <= cap:
            return
        while cap < needed:
            cap *= 2
        grown = np.zeros((self.n_streams, cap, self.channels), np.float32)
        grown[:, : self._carry.shape[1]] = self._carry
        self._carry = grown

    def step(self) -> list[np.ndarray]:
        """Drain one batch (carry first, then pool), resample all streams
        on device, return each stream's newly produced samples.

        All host staging is whole-batch numpy (one ``take_along_axis``
        gather per reshuffle): no per-stream python work besides the
        pool's drain and the per-stream output slices."""
        with tracing.span("runtime.step"):
            outs = self._step()
        tracing.count("runtime.steps")
        tracing.count("runtime.carried_frames", int(self._carry_len.sum()))
        return outs

    def _step(self) -> list[np.ndarray]:
        B, n = self.n_streams, self.chunk_frames
        with tracing.span("runtime.drain"):
            drained, pool_valid = self.pool.fill(n)
        with tracing.span("runtime.stage"):
            batch, n_valid, rest, rest_len = self._stage(drained, pool_valid)

        out, consumed, produced, _peak = self.engine.resample(batch, n_valid)
        with tracing.span("runtime.fetch"):
            out = torch.as_tensor(out).cpu().numpy()
            consumed = np.asarray(consumed, np.int64)
            produced = np.asarray(produced, np.int64)

        with tracing.span("runtime.recarry"):
            self._recarry(batch, n_valid, consumed, rest, rest_len)

        with tracing.span("runtime.deliver"):
            return [
                out[s, : int(produced[s])].reshape(-1).copy() for s in range(B)
            ]

    def _stage(self, drained, pool_valid):
        """``[carry | drained]`` packed per stream: the batch of the
        fleet step, its valid counts, and what is left past the batch."""
        n = self.chunk_frames
        pool_valid = np.asarray(pool_valid, np.int64)
        carry_len = self._carry_len

        # combined = [carry | drained], valid length per stream
        self._ensure_carry_capacity(int(carry_len.max(initial=0)) + n)
        cap = self._carry.shape[1]
        combined = np.concatenate([self._carry, drained], axis=1)
        # drained data starts at column `cap`, but logically belongs right
        # after the carry: gather it into place in the same pass as the
        # batch/carry split below.
        lens = carry_len + pool_valid
        take = np.minimum(lens, n)

        pos = np.arange(cap + n)[None, :]
        src = np.where(
            pos < carry_len[:, None], pos, cap + pos - carry_len[:, None]
        )
        np.clip(src, 0, cap + n - 1, out=src)
        packed = np.take_along_axis(combined, src[:, :, None], axis=1)
        lane = np.arange(n)[None, :, None]
        batch = np.where(lane < take[:, None, None], packed[:, :n], 0.0)
        n_valid = take.astype(np.int32)

        # leftover after the take, shifted to the front of the carry
        rest_idx = take[:, None] + np.arange(cap)[None, :]
        np.clip(rest_idx, 0, cap + n - 1, out=rest_idx)
        rest = np.take_along_axis(packed, rest_idx[:, :, None], axis=1)
        return batch, n_valid, rest, lens - take

    def _recarry(self, batch, n_valid, consumed, rest, rest_len) -> None:
        """The carry rebuilt after the fleet step."""
        n = self.chunk_frames
        # frames the device couldn't accept go back to the FRONT of the
        # carry: carry' = [batch[consumed:valid] | rest]
        tail_len = n_valid - consumed
        new_len = tail_len + rest_len
        self._ensure_carry_capacity(int(new_len.max(initial=0)))
        cap = self._carry.shape[1]
        pos = np.arange(cap)[None, :]
        both = np.concatenate([batch, rest], axis=1)
        src = np.where(
            pos < tail_len[:, None],
            consumed[:, None] + pos,
            n + pos - tail_len[:, None],
        )
        np.clip(src, 0, both.shape[1] - 1, out=src)
        carry = np.take_along_axis(both, src[:, :, None], axis=1)
        carry[pos >= new_len[:, None]] = 0.0
        self._carry = carry
        self._carry_len = new_len

    def drain(self) -> list[np.ndarray]:
        """Step until no stream makes progress; per-stream concatenated
        outputs."""
        parts: list[list[np.ndarray]] = [[] for _ in range(self.n_streams)]
        while True:
            outs = self.step()
            if not any(o.size for o in outs):
                break
            for s, o in enumerate(outs):
                if o.size:
                    parts[s].append(o)
        return [
            np.concatenate(p) if p else np.zeros(0, np.float32) for p in parts
        ]
