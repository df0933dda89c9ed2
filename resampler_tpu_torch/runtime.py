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
        # Unconsumed frames awaiting the next device step: one persistent
        # left-aligned [B, cap, C] buffer + per-stream lengths.  A step
        # reads a row only up to its length and writes only the rows of
        # streams left with frames, so no row is ever zeroed.
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

        The drained batch goes to the fleet as it is: only the rows of
        streams that carry frames are repacked, in place, and only the
        streams left with frames after the step have their carry row
        rewritten.  With no stream carrying, staging copies nothing."""
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
            batch, n_valid, rest = self._stage(drained, pool_valid)

        out, consumed, produced, _peak = self.engine.resample(batch, n_valid)
        with tracing.span("runtime.fetch"):
            out = torch.as_tensor(out).cpu().numpy()
            consumed = np.asarray(consumed, np.int64)
            produced = np.asarray(produced, np.int64)

        with tracing.span("runtime.recarry"):
            self._recarry(batch, n_valid, consumed, rest)

        with tracing.span("runtime.deliver"):
            return [
                out[s, : int(produced[s])].reshape(-1).copy() for s in range(B)
            ]

    def _stage(self, drained, pool_valid):
        """The batch of the fleet step, its valid counts, and the frames
        past the batch (``{stream: frames}``, streams that carry only).

        The batch is ``drained`` itself: a stream with no carry feeds its
        drained row as the pool left it (zero past its ``pool_valid``,
        which is at most a chunk); a stream that carries gets its row
        rewritten in place as ``[carry | drained]`` cut to the chunk."""
        n = self.chunk_frames
        carry_len = self._carry_len
        n_valid = np.minimum(carry_len + pool_valid, n).astype(np.int32)
        carrying = np.flatnonzero(carry_len)
        tracing.count("runtime.staged_streams", carrying.size)
        rest = {}
        lens, valid = carry_len.tolist(), pool_valid.tolist()
        for s in carrying.tolist():
            row = np.concatenate(
                [self._carry[s, : lens[s]], drained[s, : valid[s]]]
            )
            drained[s, : min(lens[s] + valid[s], n)] = row[:n]
            rest[s] = row[n:]
        return drained, n_valid, rest

    def _recarry(self, batch, n_valid, consumed, rest) -> None:
        """The carry after the fleet step: frames the device did not
        accept go back to the FRONT, ``[batch[consumed:valid] | rest]``.
        Rows of streams left with no frame are not written."""
        tail_len = n_valid - consumed
        new_len = tail_len.astype(np.int64)
        for s, r in rest.items():
            new_len[s] += r.shape[0]
        self._ensure_carry_capacity(int(new_len.max(initial=0)))
        tails, starts = tail_len.tolist(), consumed.tolist()
        for s in np.flatnonzero(new_len).tolist():
            t, c = tails[s], starts[s]
            self._carry[s, :t] = batch[s, c : c + t]
            r = rest.get(s)
            if r is not None:
                self._carry[s, t : t + r.shape[0]] = r
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
