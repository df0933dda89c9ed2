"""Stateful FIR wrapper: PyTorch port of
``resampler_tpu.engine.fir_wrapper.ResamplerFir``.

Same public surface (interleaved f32 numpy buffers, ``(consumed,
produced)`` counted in f32 values, ``buffer_size_output`` / ``delay`` /
``reset`` / ``slew`` / ``process``), plus ``device=`` (the card by
default; the CPU only when asked).  The stream's buffer lives on that
device; its schedule scalars are host ints.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import (
    Attenuation,
    InvalidInputBufferSize,
    InvalidOutputBufferSize,
    Latency,
    reduce_ratio,
)
from .fir import (
    MAX_CHUNK,
    FirConfig,
    fir_coefficients,
    fir_cutoff,
    fir_init,
    make_fir_step,
    resolve_device,
)

__all__ = ["ResamplerFir"]

#: Padded input chunk sizes (frames).  A small fixed set of chunk shapes
#: keeps the device allocator's block sizes bounded.
_BUCKETS = tuple(32 * (2**k) for k in range(8))  # 32 .. 4096


def _bucket_for(n_frames: int) -> int:
    n = min(n_frames, MAX_CHUNK)
    for b in _BUCKETS:
        if n <= b:
            return b
    return MAX_CHUNK


class ResamplerFir:
    """High-quality polyphase FIR audio resampler with a streaming API
    (reference: src/resampler_fir.rs:168-643).

    Example::

        r = ResamplerFir(2, 48000, 44100, Latency.Sample64,
                         Attenuation.Db90)  # device="cuda" by default
        out = np.zeros(r.buffer_size_output(), np.float32)
        consumed, produced = r.resample(input_interleaved, out)
    """

    def __init__(
        self,
        channels: int,
        input_rate,
        output_rate,
        latency: Latency = Latency.Sample64,
        attenuation: Attenuation = Attenuation.Db120,
        *,
        path: str = "auto",
        schedule: str = "exact",
        device="cuda",
    ) -> None:
        input_hz = int(input_rate)
        output_hz = int(output_rate)
        L, M = reduce_ratio(input_hz, output_hz)
        self._config = FirConfig(
            channels=channels, taps=latency.taps, ratio_num=L, ratio_den=M
        )
        if schedule == "reference":
            raise NotImplementedError(
                "schedule='reference' is not ported yet (ROADMAP A9)"
            )
        if schedule != "exact":
            raise ValueError(
                f"schedule must be 'exact' or 'reference', not {schedule!r}"
            )
        self._device = resolve_device(device)
        self._input_hz = input_hz
        self._output_hz = output_hz
        cutoff = fir_cutoff(latency.taps, attenuation, input_hz / output_hz)
        coeffs = fir_coefficients(latency.taps, attenuation, cutoff)
        self._step = make_fir_step(
            self._config, coeffs, path=path, device=self._device
        )
        self._state = fir_init(self._config, self._device)

    @classmethod
    def new_from_hz(
        cls,
        channels: int,
        input_rate_hz: int,
        output_rate_hz: int,
        latency: Latency = Latency.Sample64,
        attenuation: Attenuation = Attenuation.Db120,
        *,
        path: str = "auto",
        schedule: str = "exact",
        device="cuda",
    ) -> "ResamplerFir":
        """Construct from arbitrary integer sample rates
        (reference: src/resampler_fir.rs:295-404)."""
        return cls(
            channels, input_rate_hz, output_rate_hz, latency, attenuation,
            path=path, schedule=schedule, device=device,
        )

    @property
    def channels(self) -> int:
        return self._config.channels

    @property
    def taps(self) -> int:
        return self._config.taps

    @property
    def ratio(self) -> float:
        return self._input_hz / self._output_hz

    def buffer_size_output(self) -> int:
        """Maximum output buffer size (total f32 values) one call can fill
        (reference: src/resampler_fir.rs:455-465)."""
        return self._config.out_capacity * self._config.channels

    def delay(self) -> int:
        """Algorithmic delay in input samples (= taps/2)."""
        return self._config.delay

    def reset(self) -> None:
        """Clear all stream state (reference: src/resampler_fir.rs:638-642)."""
        self._state = fir_init(self._config, self._device)

    def slew(self, samples: float) -> float:
        """Shift the stream's sampling phase by ``samples`` input samples:
        ``pos += round(samples * M)``, clamped so the position never
        precedes the oldest buffered frame nor (int32 envelope only)
        leaves the int32 schedule envelope.  Returns the slew applied, in
        input samples (same semantics as the JAX package's
        ``ResamplerFir.slew``)."""
        M = self._config.ratio_den
        delta = int(round(float(samples) * M))
        wide = self._config.wide
        if wide:
            pos = self._state["pos_hi"] * M + self._state["pos_lo"]
            # no int32 envelope; heavy-downsample states carry pos past
            # capacity*M, so only the history clamp applies
            applied = max(delta, -pos)
        else:
            pos = self._state["pos_num"]
            ceiling = self._config.input_capacity * M
            applied = min(max(delta, -pos), max(0, ceiling - pos))
        if applied:
            new_pos = pos + applied
            if wide:
                moved = dict(pos_hi=new_pos // M, pos_lo=new_pos % M)
            else:
                moved = dict(pos_num=new_pos)
            self._state = dict(self._state, **moved)
        return applied / M

    @property
    def state(self) -> dict:
        """Stream state: ``buffer`` tensor plus host-int schedule scalars
        (``utils.state`` converts it to and from numpy)."""
        return self._state

    @state.setter
    def state(self, value: dict) -> None:
        self._state = value

    def resample(self, input, output) -> tuple[int, int]:
        """Consume interleaved ``input`` and write resampled frames into
        interleaved ``output``; returns ``(consumed, produced)`` in total
        f32 values (reference: src/resampler_fir.rs:509-621)."""
        C = self._config.channels
        input = np.asarray(input, dtype=np.float32)
        if input.ndim != 1 or input.size % C:
            raise InvalidInputBufferSize(
                f"input length {input.size} is not a multiple of channels {C}"
            )
        if not isinstance(output, np.ndarray) or output.ndim != 1 or output.size % C:
            raise InvalidOutputBufferSize(
                "output must be a 1-D numpy array with length a multiple of "
                f"channels {C}"
            )

        n_frames = input.size // C
        out_budget = min(output.size // C, self._config.out_capacity)
        bucket = _bucket_for(n_frames)
        chunk = np.zeros((bucket, C), np.float32)
        n_feed = min(n_frames, bucket)
        if n_feed:
            chunk[:n_feed] = input[: n_feed * C].reshape(n_feed, C)

        self._state, out, consumed, produced = self._step(
            self._state, torch.from_numpy(chunk), n_feed, out_budget
        )
        if produced:
            output[: produced * C] = out[:produced].cpu().numpy().reshape(-1)
        return consumed * C, produced * C

    def process(self, input) -> np.ndarray:
        """Feed ``input`` in chunks until fully consumed, returning the
        concatenated output (mirrors the reference CLI loop,
        reference: resample/src/main.rs:226-254)."""
        input = np.asarray(input, dtype=np.float32)
        out_buf = np.zeros(self.buffer_size_output(), np.float32)
        pieces = []
        offset = 0
        while offset < input.size:
            consumed, produced = self.resample(input[offset:], out_buf)
            pieces.append(out_buf[:produced].copy())
            offset += consumed
            if consumed == 0 and produced == 0:
                break
        return np.concatenate(pieces) if pieces else np.zeros(0, np.float32)

    def __repr__(self) -> str:
        return (
            f"ResamplerFir(channels={self.channels}, "
            f"{self._input_hz}->{self._output_hz} Hz, taps={self.taps}, "
            f"phases={self._config.phases}, device={self._device})"
        )
