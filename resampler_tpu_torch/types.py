"""Public configuration types of the PyTorch port.

A verbatim copy of ``resampler_tpu/types.py`` (pure Python, no JAX), kept
in the port so that ``resampler_tpu_torch`` imports nothing of the JAX
package; tests/test_torch_design.py pins the two copies equal.  The
semantics (rate families, family multipliers, taps-per-latency, Kaiser
beta per attenuation) match the reference crate
(reference: src/lib.rs:166-275, src/resampler_fir.rs:97-162,
src/error.rs:1-26).
"""

from __future__ import annotations

import enum
import math

__all__ = [
    "SampleRate",
    "SampleRateFamily",
    "Latency",
    "Attenuation",
    "ResampleError",
    "InvalidInputBufferSize",
    "InvalidOutputBufferSize",
]


class ResampleError(ValueError):
    """Base error for resampling failures (reference: src/error.rs:1-26)."""


class InvalidInputBufferSize(ResampleError):
    """The input buffer handed to ``resample`` has an invalid size."""


class InvalidOutputBufferSize(ResampleError):
    """The output buffer handed to ``resample`` has an invalid size."""


class SampleRateFamily(enum.IntEnum):
    """Base sample-rate "family" every supported rate is a power-of-two
    multiple of (reference: src/lib.rs:256-275)."""

    Hz22050 = 22050
    Hz16000 = 16000
    Hz48000 = 48000


class SampleRate(enum.IntEnum):
    """All sample rates the fixed-table FFT resampler can operate on
    (reference: src/lib.rs:166-254).  Values are the rate in Hz."""

    Hz22050 = 22050
    Hz16000 = 16000
    Hz32000 = 32000
    Hz44100 = 44100
    Hz48000 = 48000
    Hz88200 = 88200
    Hz96000 = 96000
    Hz176400 = 176400
    Hz192000 = 192000
    Hz384000 = 384000

    @property
    def family(self) -> SampleRateFamily:
        if self.value % SampleRateFamily.Hz22050 == 0:
            return SampleRateFamily.Hz22050
        if self.value % SampleRateFamily.Hz16000 == 0:
            # 48k multiples are also 16k multiples; prefer the 48k family
            # like the reference does (reference: src/lib.rs:191-204).
            if self.value % SampleRateFamily.Hz48000 == 0:
                return SampleRateFamily.Hz48000
            return SampleRateFamily.Hz16000
        raise ValueError(f"unsupported sample rate {self.value}")

    @property
    def family_multiplier(self) -> int:
        """Power-of-two multiplier of this rate over its family base
        (reference: src/lib.rs:212-216)."""
        return self.value // self.family.value

    @classmethod
    def from_hz(cls, hz: int) -> "SampleRate":
        try:
            return cls(hz)
        except ValueError:
            raise ValueError(
                f"Unsupported sample rate: {hz}. Supported rates: "
                f"{sorted(int(r) for r in cls)}"
            ) from None


# 32000 is in the 16k family (32000 = 2*16000) even though it's not a 48k
# multiple; spot-check the family table matches the reference exactly.
assert SampleRate.Hz32000.family is SampleRateFamily.Hz16000
assert SampleRate.Hz96000.family is SampleRateFamily.Hz48000
assert SampleRate.Hz88200.family is SampleRateFamily.Hz22050


class Latency(enum.Enum):
    """Latency configuration of the FIR resampler: number of filter taps,
    named by algorithmic delay = taps/2 (reference: src/resampler_fir.rs:126-162)."""

    Sample8 = 16
    Sample16 = 32
    Sample32 = 64
    Sample64 = 128

    @property
    def taps(self) -> int:
        return self.value

    @classmethod
    def default(cls) -> "Latency":
        return cls.Sample64

    @classmethod
    def from_delay(cls, delay_samples: int) -> "Latency":
        try:
            return cls(delay_samples * 2)
        except ValueError:
            raise ValueError(
                f"Invalid latency value: {delay_samples}. Must be 8, 16, 32, or 64"
            ) from None


class Attenuation(enum.Enum):
    """Desired stopband attenuation of the FIR filter
    (reference: src/resampler_fir.rs:97-124)."""

    Db60 = 60
    Db90 = 90
    Db120 = 120

    @property
    def kaiser_beta(self) -> float:
        return {60: 7.0, 90: 10.0, 120: 13.0}[self.value]

    @classmethod
    def default(cls) -> "Attenuation":
        return cls.Db120

    @classmethod
    def from_db(cls, db: int) -> "Attenuation":
        try:
            return cls(db)
        except ValueError:
            raise ValueError(
                f"Invalid attenuation value: {db}. Must be 60, 90, or 120"
            ) from None


def reduce_ratio(input_rate_hz: int, output_rate_hz: int) -> tuple[int, int]:
    """Reduce ``in/out`` to lowest terms ``(L, M)`` so the FIR phase
    accumulator can run in exact integer arithmetic (position = num/M)."""
    if input_rate_hz <= 0:
        raise ValueError("input sample rate must be greater than zero")
    if output_rate_hz <= 0:
        raise ValueError("output sample rate must be greater than zero")
    g = math.gcd(input_rate_hz, output_rate_hz)
    return input_rate_hz // g, output_rate_hz // g
