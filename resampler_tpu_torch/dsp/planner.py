"""FFT resampling planner: exact chunk-size table between sample-rate families.

A verbatim copy of ``resampler_tpu/dsp/planner.py`` (pure Python, no JAX),
kept in the port so that ``resampler_tpu_torch`` imports nothing of the
JAX package; tests/test_torch_fft_design.py pins the two copies equal.
Sizes are identical to the reference (reference: src/fft/planner.rs:15-245),
giving the same latency, the same 0% ratio error, and the same public
``chunk_size_input/output`` values.
"""

from __future__ import annotations

import dataclasses

from ..types import SampleRate, SampleRateFamily

__all__ = ["ConversionConfig", "plan_conversion"]

#: Base (minimum-latency) FFT sizes per family pair with 0% ratio error
#: (reference: src/fft/planner.rs:45-156).
_BASE_SIZES: dict[tuple[SampleRateFamily, SampleRateFamily], tuple[int, int]] = {
    (SampleRateFamily.Hz48000, SampleRateFamily.Hz48000): (2, 2),
    (SampleRateFamily.Hz22050, SampleRateFamily.Hz22050): (2, 2),
    (SampleRateFamily.Hz16000, SampleRateFamily.Hz16000): (2, 2),
    (SampleRateFamily.Hz22050, SampleRateFamily.Hz48000): (588, 1280),
    (SampleRateFamily.Hz48000, SampleRateFamily.Hz22050): (1280, 588),
    (SampleRateFamily.Hz16000, SampleRateFamily.Hz48000): (64, 192),
    (SampleRateFamily.Hz48000, SampleRateFamily.Hz16000): (192, 64),
    (SampleRateFamily.Hz16000, SampleRateFamily.Hz22050): (640, 882),
    (SampleRateFamily.Hz22050, SampleRateFamily.Hz16000): (882, 640),
}

#: Minimum input samples per chunk after throughput scaling
#: (reference: src/fft/planner.rs:209-227).
TARGET_INPUT_SAMPLES = 512


@dataclasses.dataclass(frozen=True)
class ConversionConfig:
    """Exact FFT chunk sizes for one rate pair."""

    fft_size_input: int
    fft_size_output: int

    def scale_for_throughput(self) -> "ConversionConfig":
        """Scale both sizes by the next power of two so the input chunk has
        at least ``TARGET_INPUT_SAMPLES`` samples
        (reference: src/fft/planner.rs:212-245)."""
        multiplier = max(
            1, -(-TARGET_INPUT_SAMPLES // self.fft_size_input)
        )  # ceil div
        multiplier = _next_power_of_two(multiplier)
        return ConversionConfig(
            fft_size_input=self.fft_size_input * multiplier,
            fft_size_output=self.fft_size_output * multiplier,
        )


def _next_power_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def plan_conversion(
    input_rate: SampleRate, output_rate: SampleRate
) -> ConversionConfig:
    """Exact base chunk sizes for ``input_rate -> output_rate``, scaled by
    the power-of-two family multipliers
    (reference: src/fft/planner.rs:35-179)."""
    base_in, base_out = _BASE_SIZES[(input_rate.family, output_rate.family)]
    return ConversionConfig(
        fft_size_input=base_in * input_rate.family_multiplier,
        fft_size_output=base_out * output_rate.family_multiplier,
    )
