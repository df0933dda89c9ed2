"""resampler_tpu_torch: the PyTorch / CUDA port of ``resampler_tpu``.

It imports ``torch`` and never ``jax``.  Ported so far: the polyphase FIR
engine's periodic path (stereo 44.1 -> 48 kHz and every other ratio with
a small reduced denominator), the per-stream ``ResamplerFir`` and the
phase-locked time-major fleet ``BatchedResamplerFir(synchronized=True)``,
whose banded contraction runs a hand-written CUDA kernel on the card
(``ops/fir_dma_kernel.py``).  Every public constructor takes
``device="cpu"`` (default) or ``"cuda"``.
"""

from .engine.batched import BatchedResamplerFir
from .engine.fir_wrapper import ResamplerFir
from .types import (
    Attenuation,
    InvalidInputBufferSize,
    InvalidOutputBufferSize,
    Latency,
    ResampleError,
    SampleRate,
    SampleRateFamily,
)

__all__ = [
    "Attenuation",
    "BatchedResamplerFir",
    "InvalidInputBufferSize",
    "InvalidOutputBufferSize",
    "Latency",
    "ResampleError",
    "ResamplerFir",
    "SampleRate",
    "SampleRateFamily",
]
