"""resampler_tpu_torch: the PyTorch / CUDA port of ``resampler_tpu``.

It imports ``torch`` and never ``jax``.  Ported so far: the polyphase FIR
engine on every ratio the JAX package serves with its exact schedule --
the periodic path (stereo 44.1 -> 48 kHz and every other ratio with a
small reduced denominator), the Farrow and lerp paths for coprime ratios
(heavy downsampling included) and the wide two-word u32 schedule -- in
the per-stream ``ResamplerFir`` and the phase-locked time-major fleet
``BatchedResamplerFir(synchronized=True)``, whose contractions run
hand-written CUDA kernels on the card (``ops/fir_dma_kernel.py``: B1 for
periodic ratios, B2 and B3 for coprime ones); and the FFT overlap-add
engine on every backend (``magsplit``, ``matmul``, ``conv``,
``fft``/``rfft``), per stream (``ResamplerFft``) and as a fleet
(``BatchedResamplerFft``, with ``resample_many`` over the zero-copy chunk
pool), whose production magsplit backend runs hand-written CUDA kernels
on the card (``ops/fft_magsplit_kernel.py``: B4, and B5 for the pool);
the async multi-tenant FIR fleet
``BatchedResamplerFir(synchronized=True, sync_variant="async_tm")``
(per-stream join phases and slew on one ring, kernel B6,
``ops/fir_async_kernel.py``); the default vmapped fleet
``BatchedResamplerFir(synchronized=False)`` (each stream with its own
schedule; kernel B9 on periodic ratios, ``ops/fir_kernel.py``) and the
slide fleet ``sync_variant="slide"`` (kernel B8,
``ops/fir_sync_kernel.py``); and the serving runtime ``StreamingFleet``
(the vmapped fleet by default, ``synchronized=True`` or ``"async"``) over
a host staging pool.
Every public constructor takes ``device="cuda"`` (the default; it raises
without a GPU) or ``"cpu"``, which must be asked for.
"""

from .engine.batched import BatchedResamplerFft, BatchedResamplerFir
from .engine.fft import ResamplerFft
from .engine.fir_wrapper import ResamplerFir
from .runtime import StreamingFleet
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
    "BatchedResamplerFft",
    "BatchedResamplerFir",
    "InvalidInputBufferSize",
    "InvalidOutputBufferSize",
    "Latency",
    "ResampleError",
    "ResamplerFft",
    "ResamplerFir",
    "SampleRate",
    "SampleRateFamily",
    "StreamingFleet",
]
