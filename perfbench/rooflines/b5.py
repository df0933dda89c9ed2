"""Kernel B5, the FFT fleet's pool step: kernel B4's projector reading
``prev`` and ``cur`` straight from two slots of the caller's chunk stack.
One call does B4's work at the configuration's shapes (``b4.counts``):
the band's bf16 products over ``cols`` columns, both f32 input chunks read
once, the f32 output written once, the band weights read once.

The count is of the work, ``cols`` columns a group, not of what the kernel
issues (``cols`` rounded up to whole 160-column tiles): at 48000 -> 44100
Hz (cols 294, issued 320) 135.64 GFLOP and 253.1 MB, bound 137.2 us by
operations, so the padding shows as a lower share.

B4 and B5 launch one device kernel, so B5's time is read from the span
that launches it (``rtt.fft.pool``), not from the kernel's name."""

from perfbench.core import HERE, load_module
from perfbench.rooflines.peaks import BF16_TFLOPS, bound_s

#: the span whose launches are B5's
SPAN = "fft.pool"


def counts(config: dict, traffic: dict) -> tuple[float, float]:
    """``(flop, bytes)`` of one B5 call: B4's at the configuration's shapes."""
    return load_module(HERE / "rooflines" / "b4.py").counts(config, traffic)


def bound_seconds(config: dict, traffic: dict) -> float:
    return bound_s(*counts(config, traffic), BF16_TFLOPS)
