"""Kernel B1, the tm fleet's banded contraction: the work one steady step
needs at the cell's shapes, from the reference schedule (not from what the
kernel issues).

A steady step emits ``E`` outputs on every lane, each over its ``taps``
taps (taps-wide f32 multiply-adds); it reads the input frames those outputs
span once, the polyphase table's ``M`` rows once, and writes the ``E``
outputs of every lane once.  At 44.1 -> 48 kHz on 4096-frame chunks: E 4320
(27 periods of M 160), 2.265 GFLOP, 69.0 MB."""

from perfbench.reference.fir import Schedule, out_capacity, reduced_ratio

from perfbench.rooflines.peaks import F32_TFLOPS, bound_s

#: the device kernel's name, as the profiler reports it
KERNEL = "band_contract_kernel"

#: full chunks fed to the reference schedule before a step is steady
STEADY_STEPS = 8


def emitted_per_step(config: dict, chunk_frames: int) -> int:
    """The outputs a steady step emits on each lane, fed full chunks."""
    L, M = reduced_ratio(config["input_rate"], config["output_rate"])
    sched = Schedule(L, M, config["taps"], config["input_capacity"], out_capacity(config))
    for _ in range(STEADY_STEPS):
        _, emitted = sched.feed(chunk_frames)
    return int(emitted[0])


def counts(config: dict, traffic: dict) -> tuple[float, float]:
    """``(flop, bytes)`` of one steady step at the cell's shapes."""
    L, M = reduced_ratio(config["input_rate"], config["output_rate"])
    taps, R = config["taps"], config["streams"] * config["channels"]
    E = emitted_per_step(config, traffic["chunk_frames"])
    frames = (E - 1) * L // M + taps + 1
    flop = 2 * E * taps * R
    nbytes = 4 * (frames * R + M * taps + E * R)
    return float(flop), float(nbytes)


def bound_seconds(config: dict, traffic: dict) -> float:
    return bound_s(*counts(config, traffic), F32_TFLOPS)
