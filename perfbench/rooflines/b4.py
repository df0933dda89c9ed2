"""Kernel B4, the FFT fleet's banded magsplit projector: the work one call
needs, frozen from the port's smoke script (``chip_smoke.py
phase_magsplit_kernels``).

The operator is banded: each group of ``cols`` output columns reads
``rows`` input rows in its first pass and ``wc`` correction rows in each of
its other two, over ``s`` groups, in bf16 products (three passes keep the
99 dB floor).  Bytes: both f32 input chunks read once, the f32 output
written once, the bf16 band weights read once.  The band of each
configuration is a data file, ``b4_bands/<configuration>.json``."""

import json
from pathlib import Path

from perfbench.rooflines.peaks import BF16_TFLOPS, bound_s

#: the device kernel's name, as the profiler reports it
KERNEL = "magsplit_kernel"

BANDS = Path(__file__).resolve().parent / "b4_bands"


def band(config: dict) -> dict:
    """The configuration's band geometry; a configuration without one is an
    error, never a silent metric."""
    path = BANDS / f"{config['name']}.json"
    if not path.is_file():
        raise FileNotFoundError(f"kernel B4 has no band geometry for {config['name']!r}: add {path}")
    with open(path) as f:
        return json.load(f)


def counts(config: dict, traffic: dict) -> tuple[float, float]:
    """``(flop, bytes)`` of one call at the configuration's shapes."""
    g = band(config)
    rows, wc, cols, s = g["rows"], g["wc"], g["cols"], g["s"]
    n_in, n_out = config["fft_size_input"], config["fft_size_output"]
    R = config["streams"] * config["channels"]
    flop = 2 * R * (rows + 2 * wc) * cols * s
    nbytes = 4 * (2 * R * n_in + R * n_out) + 2 * s * (rows + 2 * wc) * cols
    return float(flop), float(nbytes)


def bound_seconds(config: dict, traffic: dict) -> float:
    return bound_s(*counts(config, traffic), BF16_TFLOPS)
