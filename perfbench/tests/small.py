"""Each benchmark cell at a size the CPU holds: the cell's own traffic and
driver, the configuration cut to a few streams (the FFT fleet's ``auto``
backend resolves to ``matmul`` off the card)."""

from __future__ import annotations

import dataclasses
import time

from perfbench import core

SMALL = {
    "fir.lockstep": dict(config=dict(streams=3), traffic=dict(
        buffers=3, warm_steps=2, sample_gap=3, sample_slots=3, trace_steps=2)),
    "fft.device": dict(config=dict(streams=3), traffic=dict(
        buffers=3, warm_steps=2, sample_gap=3, sample_slots=3, trace_steps=2)),
    "fft.host": dict(config=dict(streams=3), traffic=dict(
        buffers=3, warm_steps=1, sample_gap=2, sample_slots=3, trace_steps=2)),
    "fir.ragged": dict(config=dict(streams=5), traffic=dict(
        schedule_steps=7, pool_frames=1 << 14, warm_steps=2, check_streams=3, trace_steps=2)),
}


def small_cell(name: str) -> core.Cell:
    cell = core.find_cell(core.load_benchmark(), name)
    cut = SMALL[name]
    return dataclasses.replace(
        cell,
        config={**cell.config, **cut["config"]},
        traffic={**cell.traffic, **cut["traffic"]},
    )


def run_small(name: str, seed: int = 12345, seconds: float = 0.5, trace: bool = False,
              control: bool = False, patch=None, limits=None) -> dict:
    cell = small_cell(name)
    if limits is not None:
        cell = dataclasses.replace(cell, limits={**cell.limits, **limits})
    return core.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                         control=control, patch=patch)
