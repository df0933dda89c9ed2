"""The ``fir.async`` cell's whole run at a size the CPU holds (3 tenants,
3 buffers, 2 warm steps; the fleet's plain path off the card): the port
against the reference, the control, the faults of ``test_cells.py``, and
the traced run's metrics."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from perfbench import core
from perfbench.drivers.fir_async import Drift
from perfbench.tests.test_cells import _answer_altered, _half_batch, _state_unchanged

CELL = "fir.async"
CUT = dict(config=dict(streams=3), traffic=dict(
    buffers=3, warm_steps=2, sample_gap=3, sample_slots=3, trace_steps=2))


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: test workers share the machine's cores, and a
    step of small ops on eight threads each slows to a few steps a second,
    too few for a sampled step inside the window."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_cell() -> core.Cell:
    cell = core.find_cell(core.load_benchmark(), CELL)
    return dataclasses.replace(cell, config={**cell.config, **CUT["config"]},
                               traffic={**cell.traffic, **CUT["traffic"]})


def run_small(seed=2**31 + 12345, seconds=0.5, trace=False, control=False, patch=None,
              device="cpu"):
    return core.run_cell(small_cell(), seed, seconds, trace, device, time.perf_counter(),
                         control=control, patch=patch)


def test_port_passes_and_control_fails():
    r = run_small()
    checks = r["checks"]
    assert r["correct"], checks
    assert r["failed"] == 0
    assert checks["max_abs_err"]["value"] <= checks["max_abs_err"]["limit"] / 10
    assert set(r["metrics"]) == {m["name"] for m in small_cell().end_to_end}
    assert list(r)[-1] == "checks"
    c = run_small(control=True)
    assert not c["correct"], c["checks"]
    assert c["checks"]["max_abs_err"]["value"] > c["checks"]["max_abs_err"]["limit"]
    assert c["failed"] > 0


def test_traced_run_reports_only_the_cells_metrics():
    r = run_small(trace=True, seconds=0.2)
    assert r["correct"]
    names = {m["name"] for m in small_cell().per_layer}
    assert names == {"b6.roofline_pct", "fir_async.lanes_device_us",
                     "fir_async.slew_host_us", "fir_async.spread_frames"}
    # on the CPU the trace has no device events: the span's host time and
    # the counter read, the device metrics do not
    assert set(r["metrics"]) <= names
    assert {"fir_async.slew_host_us", "fir_async.spread_frames"} <= set(r["metrics"])
    assert 0.0 < r["metrics"]["fir_async.spread_frames"]["value"] < 1.0


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(fault):
    r = run_small(patch=fault, seconds=0.3)
    assert not r["correct"], r["checks"]


def _slew_dropped(driver):
    """The fleet's slew moves no tenant but reports the slews requested."""
    fleet = driver.fleet
    fleet.slew = lambda samples: np.asarray(samples, np.float64)


def test_a_slew_not_applied_is_not_correct():
    r = run_small(patch=_slew_dropped, seconds=0.3)
    assert not r["correct"], r["checks"]


def test_drift_keeps_the_spread_under_a_period():
    M = 44101
    phases = np.array([0, 1, M - 2, M - 1, 22050])
    drift = Drift(7, phases, M, 441)
    for _ in range(2000):
        v = drift.request()
        assert np.abs(v).max() <= 441
        drift.moved(v)
        assert drift.offset.min() >= 0 and drift.offset.max() <= M - 1


@pytest.mark.cuda
def test_small_cell_on_card(card):
    """Kernel B6 in the cell's whole run, at the small size."""
    r = run_small(seed=20240601, device=card)
    assert r["correct"], r["checks"]
    c = run_small(seed=20240601, device=card, control=True)
    assert not c["correct"], c["checks"]
