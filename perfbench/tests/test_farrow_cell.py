"""The ``fir.farrow`` cell's whole run at a size the CPU holds (3 streams,
3 buffers, 2 warm steps; the fleet's plain path off the card): the port
against the reference, the control, the faults of ``test_cells.py``, the
traced run's metrics, kernel B2's counts at the cell's shapes, and the
check's rows past the last polyphase branch."""

import dataclasses
import time

import pytest
import torch

from perfbench import core
from perfbench.drivers import fir_coprime
from perfbench.reference.fir_async import phase_weights
from perfbench.tests.test_cells import _answer_altered, _half_batch, _state_unchanged

CELL = "fir.farrow"
CUT = dict(config=dict(streams=3), traffic=dict(
    buffers=3, warm_steps=2, sample_gap=3, sample_slots=3, trace_steps=2))
B2 = core.load_module(core.HERE / "rooflines" / "b2.py")


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


def run_small(seed=2**31 + 4242, seconds=0.5, trace=False, control=False, patch=None,
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
    assert names == {"b2.roofline_pct", "fir_farrow.weights_device_us",
                     "fir_farrow.weights_host_us"}
    # on the CPU the trace has no device events: the span's host time reads,
    # the device metrics do not
    assert set(r["metrics"]) == {"fir_farrow.weights_host_us"}
    assert r["metrics"]["fir_farrow.weights_host_us"]["value"] > 0


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(fault):
    r = run_small(patch=fault, seconds=0.3)
    assert not r["correct"], r["checks"]


def test_b2_counts_the_outputs_a_steady_step_emits():
    cell = core.find_cell(core.load_benchmark(), CELL)
    conf, mix = cell.config, cell.traffic
    assert B2.emitted_per_step(conf, mix["chunk_frames"]) == 3969
    flop, nbytes = B2.counts(conf, mix)
    assert flop == 2 * 3969 * 128 * 2048  # taps-wide, every lane
    assert round(flop / 1e9, 3) == 2.081
    assert round(nbytes / 1e6, 1) == 66.6
    # bound by its operations at the f32 peak
    assert B2.bound_seconds(conf, mix) == pytest.approx(flop / 67e12)
    assert round(B2.bound_seconds(conf, mix) * 1e6, 2) == 31.06


class _Keep:
    """A sampler that keeps the steps listed, one slot each."""

    def __init__(self, steps):
        self.steps = list(steps)

    def slot(self, k):
        return self.steps.index(k) if k in self.steps else None


@pytest.mark.parametrize("clamped", [False, True], ids=["continued", "crate_clamp"])
def test_check_reads_the_continued_rows(monkeypatch, clamped):
    """Step 11 emits outputs 44102..44144, whose residues lie past the last
    polyphase branch: the check passes them on the continued rows and would
    refuse them on the crate's clamped ones."""
    cell = small_cell()
    driver = fir_coprime.Driver(cell.config, cell.traffic, 7, "cpu", core.Layers())
    driver.sampler = _Keep([5, 11])
    for _ in range(12):
        driver.step()
    assert sum(p for _, p in driver.counts[:11]) < 44102 < 44144 < sum(
        p for _, p in driver.counts)
    if clamped:
        monkeypatch.setattr(fir_coprime, "phase_weights",
                            lambda config: phase_weights(config, clamped=True))
    checks, failed = driver.check(cell.limits)
    assert checks["count_mismatch"]["value"] == 0
    if clamped:
        assert checks["max_abs_err"]["value"] > 1e-3 and failed == 1
    else:
        assert checks["max_abs_err"]["value"] < 2e-5 and failed == 0


@pytest.mark.cuda
def test_small_cell_on_card(card):
    """Kernel B2 in the cell's whole run, at the small size."""
    r = run_small(seed=20240601, device=card)
    assert r["correct"], r["checks"]
    c = run_small(seed=20240601, device=card, control=True)
    assert not c["correct"], c["checks"]
