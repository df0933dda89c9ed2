"""Each cell's whole run at a size the CPU holds: the references against
the port (its plain kernels on the CPU), the control, and the faults the
check has to catch."""

import numpy as np
import pytest
import torch

from perfbench.reference import fir as ref
from perfbench.tests.small import SMALL, run_small, small_cell

CELLS = sorted(SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_port_passes_and_control_fails(cell):
    r = run_small(cell)
    checks = r["checks"]
    assert r["correct"], checks
    assert r["failed"] == 0
    assert checks["max_abs_err"]["value"] <= checks["max_abs_err"]["limit"] / 10
    assert set(r["metrics"]) == {m["name"] for m in small_cell(cell).end_to_end}
    assert list(r)[-1] == "checks"
    # the reference in TF32, judged in the program's place, is not correct
    c = run_small(cell, control=True)
    assert not c["correct"], c["checks"]
    assert c["checks"]["max_abs_err"]["value"] > c["checks"]["max_abs_err"]["limit"]
    assert c["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics_it_can_read(cell):
    r = run_small(cell, trace=True, seconds=0.2)
    assert r["correct"]
    names = {m["name"] for m in small_cell(cell).per_layer}
    # on the CPU the trace has no device events: only the host-clock metrics read
    assert set(r["metrics"]) <= names
    assert r["device"]["window_s"] > 0
    assert len(r["breakdown"]["idle_gaps"]) <= 10


def _state_unchanged(driver):
    """The fleet step hands back the state it was given."""
    fleet = getattr(driver.fleet, "engine", driver.fleet)
    if hasattr(fleet, "_fleet_step"):
        inner = fleet._fleet_step

        def frozen(state, *args):
            new_state, *rest = inner(state, *args)
            return (state, *rest)

        fleet._fleet_step = frozen
    else:  # the FFT fleet keeps its carry through _keep
        fleet._keep = lambda state, callers: fleet._state


def _half_batch(driver):
    """The second half of the streams is left out: their outputs stay zero."""
    fleet = getattr(driver.fleet, "engine", driver.fleet)
    inner = fleet.resample

    def half(*args, **kwargs):
        got = inner(*args, **kwargs)
        out = got[0] if isinstance(got, tuple) else got
        out[out.shape[0] // 2 :] = 0.0
        return got

    fleet.resample = half


def _answer_altered(driver):
    """One sample of every step's output is off by 1e-3."""
    fleet = getattr(driver.fleet, "engine", driver.fleet)
    inner = fleet.resample

    def altered(*args, **kwargs):
        got = inner(*args, **kwargs)
        out = got[0] if isinstance(got, tuple) else got
        out.reshape(-1)[3] += 1e-3
        return got

    fleet.resample = altered


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    r = run_small(cell, patch=fault, seconds=0.3)
    assert not r["correct"], r["checks"]


def test_reference_schedule_and_samples_match_the_port_per_stream():
    """The reference's schedule and direct sums against the port's
    single-stream resampler on ragged chunks (its plain path on the CPU)."""
    import resampler_tpu_torch as rtt

    conf = small_cell("fir.ragged").config
    fleet = rtt.BatchedResamplerFir(1, 2, 44100, 48000, rtt.Latency.Sample64,
                                    rtt.Attenuation.Db90, device="cpu")
    W, L, M = ref.phase_weights(conf)
    sched = ref.Schedule(L, M, conf["taps"], conf["input_capacity"], ref.out_capacity(conf))
    rng = np.random.default_rng(5)
    fed, outs = [], []
    for n in (700, 4096, 1, 0, 3000, 4096, 129):
        chunk = rng.uniform(-1, 1, (1, 4096, 2)).astype(np.float32)
        out, consumed, produced, _ = fleet.resample(chunk, np.array([n]))
        taken, emitted = sched.feed(n)
        assert (int(consumed[0]), int(produced[0])) == (int(taken[0]), int(emitted[0]))
        fed.append(chunk[0, : int(consumed[0])])
        outs.append(out[0, : int(produced[0])].numpy())
    x = torch.from_numpy(np.concatenate(fed).T.astype(np.float64))
    got = np.concatenate(outs).T
    want = ref.outputs(x, 0, 0, got.shape[1], torch.from_numpy(W), L, M).numpy()
    assert np.abs(got - want).max() < 5e-6


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_small_cell_on_card(card, cell):
    """The card's kernels (the FFT fleet's magsplit among them) in each
    cell's whole run, at the small size."""
    import time

    from perfbench import core

    r = core.run_cell(small_cell(cell), 20240601, 0.5, False, card, time.perf_counter())
    assert r["correct"], r["checks"]
    c = core.run_cell(small_cell(cell), 20240601, 0.5, False, card, time.perf_counter(), control=True)
    assert not c["correct"], c["checks"]
