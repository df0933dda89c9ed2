"""The ``fir.wide`` cell's whole run at a size the CPU holds (3 streams,
3 buffers, 2 warm steps; the fleet's plain path off the card): the port
against the reference, the control, the faults of ``test_cells.py`` and
two of the wide schedule's own, the traced run's metrics, and the
reference's rows against ``fir_async.phase_weights``'."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from perfbench import core
from perfbench.reference import fir_async, fir_wide
from perfbench.tests.test_cells import _answer_altered, _half_batch, _state_unchanged
from resampler_tpu_torch.engine import fir_fleets
from resampler_tpu_torch.utils import tracing

CELL = "fir.wide"
CUT = dict(config=dict(streams=3), traffic=dict(
    buffers=3, warm_steps=2, sample_gap=3, sample_slots=3, trace_steps=2))


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: test workers share the machine's cores."""
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


def test_the_pair_is_wide():
    conf = small_cell().config
    assert (conf["input_rate"], conf["output_rate"]) == (48000000, 48000066)
    _, L, M = fir_wide.branches(conf)
    assert (L, M) == (8000000, 8000011)
    assert M > 500_000  # past the int32 envelope's MAX_REDUCED_RATE


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
    tracing.reset_counters()
    r = run_small(trace=True, seconds=0.2)
    assert r["correct"]
    names = {m["name"] for m in small_cell().per_layer}
    assert names == {"fir_wide.schedule_us", "fir_wide.wide_pct"}
    # both read the program's counters, on the CPU as on the card
    assert set(r["metrics"]) == names
    assert r["metrics"]["fir_wide.wide_pct"]["value"] == 100.0
    assert r["metrics"]["fir_wide.schedule_us"]["value"] > 0


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(fault):
    r = run_small(patch=fault, seconds=0.3)
    assert not r["correct"], r["checks"]


def _wrap_dropped(monkeypatch):
    """The weights' frame carry is dropped: every lane whose ``pos_lo +
    split`` passes M reads its window one frame early."""
    residues = fir_fleets.lane_residues

    def dropped(s, M, pos):
        wrap, rem = residues(s, M, pos)
        return np.zeros_like(wrap), rem

    monkeypatch.setattr(fir_fleets, "lane_residues", dropped)


def _weights_from_pos_hi(monkeypatch):
    """The weights are formed from the frame word ``pos_hi`` in place of
    the subframe word ``pos_lo``."""
    weights = fir_fleets.farrow_weights
    monkeypatch.setattr(fir_fleets, "farrow_weights",
                        lambda fp, M, pos, ashift2: weights(fp, M, (pos[0], pos[0]), ashift2))


@pytest.mark.parametrize("fault", [_wrap_dropped, _weights_from_pos_hi],
                         ids=["wrap_carry_dropped", "weights_from_pos_hi"])
def test_a_broken_wide_schedule_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = run_small(seconds=0.3)
    assert not r["correct"], r["checks"]
    assert r["checks"]["max_abs_err"]["value"] > 1e-2
    assert r["checks"]["count_mismatch"]["value"] == 0


READERS = {name: core.load_module(core.HERE / "metrics" / f"{name}.py").read
           for name in ("fir_wide.schedule_us", "fir_wide.wide_pct")}


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("counters", [None, {}, {"fir.steps": 0}, {"fir.steps": 4}],
                         ids=["no_program_counters", "none_kept", "no_steps", "no_new_counters"])
def test_readers_are_none_without_their_counters(name, counters, monkeypatch):
    """A program without ``fir.schedule_ns`` / ``fir.wide_steps`` (the
    parent's) reads ``None``, and nothing raises."""
    from perfbench import spans

    monkeypatch.setattr(spans, "counters", lambda: counters)
    assert READERS[name](None) is None


def test_readers_divide_by_the_steps(monkeypatch):
    from perfbench import spans

    monkeypatch.setattr(spans, "counters", lambda: {
        "fir.steps": 4, "fir.schedule_ns": 480_000, "fir.wide_steps": 3})
    assert READERS["fir_wide.schedule_us"](None) == 120.0
    assert READERS["fir_wide.wide_pct"](None) == 75.0


#: 44100 -> 44101 Hz, the ``fir.farrow`` pair: ``phase_weights`` holds all
#: 44101 rows there
FARROW = dict(input_rate=44100, output_rate=44101, taps=128, phases=1024, kaiser_beta=10.0)


@pytest.mark.parametrize("clamped", [False, True], ids=["continued", "crate_clamp"])
def test_rows_equal_phase_weights_bit_for_bit(clamped):
    """Every residue's row equals ``phase_weights``' bit for bit, the 43
    rows past the last polyphase branch included; the crate's clamped rows
    differ there and only there."""
    W, L, M = fir_async.phase_weights(FARROW, clamped=clamped)
    ext, L2, M2 = fir_wide.branches(FARROW)
    assert (L, M) == (L2, M2) == (44100, 44101)
    rho = np.arange(M, dtype=np.int64)
    got = fir_wide.rows(ext, rho, M)
    past = rho * 1024 // M == 1023
    assert int(past.sum()) == 43
    if clamped:
        assert np.array_equal(got[~past], W[~past])
        assert not np.array_equal(got[past], W[past])
    else:
        assert np.array_equal(got.view(np.int64), W.view(np.int64))


def test_outputs_equal_the_table_references():
    """``outputs`` on rows formed per block equals ``fir.outputs`` on the
    whole table at 44100 -> 44101 Hz, control included, bit for bit."""
    from perfbench.reference import fir as ref

    W, L, M = fir_async.phase_weights(FARROW)
    ext, _, _ = fir_wide.branches(FARROW)
    x = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (4, 3000)))
    for control in (False, True):
        want = ref.outputs(x, 100, 200, 2500, torch.from_numpy(W), L, M, control=control,
                           block=4 * 128 * 37)
        got = fir_wide.outputs(x, 100, 200, 2500, ext, L, M, control=control,
                               block=4 * 128 * 37)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_small_cell_on_card(card):
    """The weights kernel on the wide word and kernel B2 in the cell's
    whole run, at the small size."""
    r = run_small(seed=20240601, device=card)
    assert r["correct"], r["checks"]
    c = run_small(seed=20240601, device=card, control=True)
    assert not c["correct"], c["checks"]
