"""The ``fft.pool`` cell's whole run at a size the CPU holds (3 streams,
3 stacks of the cell's 8 chunks, 2 warm calls; the fleet's magsplit plain
version off the card, so that ``resample_many`` takes the pool path): the
port against the reference, the control, the faults of ``test_cells.py``,
the traced run's metrics, and kernel B5's counts at the cell's shapes."""

import dataclasses
import time

import pytest
import torch

from perfbench import core, spans
from perfbench.tests.test_cells import _answer_altered, _half_batch, _state_unchanged
from perfbench.trace import Trace
from resampler_tpu_torch.utils import tracing

CELL = "fft.pool"
#: the magsplit backend: ``auto`` resolves to ``matmul`` off the card, which
#: loops the fleet step
CUT = dict(config=dict(streams=3, backend="magsplit"), traffic=dict(
    buffers=3, warm_steps=2, sample_gap=3, sample_slots=3, trace_steps=2))
B5 = core.load_module(core.HERE / "rooflines" / "b5.py")
METRICS = ("b5.roofline_pct", "fft_pool.stack_device_us", "fft_pool.pool_pct")


@pytest.fixture(autouse=True)
def one_thread_fresh_counters():
    """One torch thread (test workers share the machine's cores), and the
    program's counters zeroed: they are the process's, and other tests in
    this process step FFT fleets too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.reset_counters()
    yield
    torch.set_num_threads(threads)


def small_cell(**config) -> core.Cell:
    cell = core.find_cell(core.load_benchmark(), CELL)
    return dataclasses.replace(cell, config={**cell.config, **CUT["config"], **config},
                               traffic={**cell.traffic, **CUT["traffic"]})


def run_small(seed=2**31 + 8080, seconds=0.5, trace=False, control=False, patch=None,
              device="cpu", **config):
    return core.run_cell(small_cell(**config), seed, seconds, trace, device, time.perf_counter(),
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


def _per_chunk(fault):
    """``fault``, a patch of the fleet's ``resample``, planted in each
    chunk's output of ``resample_many``, the entry this cell's driver
    calls."""

    def patch(driver):
        fleet = driver.fleet
        many = fleet.resample_many
        fleet.resample = lambda out: out
        fault(driver)
        one = fleet.resample

        def faulty(chunks):
            out = many(chunks)
            for t in range(out.shape[0]):
                one(out[t])
            return out

        fleet.resample_many = faulty

    return patch


@pytest.mark.parametrize("fault", [_state_unchanged, _per_chunk(_half_batch),
                                   _per_chunk(_answer_altered)],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(fault):
    r = run_small(patch=fault, seconds=0.3)
    assert not r["correct"], r["checks"]


def test_traced_run_reports_the_pool_share():
    r = run_small(trace=True, seconds=0.2)
    assert r["correct"]
    assert {m["name"] for m in small_cell().per_layer} == set(METRICS)
    # on the CPU the trace has no device events: the counters read, the
    # device metrics do not; 7 of each call's 8 chunks take the pool step
    assert set(r["metrics"]) == {"fft_pool.pool_pct"}
    assert r["metrics"]["fft_pool.pool_pct"]["value"] == 87.5


def test_pool_share_reads_zero_where_the_fleet_loops():
    """The ``matmul`` backend loops the fleet step: no chunk is pooled."""
    r = run_small(trace=True, seconds=0.2, backend="matmul")
    assert r["correct"]
    assert r["metrics"]["fft_pool.pool_pct"]["value"] == 0.0


def pool_trace(steps=2, T=8, b4_us=300.0, b5_us=350.0, stack_us=400.0):
    """A hand-made trace of ``steps`` calls of ``resample_many``: chunk 0's
    launch in ``fft.contract``, ``T - 1`` in ``fft.pool``, one in
    ``fft.stack`` and the carry's clone in ``fft.keep``, each device event
    after the host has moved on."""
    host, device = [], []
    span = 10_000.0
    for k in range(steps):
        t = k * span
        host += [("perfbench.step", t, t + span), ("rtt.fft.step", t + 1, t + 100),
                 ("rtt.fft.upload", t + 2, t + 3),
                 ("rtt.fft.contract", t + 3, t + 10), ("cudaLaunchKernel", t + 4, t + 5)]
        device.append(("magsplit_kernel", t + 100, t + 100 + b4_us))
        edge = t + 100 + b4_us
        host.append(("rtt.fft.pool", t + 10, t + 80))
        for j in range(T - 1):
            host.append(("cudaLaunchKernel", t + 11 + j, t + 11.5 + j))
            device.append(("magsplit_kernel", edge, edge + b5_us))
            edge += b5_us
        host += [("rtt.fft.stack", t + 80, t + 90), ("cudaLaunchKernel", t + 81, t + 82),
                 ("rtt.fft.keep", t + 90, t + 99), ("cudaMemcpyAsync", t + 91, t + 92)]
        device += [("CatArrayBatchedCopy", edge, edge + stack_us),
                   ("Memcpy DtoD (Device -> Device)", edge + stack_us, edge + stack_us + 48)]
    return Trace(device=device, host=host, t0_us=0, t1_us=steps * span, steps=steps)


def test_device_metrics_read_by_span_not_by_kernel_name():
    """B4 and B5 launch one device kernel: B5's time is what ``fft.pool``
    launched, over the call's ``T - 1`` pool steps; the stack's is what
    ``fft.stack`` launched."""
    cell = core.find_cell(core.load_benchmark(), CELL)
    rec = core.Record(cell, 0, 0, 0, 0, [], core.Layers(), pool_trace())
    assert spans.attribute(rec.trace)["fft.pool"] == pytest.approx(2 * 7 * 350)
    read = {m: core.load_module(core.HERE / "metrics" / f"{m}.py").read for m in METRICS}
    bound = B5.bound_seconds(cell.config, cell.traffic)
    assert read["b5.roofline_pct"](rec) == pytest.approx(100 * bound / 350e-6)
    assert read["fft_pool.stack_device_us"](rec) == pytest.approx(400)
    # a program without the spans (the parent of this cell) gives nothing to read
    bare = pool_trace()
    bare.host = [h for h in bare.host if h[0] not in ("rtt.fft.pool", "rtt.fft.stack")]
    rec = core.Record(cell, 0, 0, 0, 0, [], core.Layers(), bare)
    assert read["b5.roofline_pct"](rec) is None
    assert read["fft_pool.stack_device_us"](rec) is None


def test_pool_share_reads_nothing_without_the_counters(monkeypatch):
    """A program that keeps no ``fft.chunks`` counter gives nothing to
    read, and raises nothing."""
    cell = core.find_cell(core.load_benchmark(), CELL)
    rec = core.Record(cell, 0, 0, 0, 0, [], core.Layers(), None)
    read = core.load_module(core.HERE / "metrics" / "fft_pool.pool_pct.py").read
    monkeypatch.setattr(spans, "counters", lambda: {"fir.steps": 4})
    assert read(rec) is None
    monkeypatch.setattr(spans, "counters", lambda: {"fft.chunks": 16, "fft.pool_steps": 14})
    assert read(rec) == 87.5


def test_b5_counts_the_work_at_the_cells_shapes():
    cell = core.find_cell(core.load_benchmark(), CELL)
    conf, mix = cell.config, cell.traffic
    flop, nbytes = B5.counts(conf, mix)
    # 16,384 rows x (rows 1600 + 2 x wc 960) x cols 294 x 4 groups, not
    # the 320 columns a group the kernel issues
    assert flop == 2 * 16384 * (1600 + 2 * 960) * 294 * 4
    assert round(flop / 1e9, 2) == 135.64
    assert round(nbytes / 1e6, 1) == 253.1
    assert B5.bound_seconds(conf, mix) == pytest.approx(flop / 989e12)
    assert round(B5.bound_seconds(conf, mix) * 1e6, 1) == 137.2


@pytest.mark.cuda
def test_small_cell_on_card(card):
    """Kernels B4 and B5 in the cell's whole run at the small size, traced:
    every new metric reads a number."""
    r = run_small(seed=20240601, device=card, trace=True, backend="auto")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) >= set(METRICS), r["metrics"]
    assert r["metrics"]["fft_pool.pool_pct"]["value"] == 87.5
    c = run_small(seed=20240601, device=card, control=True, backend="auto")
    assert not c["correct"], c["checks"]
