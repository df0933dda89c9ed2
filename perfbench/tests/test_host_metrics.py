"""The readers of the program's host-issue counters and of its check span:
``fir_step.issue_us`` and ``fft_step.issue_us`` from ``fir.host_ns`` and
``fft.host_ns``, ``fir_step.check_host_us`` and ``fir_step.check_idle_pct``
from ``rtt.fir.check``; their values on hand-made records, ``None`` where
the counter or the span is missing (a program that keeps neither), and the
host-side readers in small traced runs on the CPU."""

import pytest
import torch

from perfbench import core, spans
from perfbench.tests import test_async_cell, test_farrow_cell, test_pool_cell
from perfbench.tests.small import run_small, small_cell
from perfbench.trace import Trace

#: the counter readers: ``(metric, its ns counter, its step counter)``
COUNTED = [("fir_step.issue_us", "fir.host_ns", "fir.steps"),
           ("fft_step.issue_us", "fft.host_ns", "fft.chunks")]
SPANNED = ["fir_step.check_host_us", "fir_step.check_idle_pct"]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread, as the cells' own small runs take: test workers
    share the machine's cores, and on many threads each the small steps
    slow past the window's first sampled step."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reader(name):
    return core.load_module(core.HERE / "metrics" / f"{name}.py").read


def record(trace, cell="fir.lockstep"):
    return core.Record(small_cell(cell), 0, 0, 0, 0, [], core.Layers(), trace)


def check_trace():
    """Two steps: ``fir.check`` opened three times a step, once in
    ``fir.contract`` with no launch inside it, the device busy over
    [10, 25] and [30, 60] of each step."""
    host, device = [("perfbench.step", 0, 100), ("perfbench.step", 100, 200)], []
    for t in (0, 100):
        host += [
            ("rtt.fir.step", t + 1, t + 61),
            ("rtt.fir.check", t + 2, t + 4),
            ("rtt.fir.append", t + 6, t + 10), ("cudaMemcpyAsync", t + 7, t + 8),
            ("rtt.fir.check", t + 5, t + 6),
            ("rtt.fir.contract", t + 10, t + 30),
            ("rtt.fir.check", t + 11, t + 14), ("aten::empty", t + 12, t + 13),
            ("cudaLaunchKernel", t + 20, t + 21),
        ]
        device += [("Memcpy DtoD (Device -> Device)", t + 10, t + 25),
                   ("tiled_contract_kernel", t + 30, t + 60)]
    return Trace(device=device, host=host, t0_us=0, t1_us=200, steps=2)


@pytest.mark.parametrize("name,ns,steps", COUNTED)
def test_issue_us_is_the_counted_ns_per_step(name, ns, steps, monkeypatch):
    monkeypatch.setattr(spans, "counters", lambda: {ns: 7_500_000, steps: 30_000, "x": 1})
    assert reader(name)(record(None)) == pytest.approx(0.25)


@pytest.mark.parametrize("name,ns,steps", COUNTED)
@pytest.mark.parametrize("counters", ["none", "no_ns", "no_steps", "zero_steps"])
def test_issue_us_is_none_without_its_counters(name, ns, steps, counters, monkeypatch):
    snap = {"none": None, "no_ns": {steps: 10}, "no_steps": {ns: 10},
            "zero_steps": {ns: 0, steps: 0}}[counters]
    monkeypatch.setattr(spans, "counters", lambda: snap)
    assert reader(name)(record(check_trace())) is None


def test_check_host_us_is_the_check_spans_self_time_per_step():
    # 2 + 1 + 3 us a step, nothing nested in them
    assert reader("fir_step.check_host_us")(record(check_trace())) == pytest.approx(6)


def test_check_idle_pct_is_the_idle_under_the_check_spans():
    # the device idles over [0, 10) and [25, 30) of each step: the checks
    # at [2, 4) and [5, 6) idle 3 us, the one in the contraction none
    assert reader("fir_step.check_idle_pct")(record(check_trace())) == pytest.approx(
        100 * 2 * 3 / 200)


def test_check_span_takes_no_device_time():
    """A launch after ``fir.check`` closed goes to the span around it."""
    got = spans.attribute(check_trace())
    assert got == {"fir.append": 30, "fir.contract": 60}


@pytest.mark.parametrize("name", SPANNED)
def test_check_readers_are_none_without_the_span(name):
    read = reader(name)
    assert read(record(None)) is None
    t = check_trace()
    bare = Trace(device=t.device, host=[h for h in t.host if h[0] != "rtt.fir.check"],
                 t0_us=0, t1_us=200, steps=2)
    assert read(record(bare)) is None


def test_check_idle_pct_is_none_off_the_card():
    t = check_trace()
    t.device.clear()
    assert reader("fir_step.check_idle_pct")(record(t)) is None
    assert reader("fir_step.check_host_us")(record(t)) == pytest.approx(6)


@pytest.mark.parametrize("cell,name,ns,steps", [
    ("fir.lockstep", "fir_step.issue_us", "fir.host_ns", "fir.steps"),
    ("fft.device", "fft_step.issue_us", "fft.host_ns", "fft.chunks"),
])
def test_traced_small_run_reports_the_issue_time(cell, name, ns, steps):
    assert name in {m["name"] for m in small_cell(cell).per_layer}
    r = run_small(cell, trace=True, seconds=0.2)
    assert r["correct"]
    c = spans.counters()
    got = r["metrics"]
    assert got[name]["value"] == pytest.approx(c[ns] / c[steps] / 1e3)
    assert got[name]["value"] > 0
    if cell == "fir.lockstep":
        # the checks' self time is a host reading; their idle share needs the device's
        assert "fir_step.check_host_us" in got and got["fir_step.check_host_us"]["value"] > 0
        assert "fir_step.check_idle_pct" not in got


#: the cells whose small form lives beside their own tests, and the new
#: readers each lists
OWN_SMALL = {
    "fir.farrow": (test_farrow_cell, {"fir_step.issue_us", "fir_step.check_host_us",
                                      "fir_step.check_idle_pct"}),
    "fir.async": (test_async_cell, {"fir_step.issue_us", "fir_step.check_host_us",
                                    "fir_step.check_idle_pct"}),
    "fft.pool": (test_pool_cell, {"fft_step.issue_us"}),
}


@pytest.mark.parametrize("cell", sorted(OWN_SMALL))
def test_traced_small_run_of_each_listed_cell_reports_the_host_readers(cell):
    """Every host-side reader this file holds reads in a traced small run
    of each cell that lists it; the checks' idle share, a device reading,
    does not on the CPU."""
    module, new = OWN_SMALL[cell]
    assert new <= {m["name"] for m in module.small_cell().per_layer}
    r = module.run_small(trace=True, seconds=0.2)
    assert r["correct"]
    host = new - {"fir_step.check_idle_pct"}
    assert host <= set(r["metrics"]) and "fir_step.check_idle_pct" not in r["metrics"]
    assert all(r["metrics"][name]["value"] > 0 for name in host)
