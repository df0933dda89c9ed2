"""The readings of the program's spans (``perfbench/spans.py``) and their
metric readers: self time, device time by launch, idle time under a span,
on hand-made traces; ``None`` where a reader has nothing to read; the
host-side readers in each cell's small traced run on the CPU."""

import pytest

from perfbench import core, spans
from perfbench.tests.small import run_small, small_cell
from perfbench.trace import Trace

#: the readers this file holds, by the cell that reports each
NEW = {
    "fir.ragged": ["runtime.push_ms", "runtime.drain_ms", "runtime.stage_ms", "runtime.fetch_ms",
                   "runtime.deliver_ms", "runtime.carried_frames"],
    "fir.lockstep": ["fir_step.ingest_device_us", "fir_step.epilogue_device_us",
                     "fir_step.compact_device_us", "fir_step.compact_pct", "fir_step.idle_pct"],
    "fft.device": ["fft_step.keep_device_us", "fft_step.idle_pct"],
}
#: those that read the program's counters or host spans, and so read on the CPU too
HOST_SIDE = {
    "fir.ragged": set(NEW["fir.ragged"]),
    "fir.lockstep": {"fir_step.compact_pct"},
    "fft.device": set(),
}
ALL = [(cell, m) for cell, names in NEW.items() for m in names]


def reader(name):
    return core.load_module(core.HERE / "metrics" / f"{name}.py").read


def record(trace, cell="fir.lockstep"):
    return core.Record(small_cell(cell), 0, 0, 0, 0, [], core.Layers(), trace)


def step_trace():
    """Two steps of a hand-made fleet: host spans with launches inside
    them, the device events those launches made, in launch order."""
    host = [("perfbench.step", 0, 100), ("perfbench.step", 100, 200)]
    device = []
    for t in (0, 100):
        host += [
            ("rtt.fir.step", t + 1, t + 61),
            ("rtt.fir.relayout_in", t + 2, t + 6), ("cudaLaunchKernel", t + 3, t + 4),
            ("rtt.fir.append", t + 6, t + 10), ("cudaMemcpyAsync", t + 7, t + 8),
            ("rtt.fir.contract", t + 10, t + 30), ("cudaLaunchKernel", t + 20, t + 21),
            ("rtt.fir.peak", t + 30, t + 40), ("aten::abs", t + 31, t + 34),
            ("cudaLaunchKernel", t + 32, t + 33), ("cudaLaunchKernel", t + 35, t + 36),
            ("cudaStreamSynchronize", t + 61, t + 99),
        ]
        device += [
            ("copy_kernel", t + 10, t + 20), ("Memcpy DtoD (Device -> Device)", t + 20, t + 25),
            ("band_contract_kernel", t + 30, t + 60), ("AbsFunctor", t + 60, t + 62),
            ("reduce_kernel", t + 70, t + 72),
        ]
    return Trace(device=device, host=host, t0_us=0, t1_us=200, steps=2)


def test_self_time_subtracts_nested_spans():
    t = Trace(device=[], host=[("rtt.a", 0, 10), ("rtt.b", 1, 4), ("rtt.c", 4, 6), ("rtt.d", 4.5, 5),
                               ("aten::x", 7, 9), ("rtt.a", 20, 25)], t0_us=0, t1_us=30, steps=1)
    assert spans.self_us(t, {"a"}) == pytest.approx(10 - 3 - 2 + 5)
    assert spans.self_us(t, {"c"}) == pytest.approx(1.5)
    assert spans.self_us(t, {"b", "d"}) == pytest.approx(3.5)
    assert spans.self_us(t, {"absent"}) == 0


def test_device_time_follows_the_launch_not_the_clock():
    t = step_trace()
    got = spans.attribute(t)
    # every event ran after its launching span had closed on the host
    assert got == {"fir.relayout_in": 20, "fir.append": 10, "fir.contract": 60, "fir.peak": 8}
    rec = record(t)
    assert reader("fir_step.ingest_device_us")(rec) == pytest.approx(15)
    assert reader("fir_step.epilogue_device_us")(rec) == pytest.approx(4)


@pytest.mark.parametrize("fault", ["launch_missing", "kinds_disagree", "device_event_extra"])
def test_no_attribution_where_launches_and_events_do_not_pair(fault):
    t = step_trace()
    if fault == "launch_missing":
        t.host.remove(("cudaMemcpyAsync", 7, 8))
    elif fault == "kinds_disagree":
        t.device[1] = ("a_kernel", 20, 25)
    else:
        t.device.append(("Memset (Device)", 150, 151))
    assert spans.attribute(t) is None
    assert reader("fir_step.ingest_device_us")(record(t)) is None


def test_idle_under_a_span():
    t = step_trace()
    # device busy [10, 25], [30, 62], [70, 72] in each step; fir.step [1, 61]
    # idles over [1, 10) and [25, 30)
    assert spans.idle_under_us(t, {"fir.step"}) == pytest.approx(2 * (9 + 5))
    assert reader("fir_step.idle_pct")(record(t)) == pytest.approx(100 * 28 / 200)


def test_compaction_time_is_per_compaction():
    t = step_trace()
    t.host += [("rtt.fir.compact", 150, 160), ("cudaLaunchKernel", 151, 152)]
    t.device.append(("FillFunctor", 190, 197))
    assert reader("fir_step.compact_device_us")(record(t)) == pytest.approx(7)
    assert reader("fir_step.compact_device_us")(record(step_trace())) is None


def test_host_spans_leave_the_device_readings_as_they_were():
    """The program's spans are host events: the idle share, the copies, the
    top device ops and the gaps' lengths read as in a trace without them."""
    with_spans = step_trace()
    bare = Trace(device=with_spans.device,
                 host=[h for h in with_spans.host if not h[0].startswith(spans.PREFIX)],
                 t0_us=0, t1_us=200, steps=2)
    for name in ("device.idle_pct", "device.copy_ms"):
        assert reader(name)(record(with_spans)) == reader(name)(record(bare))
    assert with_spans.top_ops() == bare.top_ops()
    assert [g[1] for g in with_spans.idle_gaps()] == [g[1] for g in bare.idle_gaps()]


@pytest.mark.parametrize("cell,name", ALL)
def test_reader_is_none_without_its_spans_or_counters(cell, name, monkeypatch):
    read = reader(name)
    assert read(record(None, cell)) is None
    bare = Trace(device=[("k", 0, 1)], host=[("aten::abs", 0, 1)], t0_us=0, t1_us=2, steps=1)
    monkeypatch.setattr(spans, "counters", lambda: None)
    assert read(record(bare, cell)) is None


@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_small_run_reports_the_host_side_readers(cell):
    r = run_small(cell, trace=True, seconds=0.2)
    assert r["correct"]
    got = set(r["metrics"])
    assert HOST_SIDE[cell] <= got
    # off the card no device reading is made
    assert not (set(NEW[cell]) - HOST_SIDE[cell]) & got
    if cell == "fir.lockstep":
        c = spans.counters()
        want = 100 * c["fir.compactions"] / c["fir.steps"]
        assert r["metrics"]["fir_step.compact_pct"]["value"] == pytest.approx(want)
