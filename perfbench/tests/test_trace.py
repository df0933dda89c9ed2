"""The trace arithmetic: the union of device intervals, the idle share,
the gaps and the copies."""

import pytest

from perfbench import core
from perfbench.trace import Trace, is_transfer, merged, union_length


def test_union_merges_overlaps_and_clips():
    ev = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 28, 29), ("e", -5, 1), ("f", 40, 50)]
    assert merged(ev, 0, 45) == [(0, 15), (20, 30), (40, 45)]
    assert union_length(ev, 0, 45) == 15 + 10 + 5
    assert union_length([], 0, 10) == 0


def test_idle_share_is_one_less_the_union():
    t = Trace(device=[("k1", 10, 30), ("k2", 20, 40), ("Memcpy HtoD (Pageable -> Device)", 60, 70)],
              host=[("outer", 0, 100), ("aten::copy_", 45, 55)], t0_us=0, t1_us=100, steps=2)
    assert t.busy_s == pytest.approx(40e-6)
    rec = core.Record(None, 0, 0, 0, 0, [], core.Layers(), t)
    idle = core.load_module(core.HERE / "metrics" / "device.idle_pct.py").read(rec)
    assert idle == pytest.approx(60.0)
    copy = core.load_module(core.HERE / "metrics" / "device.copy_ms.py").read(rec)
    assert copy == pytest.approx(10e-3 / 2)
    gaps = t.idle_gaps()
    assert gaps[0] == ["outer", pytest.approx(30e-6)]  # 70..100
    assert ["aten::copy_", pytest.approx(20e-6)] in gaps  # 40..60, the innermost host op
    assert t.top_ops(1)[0][1] == pytest.approx(20e-6)  # k1 and k2 run 20 us each


def test_transfers_are_host_device_copies_only():
    assert is_transfer("Memcpy HtoD (Pinned -> Device)")
    assert is_transfer("Memcpy DtoH (Device -> Pageable)")
    assert not is_transfer("Memcpy DtoD (Device -> Device)")
    assert not is_transfer("Memset (Device)")


def test_roofline_reads_mean_time_per_call():
    conf = core.load_json(core.HERE / "configs" / "fir-44k1-48k-s64-db90.json")
    traffic = core.load_json(core.HERE / "traffic" / "lockstep_4096.json")
    b1 = core.load_module(core.HERE / "rooflines" / "b1.py")
    per_call = 2 * b1.bound_seconds(conf, traffic) * 1e6  # us: half the roofline
    t = Trace(device=[("void band_contract_kernel<4>(...)", 0, per_call),
                      ("void band_contract_kernel<4>(...)", 100, 100 + per_call),
                      ("elementwise", 0, 5)], host=[], t0_us=0, t1_us=200, steps=2)
    cell = core.Cell("fir.lockstep", {}, conf, traffic, {}, [], [])
    rec = core.Record(cell, 0, 0, 0, 0, [], core.Layers(), t)
    pct = core.load_module(core.HERE / "metrics" / "b1.roofline_pct.py").read(rec)
    assert pct == pytest.approx(50.0)
    rec.trace = Trace(device=[("elementwise", 0, 5)], host=[], t0_us=0, t1_us=10, steps=1)
    assert core.load_module(core.HERE / "metrics" / "b1.roofline_pct.py").read(rec) is None
