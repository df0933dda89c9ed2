"""Every cell, configuration, traffic mix, driver, limit and metric that
``BENCHMARK.json`` names resolves to its file, and the file keeps to the
benchmark's format."""

import json
import re

import pytest

from perfbench import core

BENCH = core.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] + CELLS + [
        c["name"] for c in BENCH["configs"]] + [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert all(m["source"] in ("host_clock", "device_trace") for m in BENCH["end_to_end"])
    assert all(0.0 < m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = core.find_cell(BENCH, cell)
    assert (core.HERE / "drivers" / f"{c.traffic['driver']}.py").is_file()
    assert c.config["name"] == c.workload["config"]
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2, "setup_s and another end-to-end metric"
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.end_to_end + c.per_layer:
        assert (core.HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert callable(core.load_module(core.HERE / "metrics" / f"{m['name']}.py").read)
    assert set(c.limits) >= {"max_abs_err"}


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    path = core.ROOT / conf["file"]
    assert path.is_file() and conf["file"].startswith("perfbench/")
    assert core.load_json(path)["name"] == conf["name"]
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


def test_per_layer_moves_a_metric_each_cell_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert core.reports(target, cell, BENCH["end_to_end"]), (m["name"], cell)
