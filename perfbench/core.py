"""The benchmark's harness: finds a cell's configuration, traffic, driver,
limits and metrics by the names in ``BENCHMARK.json``, sets the cell up,
measures its window, traces a stretch after it (``--trace 1``), checks what
the timed path produced against the plain reference, and builds the result.

Every part that belongs to one configuration, traffic mix, driver or metric
lives in a file of its own under this folder:

- ``configs/<config>.json``: the deployment's sizes;
- ``traffic/<traffic>.json``: the mix's parameters, and the name of the
  driver that feeds it (``drivers/<driver>.py``);
- ``limits/<cell>.json``: the limit of every number the cell compares;
- ``metrics/<metric>.py``: ``read(record)`` returns the metric's value, or
  ``None`` where the cell gives it nothing to read;
- ``rooflines/<kernel>.py``: the frozen operation and byte counts.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that no run may load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "resampler_tpu")


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules whose top-level name, the part before the first
    dot, is one of ``FORBIDDEN`` (compared whole, so ``resampler_tpu_torch``
    passes)."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_module(path: Path):
    """Import the Python file ``path`` under a name of its own."""
    name = "perfbench_file_" + "_".join(path.relative_to(HERE).with_suffix("").parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def reports(metric: dict, cell: str, end_to_end: list) -> bool:
    """Whether ``cell`` reports ``metric``: its ``workloads`` list it, or it
    has none and the cell reports the end-to-end metric it moves (or it is
    an end-to-end metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    return any(m["name"] == moves and reports(m, cell, end_to_end) for m in end_to_end)


def find_cell(bench: dict, name: str) -> Cell:
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(workloads)}")
    w = workloads[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if reports(m, name, bench["end_to_end"])]
    layer = [m for m in bench["per_layer"] if reports(m, name, bench["end_to_end"])]
    return Cell(
        name=name,
        workload=w,
        config=load_json(ROOT / conf["file"]),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=layer,
    )


class Layers:
    """Host-clock totals of the calls into the program's layers, by name:
    ``wrap`` puts a timer around a bound method on its instance."""

    def __init__(self):
        self.total: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.on = False
        self.labels = False  # under the profiler: each call labelled

    def add(self, name: str, seconds: float) -> None:
        self.total[name] = self.total.get(name, 0.0) + seconds
        self.calls[name] = self.calls.get(name, 0) + 1

    def wrap(self, obj, attr: str, name: str) -> None:
        inner = getattr(obj, attr)

        def timed(*args, **kwargs):
            if self.labels:
                from torch.profiler import record_function

                from .trace import LABEL_PREFIX

                with record_function(LABEL_PREFIX + name):
                    return inner(*args, **kwargs)
            if not self.on:
                return inner(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                self.add(name, time.perf_counter() - t0)

        setattr(obj, attr, timed)

    def mean(self, name: str):
        n = self.calls.get(name, 0)
        return self.total[name] / n if n else None


class Sampler:
    """Which steps keep their outputs for the check: gaps drawn from the
    seed around ``gap`` steps, starting after ``first``; the last ``slots``
    sampled steps are kept (``slot(k)`` names the slot step ``k`` writes,
    or ``None``)."""

    def __init__(self, seed: int, gap: int, slots: int, first: int):
        self.rng = np.random.default_rng([seed % (1 << 63), 0x5A3])
        self.gap, self.slots = gap, slots
        self.next = first + self._draw()
        self.count = 0
        self.kept: dict[int, int] = {}  # slot -> step

    def _draw(self) -> int:
        return int(self.rng.integers(max(1, self.gap // 2), self.gap + self.gap // 2 + 1))

    def slot(self, k: int):
        if k != self.next:
            return None
        s = self.count % self.slots
        self.count += 1
        self.kept[s] = k
        self.next = k + self._draw()
        return s


@dataclasses.dataclass
class Record:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    window_s: float
    steps: int
    samples: int
    step_ms: list
    layers: Layers
    trace: object = None


class StepClock:
    """Times one step on the device's clock (CUDA events; the step's end
    waits for the device), or on the host's clock off the card."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t1 = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.cuda:
            self.t0.record()
        else:
            self.h0 = time.perf_counter()

    def stop(self) -> float:
        """Wait for the device; the step's milliseconds."""
        if self.cuda:
            self.t1.record()
            self.torch.cuda.synchronize()
            return self.t0.elapsed_time(self.t1)
        return (time.perf_counter() - self.h0) * 1e3


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, control: bool = False, patch=None) -> dict:
    """Set the cell up, measure its window, optionally trace a stretch after
    it, check the outputs and return the result's fields (``metrics`` by
    the cell's end-to-end metrics, or with ``trace`` its per-layer ones)."""
    import torch

    layers = Layers()
    cuda = torch.device(device).type == "cuda"
    parts = {"imports": time.perf_counter() - t_start}
    mark = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal mark
        if cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name] = now - mark
        mark = now

    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
        lap("cuda_context")
        from resampler_tpu_torch.ops import _build

        _build.build()
        lap("kernel_libraries")
    driver_mod = load_module(HERE / "drivers" / f"{cell.traffic['driver']}.py")
    driver = driver_mod.Driver(cell.config, cell.traffic, seed, device, layers)
    lap("fleet_and_inputs")
    if patch is not None:
        patch(driver)
    clock = StepClock(device)
    driver.warm()
    lap("warm_steps")
    layers.on = trace

    # ---- the measured window ----
    step_ms, samples = [], 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        clock.start()
        samples += driver.step()
        step_ms.append(clock.stop())
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    window_s = elapsed
    steps = len(step_ms)
    layers.on = False

    tr = None
    if trace:
        layers.labels = True
        tr = traced_stretch(driver, clock, cell.traffic["trace_steps"], cuda)
        layers.labels = False
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # ---- the check, once the window has closed and the state is freed ----
    driver.release()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, failed = driver.check(cell.limits, control)
    check_s = time.perf_counter() - t_check

    rec = Record(cell, setup_s, window_s, steps, samples, step_ms, layers, tr)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    out = {"correct": bool(correct), "attempted": steps, "failed": int(failed),
           "metrics": metrics, "device": dev, "setup_parts_s": parts, "check_s": check_s}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    out["checks"] = checks
    return out


def traced_stretch(driver, clock, n: int, cuda: bool):
    """``n`` steps under torch.profiler, each labelled, reduced to a
    ``trace.Trace``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace as trace_mod

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(n):
            clock.start()
            with record_function(trace_mod.STEP_LABEL):
                driver.step()
                if cuda:
                    torch.cuda.synchronize()
            clock.stop()
    return trace_mod.from_profiler(prof, n)


def quantile(values, q: float) -> float:
    """The ``q``-th of 100 cut points (``statistics.quantiles``, exclusive
    method)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100)[q - 1]
