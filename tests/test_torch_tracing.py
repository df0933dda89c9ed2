"""The port's spans and counters (``resampler_tpu_torch.utils.tracing``):
each fleet's ``rtt.*`` spans and their nesting under ``torch.profiler``, the
shared no-op span with no profiler, outputs unchanged by the profiler, and
the counters against what the fleets did, reckoned from their states."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from torch.profiler import ProfilerActivity, profile

import resampler_tpu_torch as rtt
from resampler_tpu_torch.ops import _build
from resampler_tpu_torch.utils import tracing

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

B, C = 3, 2
#: input and output rates, latency, attenuation
FIR = (44100, 48000, rtt.Latency.Sample64, rtt.Attenuation.Db90)
#: aten ops that move no data: the only ones a root span may run outside
#: its leaf spans (``aten::to`` too, where it returns its input uncopied)
VIEWS = {"aten::select", "aten::slice", "aten::view", "aten::reshape", "aten::as_strided",
         "aten::permute", "aten::unsqueeze", "aten::expand", "aten::alias", "aten::detach"}


def _moves_data(ev) -> bool:
    if ev.name == "aten::to":
        return any(c.name == "aten::_to_copy" for c in ev.cpu_children)
    return ev.name not in VIEWS


def _chunks(seed, n=4096, T=None):
    shape = (B, n, C) if T is None else (T, B, n, C)
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _fir(kind):
    kw = {"tm": dict(synchronized=True, max_chunk=4096, horizon=16),
          "vmapped": dict(),
          "async": dict(synchronized=True, sync_variant="async_tm", max_chunk=4096),
          "slide": dict(synchronized=True, sync_variant="slide")}[kind]
    return rtt.BatchedResamplerFir(B, C, *FIR, device="cpu", **kw)


def _drive(kind):
    """``(make, run)``: a fresh fleet, and one step of it returning its
    outputs as numpy."""
    if kind == "streaming":
        def make():
            return rtt.StreamingFleet(B, C, *FIR, chunk_frames=1024, device="cpu")

        def run(fleet, k):
            x = _chunks(k, n=1500)
            for b in range(B):
                fleet.push(b, x[b, : 700 + 300 * b].reshape(-1))
            return fleet.step()
    elif kind == "fft":
        def make():
            return rtt.BatchedResamplerFft(B, C, 44100, 48000, backend="conv", device="cpu")

        def run(fleet, k):
            x = torch.from_numpy(_chunks(k, n=fleet.config.fft_size_input).transpose(0, 2, 1).copy())
            return [fleet.resample(x).numpy()]
    else:
        def make():
            return _fir(kind)

        def run(fleet, k):
            out, consumed, produced, peak = fleet.resample(_chunks(k))
            return [out.numpy(), consumed, produced, peak.numpy()]
    return make, run


#: each fleet's spans and the span each one nests in (``None``: a root)
NESTING = {
    "tm": {"fir.step": None, **dict.fromkeys(
        ("fir.upload", "fir.relayout_in", "fir.append", "fir.schedule", "fir.contract",
         "fir.mask", "fir.relayout_out", "fir.peak"), "fir.step")},
    "async": {"fir.step": None, **dict.fromkeys(
        ("fir.upload", "fir.relayout_in", "fir.append", "fir.schedule", "fir.contract",
         "fir.relayout_out", "fir.peak"), "fir.step")},
    "vmapped": {"fir.step": None, **dict.fromkeys(
        ("fir.upload", "fir.schedule", "fir.contract", "fir.peak"), "fir.step")},
    "slide": {"fir.step": None, **dict.fromkeys(
        ("fir.upload", "fir.schedule", "fir.contract", "fir.peak"), "fir.step")},
    "streaming": {"runtime.push": None, "runtime.step": None, "fir.step": "runtime.step",
                  **dict.fromkeys(("runtime.drain", "runtime.stage", "runtime.fetch",
                                   "runtime.recarry", "runtime.deliver"), "runtime.step"),
                  **dict.fromkeys(("fir.upload", "fir.schedule", "fir.contract", "fir.peak"),
                                  "fir.step")},
    "fft": {"fft.step": None, **dict.fromkeys(("fft.upload", "fft.contract", "fft.keep"),
                                              "fft.step")},
}


def _rtt_parent(ev):
    p = ev.cpu_parent
    while p is not None and not p.name.startswith(tracing.PREFIX):
        p = p.cpu_parent
    return None if p is None else p.name[len(tracing.PREFIX):]


@pytest.mark.parametrize("kind", sorted(NESTING))
def test_spans_nest_as_the_stages_do(kind):
    make, run = _drive(kind)
    fleet = make()
    run(fleet, 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(fleet, 1)
    events = list(prof.events())
    seen = {}
    for ev in events:
        if ev.name.startswith(tracing.PREFIX):
            seen.setdefault(ev.name[len(tracing.PREFIX):], set()).add(_rtt_parent(ev))
    assert seen == {k: {v} for k, v in NESTING[kind].items()}
    # a root span runs no op that moves data outside its leaf spans
    roots = {k for k, v in NESTING[kind].items() if v is None or k in ("fir.step", "fft.step")}
    loose = {ev.name for ev in events if not ev.name.startswith(tracing.PREFIX)
             and ev.cpu_parent is not None and ev.cpu_parent.name.startswith(tracing.PREFIX)
             and ev.cpu_parent.name[len(tracing.PREFIX):] in roots and _moves_data(ev)}
    assert not loose, loose


@pytest.mark.parametrize("kind", sorted(NESTING))
def test_outputs_are_the_same_under_the_profiler(kind):
    make, run = _drive(kind)
    plain, traced = make(), make()
    for k in range(3):
        want = run(plain, k)
        with profile(activities=[ProfilerActivity.CPU]):
            got = run(traced, k)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("name", ["a", "fir.step", "runtime.push"])
def test_off_span_is_one_shared_no_op(name):
    off = tracing.span(name)
    assert off is tracing.span("b")
    with off as entered:
        assert entered is off
    with pytest.raises(KeyError):
        with tracing.span(name):
            raise KeyError(name)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span(name):
            pass
    assert [ev.name for ev in prof.events()] == [tracing.PREFIX + name]


@pytest.mark.parametrize("kind", ["tm", "async"])
def test_compactions_counted_as_they_happen(kind):
    """About 40 full chunks through a ring of 16 chunks' room: each time
    the step's ``fill`` comes back short of the rows it appended, the live
    window moved to the front."""
    tracing.reset_counters()
    fleet = _fir(kind)
    moved = 0
    for k in range(40):
        fill = fleet.state["fill"]
        _, consumed, _, _ = fleet.resample(_chunks(k))
        moved += fleet.state["fill"] < fill + int(consumed[0])
    c = tracing.counters()
    assert moved >= 2
    assert c["fir.compactions"] == moved
    assert c["fir.steps"] == 40


@pytest.mark.parametrize("synchronized", [False, True, "async"])
def test_runtime_counters_follow_the_carry_and_the_queue(synchronized):
    tracing.reset_counters()
    fleet = rtt.StreamingFleet(B, C, *FIR, chunk_frames=256, synchronized=synchronized,
                               queue_capacity_frames=1024, device="cpu")
    rng = np.random.default_rng(7)
    carried, staged, offered, accepted = 0, 0, 0, 0
    for k in range(12):
        for b in range(B):
            x = rng.uniform(-1, 1, int(rng.integers(1, 700)) * C + (k % 2)).astype(np.float32)
            offered += x.size
            accepted += fleet.push(b, x)
        staged += np.count_nonzero(fleet._carry_len)
        fleet.step()
        carried += int(fleet._carry_len.sum())
    c = tracing.counters()
    assert c["runtime.steps"] == 12
    assert c["runtime.carried_frames"] == carried
    assert c["runtime.staged_streams"] == staged
    assert c["runtime.values_refused"] == offered - accepted > 0
    if synchronized:
        assert carried > 0  # the shared count holds the faster streams' frames back
        assert staged > 0
    else:
        # the vmapped fleet takes every frame drained (at most a chunk), so
        # the backlog waits in the pool and every batch row passes through
        assert carried == staged == 0


@pytest.mark.parametrize("wrapper", sorted(_build.LAUNCHES))
def test_counters_carry_the_launch_counts(wrapper):
    assert tracing.LAUNCHES is _build.LAUNCHES
    before = _build.LAUNCHES[wrapper]
    try:
        _build.LAUNCHES[wrapper] = 7
        assert tracing.counters()["launches." + wrapper] == 7
        tracing.count("fir.steps", 3)
        tracing.reset_counters()
        snap = tracing.counters()
        assert snap["launches." + wrapper] == 0 and snap["fir.steps"] == 0
        assert _build.LAUNCHES[wrapper] == 0
    finally:
        _build.LAUNCHES[wrapper] = before


@pytest.mark.parametrize("threads", [2, 8])
def test_counts_from_many_threads_add_up(threads):
    """Producers push from threads of their own: no count is lost."""
    import threading

    tracing.reset_counters()
    workers = [threading.Thread(target=lambda: [tracing.count("runtime.values_refused", 3)
                                                for _ in range(5000)]) for _ in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    assert tracing.counters()["runtime.values_refused"] == 3 * 5000 * threads
