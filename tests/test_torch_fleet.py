"""The port's time-major synchronized fleet against the JAX package's
(``contraction="xla"``, the CPU form): 30+ steps across compactions with
schedule ints and ring state exact and samples within 1e-5; the NaN
fence; state carried across from JAX and ``.npz`` checkpoints; and every
unported variant raising ``NotImplementedError``."""

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import resampler_tpu as jrt
import resampler_tpu_torch as trt
from resampler_tpu.engine import fir as jfir
from resampler_tpu.engine.batched import BatchedResamplerFir as JaxFleet
from resampler_tpu.utils.checkpoint import load_state, save_state
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine import fir_fleets as tfleets
from resampler_tpu_torch.ops import fir_dma_kernel as kern
from resampler_tpu_torch.utils.state import state_from_numpy, state_to_numpy

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ATOL = 1e-5  # f32 accumulation order (plain einsum vs XLA dot)
MAX_CHUNK, HORIZON = 512, 3  # compacts every ~10 steps

# (in_hz, out_hz, taps, B, C, horizon): headline pair; the grouped
# small-M atlas (48 -> 96: g 64); a ragged 3-stream stereo fleet (R = 6
# lanes); horizon 1, whose compaction window overlaps its destination
CASES = [
    (44100, 48000, 64, 2, 2, HORIZON),
    (48000, 96000, 16, 2, 1, HORIZON),
    (44100, 48000, 16, 3, 2, HORIZON),
    (48000, 44100, 16, 1, 2, 1),
]


def _feeds(n_steps, rng):
    """Varying valid counts: full chunks, partial, empty."""
    nv = rng.integers(0, MAX_CHUNK + 1, n_steps)
    nv[::3] = MAX_CHUNK
    nv[5] = 0
    return nv


def _assert_fleet_state_equal(jstate, tstate):
    js = jax.tree.map(np.asarray, jstate)
    ts = state_to_numpy(tstate)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert js[k].dtype == ts[k].dtype, k
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


@pytest.mark.parametrize(
    "case", CASES, ids=["44k1-48k", "48k-96k-grouped", "ragged-R6", "overlap-h1"]
)
def test_sync_tm_step_matches_jax(case):
    in_hz, out_hz, taps, B, C, horizon = case
    L, M = jrt.types.reduce_ratio(in_hz, out_hz)
    jc = jfir.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    tc = tfir.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    coeffs = tfir.fir_coefficients(
        taps, trt.Attenuation.Db90, tfir.fir_cutoff(taps, trt.Attenuation.Db90, in_hz / out_hz)
    )
    kw = dict(max_chunk=MAX_CHUNK, horizon=horizon, out_layout="tm")
    jstep = jax.jit(jfir.make_fir_fleet_step_sync_tm(jc, coeffs, B, contraction="xla", **kw))
    tstep = tfleets.make_fir_fleet_step_sync_tm(tc, coeffs, B, device="cpu", **kw)
    js = jfir.fir_fleet_init_sync_tm(jc, B, max_chunk=MAX_CHUNK, horizon=horizon)
    ts = tfleets.fir_fleet_init_sync_tm(
        tc, B, max_chunk=MAX_CHUNK, horizon=horizon, device="cpu"
    )
    rng = np.random.default_rng(0)
    compactions = produced = overlaps = 0
    launches = dict(kern.LAUNCHES)
    feeds = _feeds(34, rng)
    if horizon == 1:
        # fill lands 3 rows past the threshold (input_capacity) with the
        # last ~taps frames unconsumed: the compaction window overlaps
        feeds[:9] = [MAX_CHUNK] * 8 + [3]
    for nv in feeds:
        chunk = rng.standard_normal((MAX_CHUNK, B * C)).astype(np.float32)
        fill_before = ts["fill"]
        js, oj, cj, pj = jstep(js, chunk, np.int32(nv))
        ts, ot, ct, pt = tstep(ts, torch.from_numpy(chunk), int(nv))
        assert (ct, pt) == (int(cj), int(pj))
        if ts["fill"] < fill_before:  # compacted from row ws: overlapping?
            overlaps += fill_before + ct - ts["fill"] < jc.input_capacity
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
        _assert_fleet_state_equal(js, ts)
        compactions += ts["fill"] < fill_before
        produced += pt
    assert compactions >= 2 and produced > 0
    assert overlaps >= (1 if horizon == 1 else 0)
    assert kern.LAUNCHES == launches


def _fleets(B=3, C=2, latency="Sample32"):
    kw = dict(synchronized=True, sync_variant="tm", max_chunk=MAX_CHUNK, horizon=HORIZON)
    j = JaxFleet(B, C, 44100, 48000, getattr(jrt.Latency, latency), jrt.Attenuation.Db90, **kw)
    t = trt.BatchedResamplerFir(
        B, C, 44100, 48000, getattr(trt.Latency, latency), trt.Attenuation.Db90,
        device="cpu", **kw
    )
    return j, t


def _compare(jres, tres):
    (oj, cj, pj, kj), (ot, ct, pt, kt) = jres, tres
    np.testing.assert_array_equal(ct, np.asarray(cj))
    np.testing.assert_array_equal(pt, np.asarray(pj))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
    assert abs(float(kt) - float(kj)) <= ATOL


def test_batched_resample_and_many_match_jax():
    """``resample`` (30+ steps, partial valid counts, fleet slew) and
    ``resample_many`` (T = 8) against the JAX wrapper."""
    j, t = _fleets()
    B, C = 3, 2
    rng = np.random.default_rng(4)
    fills = []
    for i, nv in enumerate(_feeds(32, rng)):
        chunks = rng.standard_normal((B, MAX_CHUNK, C)).astype(np.float32)
        n_valid = np.full((B,), nv, np.int32)
        n_valid[1] += 7  # the shared schedule takes the fleet minimum
        _compare(j.resample(chunks, n_valid), t.resample(chunks, n_valid))
        _assert_fleet_state_equal(j.state, t.state)
        fills.append(t.state["fill"])
        if i == 10:
            for s in (0.25, -3.7, 2.0):
                assert t.slew(s) == pytest.approx(float(j.slew(s)), abs=0)
            _assert_fleet_state_equal(j.state, t.state)
    assert sum(b < a for a, b in zip(fills, fills[1:])) >= 2  # compactions
    chunks4 = rng.standard_normal((8, B, MAX_CHUNK, C)).astype(np.float32)
    nv4 = np.asarray([512, 100, 0, 512, 333, 512, 512, 64], np.int32)
    _compare(j.resample_many(chunks4, nv4), t.resample_many(chunks4, nv4))
    _assert_fleet_state_equal(j.state, t.state)


def test_nan_fence():
    """NaN past ``n_valid`` never reaches the ring: outputs stay finite
    and equal JAX's."""
    j, t = _fleets(B=2)
    rng = np.random.default_rng(5)
    for nv in (512, 200, 512, 37, 512, 512, 90, 512):
        chunks = rng.standard_normal((2, MAX_CHUNK, 2)).astype(np.float32)
        chunks[:, nv:] = np.nan
        tres = t.resample(chunks, np.full((2,), nv))
        assert torch.isfinite(tres[0]).all() and np.isfinite(float(tres[3]))
        _compare(j.resample(chunks, np.full((2,), nv)), tres)
        _assert_fleet_state_equal(j.state, t.state)
    assert not torch.isnan(t.state["buffer"]).any()


def test_state_carried_across_from_jax_and_npz(tmp_path):
    """A JAX fleet state (and its ``.npz`` checkpoint) loaded into the
    port, stepped in both, gives the same next state; the port's numpy
    form round-trips."""
    j, t = _fleets()
    rng = np.random.default_rng(6)
    for _ in range(7):
        j.resample(rng.standard_normal((3, MAX_CHUNK, 2)).astype(np.float32))
    save_state(tmp_path / "fleet.npz", j.state)
    for state_np in (
        jax.tree.map(np.asarray, j.state),
        load_state(tmp_path / "fleet.npz", to_device=False),
    ):
        t.state = state_from_numpy(state_np, device="cpu")
        _assert_fleet_state_equal(j.state, t.state)
        assert state_from_numpy(state_to_numpy(t.state), device="cpu").keys() == t.state.keys()
    for _ in range(5):
        chunks = rng.standard_normal((3, MAX_CHUNK, 2)).astype(np.float32)
        _compare(j.resample(chunks), t.resample(chunks))
        _assert_fleet_state_equal(j.state, t.state)
    # the loaded buffer is a copy: stepping the port leaves numpy alone
    state_np = state_to_numpy(t.state)
    t.state = state_from_numpy(state_np, device="cpu")
    t.resample(rng.standard_normal((3, MAX_CHUNK, 2)).astype(np.float32))
    assert not np.array_equal(state_np["buffer"], state_to_numpy(t.state)["buffer"])


def test_state_conversion_rejects_foreign_states():
    good = state_to_numpy(
        trt.BatchedResamplerFir(1, 1, 44100, 48000, synchronized=True, device="cpu").state
    )
    with pytest.raises(TypeError):  # the wide words are uint32
        state_from_numpy(dict(good, pos_hi=np.int32(0)), device="cpu")
    with pytest.raises(TypeError):  # per-stream schedules: the vmapped fleet
        state_from_numpy(dict(good, available_frames=np.zeros(4, np.int32)), device="cpu")
    with pytest.raises(TypeError):  # [B] positions only beside the async ring's start
        state_from_numpy(dict(buffer=good["buffer"], pos_num=np.zeros(4, np.int32)), device="cpu")
    with pytest.raises(TypeError):
        state_from_numpy(dict(good, buffer=good["buffer"].astype(np.float64)), device="cpu")
    with pytest.raises(ValueError):
        state_from_numpy(dict(good, extra=np.int32(0)), device="cpu")
    with pytest.raises(OverflowError):
        state_to_numpy(dict(state_from_numpy(good, device="cpu"), fill=1 << 31))
    with pytest.raises(OverflowError):
        state_to_numpy(dict(state_from_numpy(good, device="cpu"), pos_lo=-1))


def test_unported_variants_raise():
    """Coprime, lerp and wide fleets are ported (tests/test_torch_farrow_*.py),
    the async fleet (tests/test_torch_async_*.py), the vmapped and slide
    fleets (tests/test_torch_vmapped_fleet.py, test_torch_slide_fleet.py);
    the other variants raise naming their ROADMAP item."""
    args = (4, 2, 44100, 48000)
    cases = [
        (dict(mesh=object()), "A11"),
        (dict(synchronized=True, mesh=object()), "A11"),
        (dict(synchronized=True, sync_variant="async_tm", mesh=object()), "A11"),
    ]
    for kwargs, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            trt.BatchedResamplerFir(*args, device="cpu", **kwargs)
    with pytest.raises(ValueError):
        trt.BatchedResamplerFir(*args, synchronized=True, path="periodc", device="cpu")
    with pytest.raises(ValueError):  # the fleet has no gather path
        trt.BatchedResamplerFir(*args, synchronized=True, path="gather", device="cpu")
    t = trt.BatchedResamplerFir(*args, synchronized=True, max_chunk=256, device="cpu")
    with pytest.raises(ValueError):
        t.slew(np.zeros(4))
    with pytest.raises(ValueError):
        t.resample(np.zeros((4, 257, 2), np.float32))
