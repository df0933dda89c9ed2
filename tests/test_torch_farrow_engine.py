"""The port's per-stream ``ResamplerFir`` on coprime ratios (farrow, lerp,
heavy downsampling, the wide u32 schedule) against the JAX package's over
multi-call streams: counts and state exact, samples within ``ATOL``.
Also: the wide schedule's saturation corner, JAX wide states and ``.npz``
checkpoints carried into the port, and a stopband gate for a coprime
pair."""

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import resampler_tpu as jrt
import resampler_tpu_torch as trt
from resampler_tpu.engine import fir as jfir
from resampler_tpu.utils.checkpoint import load_state, save_state
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.utils.state import state_from_numpy, state_to_numpy

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

# f32 sums in another order: the JAX suite's own dma-vs-xla tolerance for
# this path (tests/test_pallas.py)
ATOL = 1e-5
# (in_hz, out_hz, latency, path)
CASES = [
    (44100, 44101, "Sample32", "auto"),
    (44100, 44101, "Sample32", "lerp"),
    (48000, 44101, "Sample16", "auto"),
    (367500, 1601, "Sample16", "auto"),
    (600011, 600013, "Sample16", "auto"),
    (44100, 48000, "Sample16", "lerp"),
]
IDS = ["farrow", "lerp", "farrow-down", "heavy-down", "wide", "lerp-on-periodic"]
# frame counts per call (inside the 32- and 512-frame input buckets)
FEEDS = [0, 7, 31, 500, 1, 17, 511, 0, 300, 29, 480, 3, 511, 64, 200]


def _pair(in_hz, out_hz, latency, path, channels=2):
    args = (channels, in_hz, out_hz)
    j = jrt.ResamplerFir(*args, getattr(jrt.Latency, latency), jrt.Attenuation.Db90, path=path)
    t = trt.ResamplerFir(
        *args, getattr(trt.Latency, latency), trt.Attenuation.Db90, path=path, device="cpu"
    )
    return j, t


def _assert_state_equal(jstate, tstate):
    js = {k: np.asarray(v) for k, v in jstate.items()}
    ts = state_to_numpy(tstate)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert js[k].dtype == ts[k].dtype, k
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def _run(j, t, x, out_size):
    oj = np.zeros(out_size, np.float32)
    ot = np.zeros(out_size, np.float32)
    cj, pj = j.resample(x, oj)
    ct, pt = t.resample(x, ot)
    assert (ct, pt) == (cj, pj)
    np.testing.assert_allclose(ot[:pt], oj[:pj], atol=ATOL, rtol=0)
    return pt


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_resample_stream_matches_jax(case):
    j, t = _pair(*case)
    rng = np.random.default_rng(1)
    produced = 0
    for i, n in enumerate(FEEDS):
        x = rng.standard_normal(2 * n).astype(np.float32)
        out_size = 37 * 2 if i % 5 == 4 else j.buffer_size_output()  # capped budget
        produced += _run(j, t, x, out_size)
        _assert_state_equal(j.state, t.state)
        if i == 6:
            for s in (0.37, -5.2, 1000.0, -1e9):
                assert t.slew(s) == pytest.approx(j.slew(s), abs=0)
            _assert_state_equal(j.state, t.state)
    assert produced > 0


def test_wide_saturation_corner_matches_jax():
    """Reduced ``L//M > 2^32 - 8195``: the stride of one output overflows
    the u32 frame word, and the JAX wide schedule saturates it
    (PARITY.md's documented under-skip).  The port's host-int schedule
    reproduces that, counts and words alike."""
    L, M = (1 << 32) - 5, 1
    jc = jfir.FirConfig(channels=1, taps=16, ratio_num=L, ratio_den=M)
    tc = tfir.FirConfig(channels=1, taps=16, ratio_num=L, ratio_den=M)
    assert L // M > (1 << 32) - 8195 and tc.wide
    coeffs = tfir.fir_coefficients(16, trt.Attenuation.Db90, 0.5)
    jstep = jax.jit(jfir.make_fir_step(jc, coeffs))
    tstep = tfir.make_fir_step(tc, coeffs, device="cpu")
    # start 7 frames in, so the first emitted stride wraps the frame word
    js = dict(jfir.fir_init(jc), pos_hi=np.uint32(7))
    ts = dict(tfir.fir_init(tc, device="cpu"), pos_hi=7)
    rng = np.random.default_rng(2)
    saturated = 0
    for nv in (64, 20, 64, 5, 64, 0, 64):
        chunk = rng.standard_normal((64, 1)).astype(np.float32)
        js, oj, cj, pj = jstep(js, chunk, np.int32(nv), np.int32(10))
        ts, ot, ct, pt = tstep(ts, torch.from_numpy(chunk), nv, 10)
        assert (ct, pt) == (int(cj), int(pj))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
        _assert_state_equal(js, ts)
        saturated += pt > 0 and ts["pos_hi"] + ct == (1 << 32) - 1
    assert saturated == 1


def test_wide_state_carried_across_from_jax_and_npz(tmp_path):
    """A JAX wide stream state (uint32 ``pos_hi`` / ``pos_lo``) and its
    ``.npz`` checkpoint load into the port unchanged, step alike, and come
    back equal."""
    j, t = _pair(600011, 600013, "Sample16", "auto")
    rng = np.random.default_rng(3)
    out = np.zeros(j.buffer_size_output(), np.float32)
    for n in (500, 511, 300):
        j.resample(rng.standard_normal(2 * n).astype(np.float32), out)
    j.slew(0.3)
    save_state(tmp_path / "wide.npz", j.state)
    for state_np in (
        {k: np.asarray(v) for k, v in j.state.items()},
        load_state(tmp_path / "wide.npz", to_device=False),
    ):
        assert state_np["pos_hi"].dtype == np.uint32
        t.state = state_from_numpy(state_np, device="cpu")
        _assert_state_equal(j.state, t.state)
    for n in (400, 17, 511):
        _run(j, t, rng.standard_normal(2 * n).astype(np.float32), j.buffer_size_output())
        _assert_state_equal(j.state, t.state)


def test_wide_fleet_state_carried_across_from_jax():
    from resampler_tpu.engine.batched import BatchedResamplerFir as JaxFleet

    kw = dict(synchronized=True, max_chunk=256, horizon=3)
    j = JaxFleet(2, 1, 600011, 600013, jrt.Latency.Sample16, jrt.Attenuation.Db90, **kw)
    t = trt.BatchedResamplerFir(
        2, 1, 600011, 600013, trt.Latency.Sample16, trt.Attenuation.Db90, device="cpu", **kw
    )
    rng = np.random.default_rng(5)
    for _ in range(4):
        j.resample(rng.standard_normal((2, 256, 1)).astype(np.float32))
    t.state = state_from_numpy(jax.tree.map(np.asarray, j.state), device="cpu")
    for _ in range(3):
        chunks = rng.standard_normal((2, 256, 1)).astype(np.float32)
        (oj, cj, pj, _), (ot, ct, pt, _) = j.resample(chunks), t.resample(chunks)
        np.testing.assert_array_equal(ct, np.asarray(cj))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
        _assert_state_equal(jax.tree.map(np.asarray, j.state), t.state)


def test_coprime_stopband_attenuation():
    """22050 -> 44101 Hz (farrow): the impulse response clears the
    engine tests' 90 dB stopband gate (the procedure of
    tests/test_torch_fir_engine.py::test_stopband_attenuation)."""
    in_hz, out_hz = 22050, 44101
    r = trt.ResamplerFir(1, in_hz, out_hz, trt.Latency.Sample64, trt.Attenuation.Db90, device="cpu")
    assert tfir.resolve_convolve_path(r._config) == "farrow"
    x = np.zeros(2 * in_hz, np.float32)
    x[in_hz] = 1.0
    y = r.process(x)
    peak = int(np.argmax(np.abs(y)))
    window = int(out_hz * 0.1)
    ir = y[max(peak - window // 2, 0) :][:window]
    mag_db = 20 * np.log10(np.maximum(np.abs(np.fft.rfft(ir, 8192)), 1e-10))

    def bin_of(freq):
        return round(freq / out_hz * 8192)

    passband = mag_db[bin_of(20.0) : bin_of(in_hz / 2 * 0.9) + 1]
    stop_end = min(len(mag_db) - 10, bin_of(out_hz / 2 * 0.95))
    stopband = mag_db[bin_of(in_hz / 2 * 1.1) : stop_end + 1]
    assert passband.max() - stopband.max() >= 90.0
