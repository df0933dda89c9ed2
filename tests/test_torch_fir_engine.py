"""The port's per-stream ``ResamplerFir`` against the JAX package's over
multi-call streams: counts and buffer state exact, samples within 1e-5."""

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import resampler_tpu as jrt
import resampler_tpu_torch as trt
from resampler_tpu.engine import fir as jfir
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine import fir_fleets as tfleets
from resampler_tpu_torch.utils.state import state_from_numpy, state_to_numpy

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

# samples: f32 accumulation order differs (einsum vs XLA dot); the JAX
# suite's own device-vs-CPU scale is 5e-5, this is 5x tighter
ATOL = 1e-5

# (in_hz, out_hz, latency): 44.1 -> 48 and 22.05 -> 48 and 48 -> 96 take
# the im2col branch, 48 -> 44.1 at 16 taps the stride-L window branch
PAIRS = [
    (44100, 48000, "Sample32"),
    (48000, 44100, "Sample8"),
    (22050, 48000, "Sample8"),
    (48000, 96000, "Sample8"),
]
# frame counts per call (all inside the 32- and 512-frame input buckets,
# so the JAX side compiles two step shapes); 0 is an empty buffer
FEEDS = [0, 7, 31, 500, 1, 17, 511, 0, 300, 29, 480, 3, 511, 64, 200]


def _pair(in_hz, out_hz, latency, channels=2):
    j = jrt.ResamplerFir(
        channels, in_hz, out_hz, getattr(jrt.Latency, latency), jrt.Attenuation.Db90
    )
    t = trt.ResamplerFir(
        channels, in_hz, out_hz, getattr(trt.Latency, latency), trt.Attenuation.Db90,
        device="cpu",
    )
    return j, t


def _assert_state_equal(j, t):
    js = {k: np.asarray(v) for k, v in j.state.items()}
    ts = state_to_numpy(t.state)
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
    return ct, pt


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_resample_stream_matches_jax(pair):
    j, t = _pair(*pair)
    C = 2
    rng = np.random.default_rng(1)
    total_p = 0
    for i, n in enumerate(FEEDS):
        x = rng.standard_normal(n * C).astype(np.float32)
        # a small output budget now and then caps production
        out_size = 37 * C if i % 5 == 4 else j.buffer_size_output()
        total_p += _run(j, t, x, out_size)[1]
        _assert_state_equal(j, t)
        if i == 6:
            for s in (0.37, -5.2, 1000.0, -1e9):
                assert t.slew(s) == pytest.approx(j.slew(s), abs=0)
            _assert_state_equal(j, t)
    assert total_p > 0
    j.reset()
    t.reset()
    _assert_state_equal(j, t)
    _run(j, t, rng.standard_normal(300 * C).astype(np.float32), t.buffer_size_output())
    _assert_state_equal(j, t)


def test_odd_buffers_raise_like_jax():
    j, t = _pair(44100, 48000, "Sample8")
    for args in (
        (np.zeros(5, np.float32), np.zeros(64, np.float32)),
        (np.zeros(4, np.float32), np.zeros(63, np.float32)),
        (np.zeros(4, np.float32), [0.0] * 64),
    ):
        with pytest.raises(jrt.InvalidInputBufferSize if args[0].size % 2 else jrt.InvalidOutputBufferSize):
            j.resample(*args)
        with pytest.raises(trt.InvalidInputBufferSize if args[0].size % 2 else trt.InvalidOutputBufferSize):
            t.resample(*args)


def test_process_matches_jax():
    """One-shot ``process``: a short input (the JAX per-call loop) and a
    one-second input (the JAX scanned fast path; the port's chunk loop
    gives the same stream)."""
    j, t = _pair(44100, 48000, "Sample32")
    rng = np.random.default_rng(2)
    for n_frames in (3000, 44100):
        x = rng.standard_normal(2 * n_frames).astype(np.float32)
        yj, yt = j.process(x), t.process(x)
        assert yt.shape == yj.shape
        np.testing.assert_allclose(yt, yj, atol=ATOL, rtol=0)
        _assert_state_equal(j, t)


def test_state_from_jax_steps_alike():
    """A JAX stream state loaded into the port, stepped in both, gives
    the same next state."""
    j, t = _pair(48000, 44100, "Sample8")
    rng = np.random.default_rng(3)
    for n in (500, 511, 300):
        j.resample(rng.standard_normal(2 * n).astype(np.float32), np.zeros(j.buffer_size_output(), np.float32))
    t.state = state_from_numpy({k: np.asarray(v) for k, v in j.state.items()}, device="cpu")
    _assert_state_equal(j, t)
    for n in (400, 17):
        _run(j, t, rng.standard_normal(2 * n).astype(np.float32), j.buffer_size_output())
        _assert_state_equal(j, t)


def test_step_output_tail_matches_jax():
    """``make_fir_step`` returns the full ``[out_capacity, C]`` block with
    lanes past ``produced`` zeroed, as the JAX step does."""
    L, M = trt.types.reduce_ratio(48000, 44100)
    jc = jfir.FirConfig(channels=2, taps=16, ratio_num=L, ratio_den=M)
    tc = tfir.FirConfig(channels=2, taps=16, ratio_num=L, ratio_den=M)
    coeffs = tfir.fir_coefficients(16, trt.Attenuation.Db90, tfir.fir_cutoff(16, trt.Attenuation.Db90, 48000 / 44100))
    jstep = jax.jit(jfir.make_fir_step(jc, coeffs))
    tstep = tfir.make_fir_step(tc, coeffs, device="cpu")
    js, ts = jfir.fir_init(jc), tfir.fir_init(tc, device="cpu")
    rng = np.random.default_rng(7)
    for nv, budget in ((512, 10_000), (300, 50), (0, 10_000), (512, 10_000), (5, 3)):
        chunk = rng.standard_normal((512, 2)).astype(np.float32)
        js, oj, cj, pj = jstep(js, chunk, np.int32(nv), np.int32(budget))
        ts, ot, ct, pt = tstep(ts, torch.from_numpy(chunk), nv, budget)
        assert (ct, pt) == (int(cj), int(pj))
        assert ot.shape == oj.shape
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
        assert not ot[pt:].any()


def test_cuda_device_pins_full_f32(monkeypatch):
    """Resolving a CUDA device turns both TF32 flags off (TF32 keeps ~3
    digits and fails the 100 dB alias gate)."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        assert tfir.resolve_device("cuda").type == "cuda"
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    with pytest.raises(ValueError):
        tfir.resolve_device("meta")


@pytest.mark.parametrize("in_hz,out_hz", [(22050, 44100), (22050, 48000)])
def test_stopband_attenuation(in_hz, out_hz):
    """The port's impulse response clears the engine tests' 90 dB
    stopband gate (same procedure as tests/test_fir_engine.py:
    passband max minus stopband max over an 8192-point spectrum)."""
    x = np.zeros(2 * in_hz, np.float32)
    x[in_hz] = 1.0
    r = trt.ResamplerFir(
        1, in_hz, out_hz, trt.Latency.Sample64, trt.Attenuation.Db90, device="cpu"
    )
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


def test_unported_options_raise():
    """Coprime, lerp and wide ratios are ported (tests/test_torch_farrow_*.py);
    the table-lerp oracle and the f64 reference schedule are not."""
    with pytest.raises(NotImplementedError, match="A9"):
        trt.ResamplerFir(2, 44100, 48000, schedule="reference", device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        trt.ResamplerFir(2, 44100, 44101, path="gather", device="cpu")
    with pytest.raises(ValueError):
        trt.ResamplerFir(2, 44100, 48000, schedule="f64", device="cpu")


def test_cuda_without_gpu_raises(monkeypatch):
    """The card is the default device; without one every entry point
    raises (no fallback to the CPU)."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    for kw in (dict(device="cuda"), dict()):
        with pytest.raises(RuntimeError, match="cuda"):
            trt.ResamplerFir(2, 44100, 48000, **kw)
        with pytest.raises(RuntimeError, match="cuda"):
            trt.BatchedResamplerFir(2, 2, 44100, 48000, synchronized=True, **kw)
    cfg = tfir.FirConfig(channels=2, taps=16, ratio_num=147, ratio_den=160)
    coeffs = np.zeros((tfir.PHASES, 16), np.float32)
    for build in (
        lambda: tfir.fir_init(cfg),
        lambda: tfir.make_fir_step(cfg, coeffs),
        lambda: tfleets.make_fir_fleet_step_sync_tm(cfg, coeffs, 2, max_chunk=64),
        lambda: tfleets.fir_fleet_init_sync_tm(cfg, 2, max_chunk=64),
        lambda: state_from_numpy({"buffer": np.zeros((2, 8), np.float32)}),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
