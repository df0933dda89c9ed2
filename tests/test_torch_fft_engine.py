"""The port's FFT engine against the JAX package on the CPU: the per-stream
``ResamplerFft`` and the fleet ``BatchedResamplerFft`` on every backend,
``resample_many`` over the pool step, state conversion and checkpoints,
the stopband gate, and the carry's independence from the caller's
buffers.

Tolerance 1e-5 on every backend: the port and JAX compute the same
operator in f32 (magsplit on identical bf16 operands, matmul and conv on
the same f32 projector, fft on the same complex64 filter) and differ only
in the order of f32 sums and FFT butterflies (measured <= 4.1e-6 at
outputs up to ~4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import resampler_tpu as jrt
import resampler_tpu_torch as trt
from resampler_tpu.engine import batched as jbatched
from resampler_tpu.engine import fft as jfft
from resampler_tpu.utils.checkpoint import load_state, save_state
from resampler_tpu_torch.engine import fft as tfft
from resampler_tpu_torch.ops import _build
from resampler_tpu_torch.utils.state import state_from_numpy, state_to_numpy

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ATOL = 1e-5
BACKENDS = ["magsplit", "matmul", "conv", "fft", "rfft"]
#: 22.05 -> 48 kHz: N 588, M 1280, the cheapest pair with a band plan
IN_HZ, OUT_HZ = 22050, 48000


@pytest.mark.parametrize("backend", BACKENDS)
def test_resampler_fft_matches_jax(backend):
    j = jrt.ResamplerFft(2, IN_HZ, OUT_HZ, backend=backend)
    t = trt.ResamplerFft(2, IN_HZ, OUT_HZ, backend=backend, device="cpu")
    assert (t.chunk_size_input(), t.chunk_size_output(), t.delay()) == (
        j.chunk_size_input(), j.chunk_size_output(), j.delay()
    )
    assert repr(t) == repr(j)
    rng = np.random.default_rng(1)
    oj = np.zeros(j.chunk_size_output(), np.float32)
    ot = np.zeros_like(oj)
    for _ in range(4):
        x = rng.standard_normal(j.chunk_size_input()).astype(np.float32)
        j.resample(x, oj)
        t.resample(x, ot)
        np.testing.assert_allclose(ot, oj, atol=ATOL, rtol=0)
    (key, value), = t.state.items()
    np.testing.assert_allclose(value.numpy(), np.asarray(j.state[key]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_fft_matches_jax(backend):
    """4 fleet steps, then ``resample_many(T=3)``; B*C = 8 rows, so the
    JAX fleet also takes its pool kernel on the magsplit backend."""
    B, C = 4, 2
    j = jbatched.BatchedResamplerFft(B, C, IN_HZ, OUT_HZ, backend=backend)
    t = trt.BatchedResamplerFft(B, C, IN_HZ, OUT_HZ, backend=backend, device="cpu")
    N = t.config.fft_size_input
    rng = np.random.default_rng(2)
    for _ in range(4):
        x = rng.standard_normal((B, C, N)).astype(np.float32)
        np.testing.assert_allclose(
            t.resample(x).numpy(), np.asarray(j.resample(x)), atol=ATOL, rtol=0
        )
    x4 = rng.standard_normal((3, B, C, N)).astype(np.float32)
    np.testing.assert_allclose(
        t.resample_many(x4).numpy(), np.asarray(j.resample_many(x4)), atol=ATOL, rtol=0
    )
    (key, value), = t.state.items()
    np.testing.assert_allclose(value.numpy(), np.asarray(j.state[key]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("backend", ["magsplit", "matmul"])
def test_resample_many_equals_the_loop(backend):
    """The pool step (magsplit) and the fleet-step loop give the loop's
    outputs and state exactly; T = 1 and T = 2 included."""
    B, C = 3, 2
    a = trt.BatchedResamplerFft(B, C, IN_HZ, OUT_HZ, backend=backend, device="cpu")
    b = trt.BatchedResamplerFft(B, C, IN_HZ, OUT_HZ, backend=backend, device="cpu")
    rng = np.random.default_rng(3)
    for T in (5, 1, 2):
        x4 = rng.standard_normal((T, B, C, a.config.fft_size_input)).astype(np.float32)
        many = a.resample_many(x4)
        loop = torch.stack([b.resample(x4[i]) for i in range(T)])
        assert torch.equal(many, loop)
        assert a.state.keys() == b.state.keys()
        assert all(torch.equal(a.state[k], b.state[k]) for k in a.state)


def test_pool_step_matches_fleet_step_and_jax():
    """The pool step across slot wraparound, from a zero-filled start slot,
    equals the fleet step and JAX's pool step; it rejects other backends."""
    cfg = tfft.FftConfig(channels=2, fft_size_input=588, fft_size_output=1280)
    jcfg = jfft.FftConfig(channels=2, fft_size_input=588, fft_size_output=1280)
    B, C, N, P = 3, 2, 588, 3
    step_m = tfft.make_fft_fleet_step(cfg, B, backend="magsplit", device="cpu")
    step_p = tfft.make_fft_fleet_step_pool(cfg, B, backend="magsplit", device="cpu")
    jstep_p = jfft.make_fft_fleet_step_pool(jcfg, 4, backend="magsplit")
    st_m = tfft.fft_fleet_init(cfg, B, "magsplit", device="cpu")
    st_p = tfft.fft_fleet_pool_init(prev_idx=2)
    pool = torch.zeros((P, B * C, N))
    rng = np.random.default_rng(4)
    for k in range(5):
        chunk = torch.from_numpy(rng.standard_normal((B, C, N)).astype(np.float32))
        slot = k % 2
        pool[slot] = chunk.reshape(B * C, N)
        prev_slot = st_p["prev_idx"]
        st_m, out_m = step_m(st_m, chunk.clone())
        st_p, out_p = step_p(st_p, pool, slot)
        assert st_p == {"prev_idx": slot}
        assert torch.equal(out_m, out_p)
        jpool = np.zeros((P, 8, N), np.float32)  # JAX's pool needs B*C % 8 == 0
        jpool[:, : B * C] = pool.numpy()
        _, jout = jstep_p({"prev_idx": jnp.int32(prev_slot)}, jnp.asarray(jpool), jnp.int32(slot))
        np.testing.assert_allclose(
            out_p.numpy(), np.asarray(jout)[:B], atol=ATOL, rtol=0
        )
    with pytest.raises(ValueError, match="pool step"):
        tfft.make_fft_fleet_step_pool(cfg, B, backend="matmul", device="cpu")
    with pytest.raises(ValueError, match="pool must be"):
        step_p(st_p, pool[:, :-1], 0)


def test_auto_backend_resolution():
    """``auto`` is matmul on the CPU (as JAX off the TPU) and magsplit on
    the card wherever the pair has a band plan (JAX's TPU rule)."""
    cuda = torch.device("cuda")  # resolution only: no card needed
    for n_in, n_out in ((1176, 1280), (588, 1280)):
        cfg = tfft.FftConfig(channels=2, fft_size_input=n_in, fft_size_output=n_out)
        assert tfft._resolve_backend(cfg, "auto", torch.device("cpu")) == "matmul"
        assert tfft._resolve_backend(cfg, "auto", cuda) == "magsplit"
        jcfg = jfft.FftConfig(channels=2, fft_size_input=n_in, fft_size_output=n_out)
        assert jfft._resolve_backend(jcfg, "auto") == "matmul"
    cfg = tfft.FftConfig(channels=2, fft_size_input=512, fft_size_output=1024)
    assert tfft._resolve_backend(cfg, "auto", cuda) == "matmul"  # no band plan
    assert tfft._resolve_backend(cfg, "conv", cuda) == "conv"
    assert trt.ResamplerFft(2, 44100, 48000, device="cpu").state.keys() == {"overlap"}
    with pytest.raises(ValueError, match="no\nviable band plan|no viable band plan"):
        trt.ResamplerFft(1, 48000, 96000, backend="magsplit", device="cpu")
    with pytest.raises(ValueError, match="unknown FFT backend"):
        trt.ResamplerFft(1, 48000, 96000, backend="dft", device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        trt.BatchedResamplerFft(2, 2, 44100, 48000, mesh=object(), device="cpu")


def test_prev_to_overlap_conversion():
    """A magsplit ``{"prev"}`` carry restores into a matmul resampler
    (``prev @ T[:, M:]``, as JAX's conversion); the reverse raises."""
    rng = np.random.default_rng(6)
    a = trt.ResamplerFft(2, IN_HZ, OUT_HZ, backend="magsplit", device="cpu")
    x1, x2 = (rng.standard_normal(a.chunk_size_input()).astype(np.float32) for _ in range(2))
    out = np.zeros(a.chunk_size_output(), np.float32)
    a.resample(x1, out)
    saved = state_to_numpy(a.state)
    a.resample(x2, out)
    b = trt.ResamplerFft(2, IN_HZ, OUT_HZ, backend="matmul", device="cpu")
    b.state = saved
    assert b.state.keys() == {"overlap"}
    jconv = jfft.convert_fft_state(
        {"prev": jnp.asarray(saved["prev"])}, jfft.FftConfig(2, 588, 1280), "matmul"
    )
    np.testing.assert_allclose(
        b.state["overlap"].numpy(), np.asarray(jconv["overlap"]), atol=ATOL, rtol=0
    )
    out2 = np.zeros_like(out)
    b.resample(x2, out2)
    np.testing.assert_allclose(out2, out, atol=5e-4)  # magsplit vs dense: the JAX test's bound
    with pytest.raises(ValueError, match="not invertible"):
        tfft.convert_fft_state(
            {"overlap": torch.zeros(2, 1280)}, a._config, "magsplit", device="cpu"
        )
    with pytest.raises(ValueError, match=r"prev must be \[2, 588\]"):
        a.state = {"prev": np.zeros((2, 587), np.float32)}
    f = trt.BatchedResamplerFft(2, 2, IN_HZ, OUT_HZ, backend="matmul", device="cpu")
    f.state = {"prev": np.ones((2, 2, 588), np.float32)}  # fleet carries convert too
    assert f.state["overlap"].shape == (2, 2, 1280)


def test_invalid_buffers_and_process_length():
    r = trt.ResamplerFft(2, 48000, 44100, device="cpu")
    out = np.zeros(r.chunk_size_output(), np.float32)
    with pytest.raises(trt.InvalidInputBufferSize):
        r.resample(np.zeros(r.chunk_size_input() - 1, np.float32), out)
    with pytest.raises(trt.InvalidOutputBufferSize):
        r.resample(
            np.zeros(r.chunk_size_input(), np.float32),
            np.zeros(r.chunk_size_output() - 1, np.float32),
        )
    r = trt.ResamplerFft(2, 44100, 48000, device="cpu")
    assert (r.chunk_size_input(), r.chunk_size_output(), r.delay()) == (2352, 2560, 588)
    x = np.random.default_rng(7).standard_normal(10_000).astype(np.float32)
    y = r.process(x)
    assert y.size == -(-x.size * r.chunk_size_output() // r.chunk_size_input())
    j = jrt.ResamplerFft(2, 44100, 48000)
    np.testing.assert_allclose(y, j.process(x), atol=ATOL, rtol=0)
    assert r.process(np.zeros(0, np.float32)).size == 0
    f = trt.BatchedResamplerFft(2, 2, 44100, 48000, device="cpu")
    with pytest.raises(ValueError, match="chunks must be"):
        f.resample(np.zeros((2, 2, 1175), np.float32))
    with pytest.raises(ValueError, match="chunks must be"):
        f.resample_many(np.zeros((2, 2, 1176), np.float32))


def _stopband_db(r) -> float:
    """tests/test_fft_engine.py::test_stopband_attenuation_fft's measure."""
    ci = r.chunk_size_input()
    x = np.zeros(20 * ci, np.float32)
    x[len(x) // 2] = 1.0
    y = r.process(x)
    peak = int(np.argmax(np.abs(y)))
    window = int(OUT_HZ * 0.1)
    start = max(peak - window // 2, 0)
    spec = np.fft.rfft(y[start : start + window], 1 << 17)
    mag_db = 20 * np.log10(np.maximum(np.abs(spec), 1e-12))

    def bin_of(freq):
        return round(freq / OUT_HZ * (1 << 17))

    nyq_in = IN_HZ / 2
    passband = mag_db[bin_of(20.0) : bin_of(nyq_in * 0.9) + 1]
    stopband = mag_db[bin_of(nyq_in * 1.1) : bin_of(OUT_HZ / 2 * 0.95) + 1]
    return float(passband.max() - stopband.max())


@pytest.mark.parametrize("backend", ["auto", "magsplit"])
def test_stopband_attenuation(backend):
    r = trt.ResamplerFft(1, IN_HZ, OUT_HZ, backend=backend, device="cpu")
    atten = _stopband_db(r)
    assert atten >= 99.0, f"FFT stopband attenuation too low: {atten:.2f} dB"


@pytest.mark.parametrize("backend", ["magsplit", "conv"])
def test_carry_does_not_alias_the_callers_buffers(backend):
    """The input-domain carry keeps the last chunk.  A caller that writes
    into a buffer it passed (a tensor, a resample_many stack, or the
    per-stream numpy buffer of a mono stream, whose deinterleave is a
    view) must not change a later output."""
    B, C, N = 2, 2, 588
    rng = np.random.default_rng(8)
    xs = rng.standard_normal((7, B, C, N)).astype(np.float32)
    a = trt.BatchedResamplerFft(B, C, IN_HZ, OUT_HZ, backend=backend, device="cpu")
    ref = trt.BatchedResamplerFft(B, C, IN_HZ, OUT_HZ, backend=backend, device="cpu")
    buf = torch.empty((B, C, N))
    for i in range(3):
        buf.copy_(torch.from_numpy(xs[i]))
        got = a.resample(buf)
        buf.fill_(1e6)  # the caller reuses its buffer
        assert torch.equal(got, ref.resample(xs[i].copy()))
    stack = torch.from_numpy(xs[3:6].copy())
    got = a.resample_many(stack)
    stack.fill_(-1e6)
    assert torch.equal(got, ref.resample_many(xs[3:6].copy()))
    assert torch.equal(a.resample(xs[6]), ref.resample(xs[6]))

    r = trt.ResamplerFft(1, IN_HZ, OUT_HZ, backend=backend, device="cpu")
    r_ref = trt.ResamplerFft(1, IN_HZ, OUT_HZ, backend=backend, device="cpu")
    inp = np.empty(r.chunk_size_input(), np.float32)
    out, out_ref = (np.zeros(r.chunk_size_output(), np.float32) for _ in range(2))
    for i in range(3):
        x = rng.standard_normal(inp.size).astype(np.float32)
        inp[:] = x
        r.resample(inp, out)
        r_ref.resample(x.copy(), out_ref)
        np.testing.assert_array_equal(out, out_ref)


def test_fft_states_round_trip_with_jax_and_npz(tmp_path):
    """A JAX carry (per stream and fleet, ``prev`` and ``overlap``) loads
    into the port and both continue alike; the port's carry saves with
    the JAX package's ``save_state`` and loads back bit-equal; the pool
    step's ``prev_idx`` round-trips as a 0-d int32."""
    rng = np.random.default_rng(9)
    for backend in ("magsplit", "matmul"):
        j = jrt.ResamplerFft(2, IN_HZ, OUT_HZ, backend=backend)
        t = trt.ResamplerFft(2, IN_HZ, OUT_HZ, backend=backend, device="cpu")
        oj = np.zeros(j.chunk_size_output(), np.float32)
        ot = np.zeros_like(oj)
        j.resample(rng.standard_normal(j.chunk_size_input()).astype(np.float32), oj)
        t.state = state_from_numpy(jax.tree.map(np.asarray, j.state), device="cpu")
        x = rng.standard_normal(j.chunk_size_input()).astype(np.float32)
        j.resample(x, oj)
        t.resample(x, ot)
        np.testing.assert_allclose(ot, oj, atol=ATOL, rtol=0)
        save_state(tmp_path / f"{backend}.npz", state_to_numpy(t.state))
        loaded = state_from_numpy(load_state(tmp_path / f"{backend}.npz", to_device=False), device="cpu")
        assert loaded.keys() == t.state.keys()
        assert all(torch.equal(loaded[k], t.state[k]) for k in loaded)

    jf = jbatched.BatchedResamplerFft(3, 2, IN_HZ, OUT_HZ, backend="magsplit")
    tf = trt.BatchedResamplerFft(3, 2, IN_HZ, OUT_HZ, backend="magsplit", device="cpu")
    jf.resample(rng.standard_normal((3, 2, 588)).astype(np.float32))
    save_state(tmp_path / "fleet.npz", jf.state)
    tf.state = state_from_numpy(load_state(tmp_path / "fleet.npz", to_device=False), device="cpu")
    x = rng.standard_normal((3, 2, 588)).astype(np.float32)
    np.testing.assert_allclose(tf.resample(x).numpy(), np.asarray(jf.resample(x)), atol=ATOL, rtol=0)

    pool_state = state_to_numpy(tfft.fft_fleet_pool_init(prev_idx=5))
    assert pool_state["prev_idx"].dtype == np.int32 and pool_state["prev_idx"].shape == ()
    assert state_from_numpy(pool_state, device="cpu") == {"prev_idx": 5}
    assert state_from_numpy(
        jax.tree.map(np.asarray, jfft.fft_fleet_pool_init(prev_idx=5)), device="cpu"
    ) == {"prev_idx": 5}
    with pytest.raises(TypeError):
        state_from_numpy({"prev": np.zeros((2, 2, 2, 588), np.float32)}, device="cpu")


def test_cpu_engine_launches_nothing():
    before = dict(_build.LAUNCHES)
    f = trt.BatchedResamplerFft(2, 2, IN_HZ, OUT_HZ, backend="magsplit", device="cpu")
    f.resample_many(np.ones((3, 2, 2, 588), np.float32))
    assert _build.LAUNCHES == before
