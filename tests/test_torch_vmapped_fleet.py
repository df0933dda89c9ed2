"""The port's vmapped fleet (``BatchedResamplerFir``'s default,
``synchronized=False``: every stream with its own schedule) against the
JAX package's on the same seeded feeds: ragged per-stream valid counts
with NaN junk past them, across the end-aligned slide, per-stream
``slew`` with its clamps, ``resample_many`` and the state carried both
ways.  Ints and states exactly equal; samples within 2e-6 (1e-5 on wide
pairs, as tests/test_batched.py)."""

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import resampler_tpu as jrt
import resampler_tpu_torch as trt
from resampler_tpu.utils.checkpoint import load_state, save_state
from resampler_tpu_torch.ops import _build
from resampler_tpu_torch.utils.state import state_from_numpy, state_to_numpy

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

B, C = 3, 2


def _fleets(in_hz, out_hz, path="auto"):
    args = (B, C, in_hz, out_hz)
    j = jrt.BatchedResamplerFir(*args, jrt.Latency.Sample32, jrt.Attenuation.Db90, path=path)
    t = trt.BatchedResamplerFir(*args, trt.Latency.Sample32, trt.Attenuation.Db90, path=path,
                                device="cpu")
    return j, t


def _assert_states_equal(jstate, tstate):
    js, ts = jax.tree.map(np.asarray, jstate), state_to_numpy(tstate)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert js[k].dtype == ts[k].dtype and js[k].shape == ts[k].shape, k
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def _compare(jres, tres, atol):
    (oj, cj, pj, kj), (ot, ct, pt, kt) = jres, tres
    np.testing.assert_array_equal(ct, np.asarray(cj))
    np.testing.assert_array_equal(pt, np.asarray(pj))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=atol, rtol=0)
    assert abs(float(kt) - float(kj)) <= atol


def _ragged(rng, n, i):
    """Per-stream valid counts: stream 0 full, one stream empty on some
    steps, the rest random; NaN junk past each count."""
    chunks = rng.standard_normal((B, n, C)).astype(np.float32)
    nv = rng.integers(0, n + 1, B)
    nv[0] = n
    if i % 3 == 1:
        nv[1 + i % 2] = 0
    chunks[np.arange(n)[None, :] >= nv[:, None]] = np.nan
    return chunks, nv


# (in_hz, out_hz, path, chunk, steps, atol): periodic up and down (kernel
# B9's plain version), farrow and lerp coprime, the wide u32 schedule, and
# heavy wide downsampling whose position runs past the buffered frames
CASES = [
    (44100, 48000, "auto", 512, 14, 2e-6),
    (48000, 44100, "auto", 512, 14, 2e-6),
    (44100, 44101, "auto", 512, 12, 2e-6),
    (44100, 44101, "lerp", 512, 12, 2e-6),
    (600011, 600013, "auto", 512, 12, 1e-5),
    (10_000_000, 3, "auto", 4096, 6, 1e-5),
]


@pytest.mark.parametrize(
    "in_hz,out_hz,path,n,steps,atol", CASES,
    ids=["44k1-48k", "48k-44k1", "farrow", "lerp", "wide", "wide-10M-3"],
)
def test_vmapped_fleet_matches_jax(in_hz, out_hz, path, n, steps, atol):
    """``resample`` over ragged per-stream feeds, with per-stream slews
    part-way: a vector, a scalar (every stream), and one that hits the
    history clamp (and, narrow, the int32 ceiling)."""
    j, t = _fleets(in_hz, out_hz, path)
    _assert_states_equal(j.state, t.state)
    rng = np.random.default_rng(5)
    launches = dict(_build.LAUNCHES)
    slews = {3: [0.25, -0.5, 3.0], 6: 0.75, 9: [-40.0, 0.0, 1e5]}
    for i in range(steps):
        chunks, nv = _ragged(rng, n, i)
        _compare(j.resample(chunks, nv), t.resample(chunks, nv), atol)
        _assert_states_equal(j.state, t.state)
        if i in slews:
            s = slews[i]
            got, want = t.slew(s), j.slew(np.asarray(s, np.float64))
            assert got.shape == (B,) and got.dtype == np.float64
            np.testing.assert_array_equal(got, np.asarray(want))
            _assert_states_equal(j.state, t.state)
    assert _build.LAUNCHES == launches  # the CPU runs the plain version


@pytest.mark.parametrize("in_hz,out_hz", [(44100, 48000), (600011, 600013)], ids=["periodic", "wide"])
def test_vmapped_resample_many_matches_jax_and_loop(in_hz, out_hz):
    """``resample_many`` with ``[T, B]`` and ``[T]`` valid counts against
    JAX's scan and against ``T`` calls of ``resample``."""
    atol = 1e-5 if in_hz == 600011 else 2e-6
    j, t = _fleets(in_hz, out_hz)
    loop, many = _fleets(in_hz, out_hz)[1], _fleets(in_hz, out_hz)[1]
    rng = np.random.default_rng(6)
    T, n = 4, 256
    chunks = rng.standard_normal((T, B, n, C)).astype(np.float32)
    nv = rng.integers(0, n + 1, (T, B))
    nv[1, 2] = 0
    _compare(j.resample_many(chunks, nv), t.resample_many(chunks, nv), atol)
    _assert_states_equal(j.state, t.state)
    outs = [loop.resample(chunks[k], nv[k]) for k in range(T)]
    ot, ct, pt, _ = many.resample_many(chunks, nv)
    for k, (o, c, p, _) in enumerate(outs):
        np.testing.assert_array_equal(ct[k], c)
        np.testing.assert_array_equal(pt[k], p)
        np.testing.assert_array_equal(ot[k].numpy(), o.numpy())
    nv1 = np.asarray([n, 0, 100, n])  # [T] broadcasts over the streams
    _compare(j.resample_many(chunks, nv1), t.resample_many(chunks, nv1), atol)
    _assert_states_equal(j.state, t.state)


def test_vmapped_wide_slew_zero_is_identity_past_capacity():
    """tests/test_batched.py:309: heavy wide downsampling carries the
    position far past ``input_capacity * M``; ``slew(0.0)`` moves nothing
    and a small positive request is applied exactly."""
    j, t = _fleets(10_000_000, 3)
    rng = np.random.default_rng(3)
    for _ in range(4):
        x = rng.standard_normal((B, 4096, C)).astype(np.float32)
        j.resample(x)
        t.resample(x)
    _assert_states_equal(j.state, t.state)
    assert int(np.asarray(t.state["pos_hi"]).max()) > 4096
    before = state_to_numpy(t.state)
    np.testing.assert_array_equal(t.slew(0.0), np.zeros(B))
    for k, v in state_to_numpy(t.state).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    np.testing.assert_array_equal(t.slew(1.0), np.asarray(j.slew(1.0)))
    _assert_states_equal(j.state, t.state)


def test_vmapped_state_round_trip(tmp_path):
    """A JAX vmapped fleet state (and its ``.npz`` checkpoint) loaded into
    the port steps like JAX's, and the port's numpy form is JAX's: a
    ``[B, C, alloc]`` buffer with ``[B]`` int32 counts (uint32 words when
    wide) and no ``start``."""
    for in_hz, out_hz in ((44100, 48000), (600011, 600013)):
        j, t = _fleets(in_hz, out_hz)
        rng = np.random.default_rng(7)
        for i in range(4):
            chunks, nv = _ragged(rng, 512, i)
            j.resample(chunks, nv)
        save_state(tmp_path / "fleet.npz", j.state)
        for state_np in (jax.tree.map(np.asarray, j.state),
                         load_state(tmp_path / "fleet.npz", to_device=False)):
            t.state = state_from_numpy(state_np, device="cpu")
            _assert_states_equal(j.state, t.state)
        for i in range(3):
            chunks, nv = _ragged(rng, 512, i)
            _compare(j.resample(chunks, nv), t.resample(chunks, nv), 1e-5)
            _assert_states_equal(j.state, t.state)
        # and back: the port's numpy form steps in JAX's fleet
        j2 = _fleets(in_hz, out_hz)[0]
        j2.state = state_to_numpy(t.state)
        chunks, nv = _ragged(rng, 512, 1)
        _compare(j2.resample(chunks, nv), t.resample(chunks, nv), 1e-5)
        _assert_states_equal(j2.state, t.state)
    with pytest.raises(TypeError):  # [B] counts of another length than the buffer's
        state_from_numpy(dict(state_to_numpy(t.state), available_frames=np.zeros(2, np.int32)),
                         device="cpu")


def test_vmapped_fleet_options():
    args = (2, 2, 44100, 48000)
    with pytest.raises(ValueError, match="initial_positions"):
        trt.BatchedResamplerFir(*args, initial_positions=[0, 1], device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        trt.BatchedResamplerFir(*args, path="gather", device="cpu")
    with pytest.raises(ValueError):  # wide pairs take the farrow path only
        trt.BatchedResamplerFir(2, 1, 600011, 600013, path="lerp", device="cpu")
    t = trt.BatchedResamplerFir(*args, path="farrow", device="cpu")
    # chunks up to input_capacity, whatever max_chunk says (as in JAX)
    out, c, p, _ = t.resample(np.zeros((2, 4096, 2), np.float32), [4096, 7])
    assert c.tolist() == [4096, 7] and c.dtype == np.int32 and out.shape[0] == 2
    with pytest.raises(ValueError):
        t.resample(np.zeros((2, 4097, 2), np.float32))
    with pytest.raises(ValueError):
        t.resample(np.zeros((2, 64, 2), np.float32), [64, -1])
