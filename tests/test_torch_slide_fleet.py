"""The port's synchronized slide fleet (``make_fir_fleet_step_sync``,
``BatchedResamplerFir(synchronized=True, sync_variant="slide")``) against
the JAX package's XLA step, channel-major and frames-major, and against
the port's own time-major fleet on the same feed (tests/test_batched.py:186);
the periodic-only and ``path=`` refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import resampler_tpu as jrt
import resampler_tpu_torch as trt
from resampler_tpu.engine import fir as jfir
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine import fir_fleets as tfleets
from resampler_tpu_torch.ops import _build
from resampler_tpu_torch.utils.state import state_from_numpy, state_to_numpy

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ATOL = 2e-6  # tests/test_batched.py:186 (slide against tm)


@pytest.mark.parametrize("channel_major", [False, True], ids=["frames-major", "channel-major"])
def test_slide_step_matches_jax(channel_major):
    """The functional step across the slide: ragged shared valid counts
    with NaN junk past them, schedule and buffer exact."""
    B, C, n, taps = 3, 2, 512, 32
    L, M = jrt.types.reduce_ratio(48000, 44100)
    coeffs = tfir.fir_coefficients(taps, trt.Attenuation.Db90,
                                   tfir.fir_cutoff(taps, trt.Attenuation.Db90, 48000 / 44100))
    jc = jfir.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    tc = tfir.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    jstep = jax.jit(jfir.make_fir_fleet_step_sync(jc, coeffs, B, channel_major=channel_major))
    tstep = tfleets.make_fir_fleet_step_sync(tc, coeffs, B, channel_major=channel_major, device="cpu")
    js, ts = jfir.fir_fleet_init_sync(jc, B), tfleets.fir_fleet_init_sync(tc, B, device="cpu")
    rng = np.random.default_rng(0)
    launches = dict(_build.LAUNCHES)
    for nv in (n, 100, n, 0, n, 37, n, n, 300, n, n, n):
        shape = (B, C, n) if channel_major else (B, n, C)
        chunks = rng.standard_normal(shape).astype(np.float32)
        if channel_major:
            chunks[:, :, nv:] = np.nan
        else:
            chunks[:, nv:] = np.nan
        js, oj, cj, pj = jstep(js, jnp.asarray(chunks), np.int32(nv))
        ts, ot, ct, pt = tstep(ts, torch.from_numpy(chunks), nv)
        assert (ct, pt) == (int(cj), int(pj))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-6, rtol=0)
        jnp_state = jax.tree.map(np.asarray, js)
        tnp_state = state_to_numpy(ts)
        assert sorted(jnp_state) == sorted(tnp_state)
        for k in jnp_state:
            assert jnp_state[k].dtype == tnp_state[k].dtype, k
            np.testing.assert_array_equal(tnp_state[k], jnp_state[k], err_msg=k)
    assert _build.LAUNCHES == launches  # the CPU runs B8's plain version
    # the slide state loads from JAX's numpy form: [B, C, alloc], 0-d ints
    loaded = state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    assert loaded.keys() == ts.keys() and loaded["pos_num"] == ts["pos_num"]


def test_slide_wrapper_matches_tm_and_jax():
    """``sync_variant="slide"`` equals the time-major fleet on the same
    feed (and JAX's slide fleet), ``resample_many`` included; ``slew`` is
    fleet-wide."""
    B, C = 4, 2
    args = (B, C, 44100, 48000)
    kw = dict(synchronized=True, max_chunk=512)
    slide = trt.BatchedResamplerFir(*args, trt.Latency.Sample32, trt.Attenuation.Db90,
                                    sync_variant="slide", device="cpu", **kw)
    tm = trt.BatchedResamplerFir(*args, trt.Latency.Sample32, trt.Attenuation.Db90,
                                 device="cpu", **kw)
    jslide = jrt.BatchedResamplerFir(*args, jrt.Latency.Sample32, jrt.Attenuation.Db90,
                                     sync_variant="slide", **kw)
    rng = np.random.default_rng(8)
    for i in range(8):
        chunks = rng.standard_normal((B, 320, C)).astype(np.float32)
        nv = np.full(B, 320 if i % 3 else 111)
        nv[2] += 5  # the shared cadence takes the fleet minimum
        (oa, ca, pa, ka), (ob, cb, pb, kb) = tm.resample(chunks, nv), slide.resample(chunks, nv)
        oj, cj, pj, kj = jslide.resample(chunks, nv)
        for c, p in ((ca, pa), (np.asarray(cj), np.asarray(pj))):
            np.testing.assert_array_equal(cb, c)
            np.testing.assert_array_equal(pb, p)
        np.testing.assert_allclose(ob.numpy(), oa.numpy(), atol=ATOL, rtol=0)
        np.testing.assert_allclose(ob.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
        assert abs(float(kb) - float(kj)) <= ATOL
        if i == 4:
            assert slide.slew(0.5) == tm.slew(0.5) == float(jslide.slew(0.5))
    chunks4 = rng.standard_normal((3, B, 320, C)).astype(np.float32)
    nv4 = np.asarray([320, 0, 200])
    (oa, ca, pa, _), (ob, cb, pb, _) = tm.resample_many(chunks4, nv4), slide.resample_many(chunks4, nv4)
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_allclose(ob.numpy(), oa.numpy(), atol=ATOL, rtol=0)
    assert int(slide.state["pos_num"]) == tm.state["pos_num"]
    with pytest.raises(ValueError, match="synchronized"):
        slide.slew(np.zeros(B))


def test_slide_fleet_refusals():
    args = (2, 2, 44100, 44101)
    with pytest.raises(ValueError, match="periodic"):  # coprime: no banded atlas
        trt.BatchedResamplerFir(*args, synchronized=True, sync_variant="slide", device="cpu")
    with pytest.raises(ValueError, match="path="):
        trt.BatchedResamplerFir(2, 2, 44100, 48000, synchronized=True, sync_variant="slide",
                                path="periodic", device="cpu")
    with pytest.raises(ValueError, match="initial_positions"):
        trt.BatchedResamplerFir(2, 2, 44100, 48000, synchronized=True, sync_variant="slide",
                                initial_positions=[0, 1], device="cpu")
    cfg = tfir.FirConfig(channels=2, taps=32, ratio_num=44100, ratio_den=44101)
    with pytest.raises(ValueError, match="periodic"):
        tfleets.make_fir_fleet_step_sync(cfg, np.zeros((tfir.PHASES, 32), np.float32), 2,
                                         device="cpu")
