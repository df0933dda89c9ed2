"""The port's time-major synchronized fleet on coprime ratios against the
JAX package's: the farrow and lerp bases, the packed (q < 8) heavy
downsampling pairs and the wide u32 schedule, against JAX's
``contraction="xla"`` step over 30+ steps and >= 2 compactions, with
ragged valid counts and NaN junk past them; a short run against JAX's
Pallas kernels (``contraction="dma_interpret"``); and the
``BatchedResamplerFir`` wrapper (``resample``, ``resample_many``, the wide
``slew``).  Schedule integers and the ring are exact; samples are within
``ATOL``."""

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import resampler_tpu as jrt
import resampler_tpu_torch as trt
from resampler_tpu.engine import fir as jfir
from resampler_tpu.engine.batched import BatchedResamplerFir as JaxFleet
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine import fir_fleets as tfleets
from resampler_tpu_torch.ops import fir_dma_kernel as kern
from resampler_tpu_torch.utils.state import state_to_numpy

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

# f32 sums in another order: the JAX suite's own dma-vs-xla tolerance for
# this path (tests/test_pallas.py)
ATOL = 1e-5
HORIZON = 3

# (in_hz, out_hz, taps, path, max_chunk): q 64 farrow and lerp, the packed
# q 1 / 2 / 4 pairs, the wide pair
CASES = [
    (44100, 44101, 32, "auto", 512),
    (44100, 44101, 32, "lerp", 512),
    (367500, 1601, 32, "auto", 512),
    (48000, 1601, 32, "auto", 512),
    (48000, 3001, 32, "auto", 512),
    (600011, 600013, 32, "auto", 512),
]
IDS = ["farrow", "lerp", "packed-q1", "packed-q2", "packed-q4", "wide"]


def _coeffs(in_hz, out_hz, taps):
    cut = tfir.fir_cutoff(taps, trt.Attenuation.Db90, in_hz / out_hz)
    return tfir.fir_coefficients(taps, trt.Attenuation.Db90, cut)


def _steps(in_hz, out_hz, taps, path, max_chunk, B=2, C=2, **kw):
    L, M = jrt.types.reduce_ratio(in_hz, out_hz)
    jc = jfir.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    tc = tfir.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    coeffs = _coeffs(in_hz, out_hz, taps)
    geo = dict(max_chunk=max_chunk, horizon=HORIZON)
    jstep = jax.jit(jfir.make_fir_fleet_step_sync_tm(
        jc, coeffs, B, path=path, out_layout="tm", **geo, **kw))
    tstep = tfleets.make_fir_fleet_step_sync_tm(
        tc, coeffs, B, path=path, out_layout="tm", device="cpu", **geo)
    return (
        jstep, tstep,
        jfir.fir_fleet_init_sync_tm(jc, B, **geo),
        tfleets.fir_fleet_init_sync_tm(tc, B, device="cpu", **geo),
    )


def _assert_state_equal(jstate, tstate):
    js = jax.tree.map(np.asarray, jstate)
    ts = state_to_numpy(tstate)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert js[k].dtype == ts[k].dtype, k
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sync_tm_coprime_matches_jax(case):
    max_chunk = case[-1]
    jstep, tstep, js, ts = _steps(*case, contraction="xla")
    R = ts["buffer"].shape[1]
    rng = np.random.default_rng(0)
    compactions = produced = 0
    before = dict(kern.LAUNCHES)
    for i in range(34):
        nv = max_chunk if i % 3 else int(rng.integers(0, max_chunk + 1))
        chunk = rng.standard_normal((max_chunk, R)).astype(np.float32)
        chunk[nv:] = np.nan  # junk past n_valid never reaches the ring
        fill_before = ts["fill"]
        js, oj, cj, pj = jstep(js, chunk, np.int32(nv))
        ts, ot, ct, pt = tstep(ts, torch.from_numpy(chunk), nv)
        assert (ct, pt) == (int(cj), int(pj)), i
        assert torch.isfinite(ot).all()
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
        _assert_state_equal(js, ts)
        compactions += ts["fill"] < fill_before
        produced += pt
    assert compactions >= 2 and produced > 0
    assert kern.LAUNCHES == before  # the CPU path launches nothing


@pytest.mark.parametrize(
    "case", [(44100, 44101, 32, "auto", 512), (48000, 3001, 32, "auto", 2048)],
    ids=["b2-q64", "b3-q4"],
)
def test_sync_tm_coprime_matches_jax_pallas(case):
    """Six steps against the JAX fleet running its Pallas kernels in
    interpret mode (pre-shifted weights, aligned reads, packed groups)."""
    max_chunk = case[-1]
    jstep, tstep, js, ts = _steps(*case, contraction="dma_interpret")
    rng = np.random.default_rng(1)
    produced = 0
    for _ in range(6):
        chunk = rng.standard_normal((max_chunk, 4)).astype(np.float32)
        js, oj, cj, pj = jstep(js, chunk, np.int32(max_chunk))
        ts, ot, ct, pt = tstep(ts, torch.from_numpy(chunk), max_chunk)
        assert (ct, pt) == (int(cj), int(pj))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
        produced += pt > 0
    assert produced >= 4


def _compare(jres, tres):
    (oj, cj, pj, kj), (ot, ct, pt, kt) = jres, tres
    np.testing.assert_array_equal(ct, np.asarray(cj))
    np.testing.assert_array_equal(pt, np.asarray(pj))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
    assert abs(float(kt) - float(kj)) <= ATOL


@pytest.mark.parametrize(
    "in_hz,out_hz,path", [(44100, 44101, "lerp"), (600011, 600013, "auto"), (44100, 48000, "farrow")],
    ids=["lerp", "wide", "farrow-on-periodic"],
)
def test_batched_wrapper_matches_jax(in_hz, out_hz, path):
    """``resample`` (partial valid counts, the fleet slew) and
    ``resample_many`` against the JAX wrapper; ``farrow`` is selectable on
    a periodic ratio, as in JAX."""
    B, C, mc = 3, 2, 512
    kw = dict(synchronized=True, max_chunk=mc, horizon=HORIZON, path=path)
    j = JaxFleet(B, C, in_hz, out_hz, jrt.Latency.Sample16, jrt.Attenuation.Db90, **kw)
    t = trt.BatchedResamplerFir(
        B, C, in_hz, out_hz, trt.Latency.Sample16, trt.Attenuation.Db90, device="cpu", **kw
    )
    rng = np.random.default_rng(4)
    for i, nv in enumerate([512, 300, 512, 0, 512, 77, 512, 512, 200, 512]):
        chunks = rng.standard_normal((B, mc, C)).astype(np.float32)
        n_valid = np.full((B,), nv, np.int32)
        n_valid[1] += 5  # the shared schedule takes the fleet minimum
        _compare(j.resample(chunks, n_valid), t.resample(chunks, n_valid))
        _assert_state_equal(j.state, t.state)
        if i == 4:
            for s in (0.25, -3.7, 2.0, -1e9):
                assert t.slew(s) == pytest.approx(float(j.slew(s)), abs=0)
            _assert_state_equal(j.state, t.state)
    chunks4 = rng.standard_normal((4, B, mc, C)).astype(np.float32)
    nv4 = np.asarray([512, 100, 0, 512], np.int32)
    _compare(j.resample_many(chunks4, nv4), t.resample_many(chunks4, nv4))
    _assert_state_equal(j.state, t.state)
