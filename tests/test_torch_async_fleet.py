"""The port's async time-major fleet step against the JAX package's
(``make_fir_fleet_step_async_tm(kernel="xla")``, the CPU form), on the
cases of ``tests/test_async_fleet.py``: schedule ints and states exactly
equal, samples within that suite's 2e-5."""

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from resampler_tpu.engine import fir as jfir
from resampler_tpu.types import reduce_ratio
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine import fir_fleets as tfleets
from resampler_tpu_torch.ops import _build
from resampler_tpu_torch.types import Attenuation
from resampler_tpu_torch.utils.state import state_to_numpy

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ATOL = 2e-5  # tests/test_async_fleet.py's tolerance
CHUNK = 512
RAGGED = [512, 0, 300, 512, 17, 512, 0, 512, 512, 512, 400, 512]


def _configs(in_hz, out_hz, taps, C=2):
    L, M = reduce_ratio(in_hz, out_hz)
    coeffs = tfir.fir_coefficients(
        taps, Attenuation.Db90, tfir.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz)
    )
    kw = dict(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    return jfir.FirConfig(**kw), tfir.FirConfig(**kw), coeffs


def assert_states_equal(jstate, tstate):
    js = jax.tree.map(np.asarray, jstate)
    ts = state_to_numpy(tstate)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert js[k].dtype == ts[k].dtype and js[k].shape == ts[k].shape, k
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def run_pair(in_hz, out_hz, taps, phases, feeds, *, horizon=3, out_layout="bm",
             max_out=None, skew=1, seed=7):
    """Step the JAX and the port fleet on the same feed; compare every
    step.  Returns the frames produced per stream."""
    jc, tc, coeffs = _configs(in_hz, out_hz, taps)
    B = len(phases)
    kw = dict(max_chunk=CHUNK, horizon=horizon, skew_periods=skew)
    jstep = jax.jit(jfir.make_fir_fleet_step_async_tm(
        jc, coeffs, B, out_layout=out_layout, max_out=max_out, kernel="xla", **kw))
    tstep = tfleets.make_fir_fleet_step_async_tm(
        tc, coeffs, B, out_layout=out_layout, max_out=max_out, device="cpu", **kw)
    js = jfir.fir_fleet_init_async_tm(jc, B, pos_num=np.asarray(phases, object), **kw)
    ts = tfleets.fir_fleet_init_async_tm(
        tc, B, pos_num=np.asarray(phases, object), device="cpu", **kw)
    assert_states_equal(js, ts)
    rng = np.random.default_rng(seed)
    produced = 0
    for nv in feeds:
        data = rng.standard_normal((CHUNK, B * 2)).astype(np.float32)
        data[nv:] = np.nan  # the NaN fence keeps junk out of the ring
        js, oj, cj, pj = jstep(js, data, np.int32(nv))
        ts, ot, ct, pt = tstep(ts, torch.from_numpy(data), nv)
        assert (ct, pt) == (int(cj), int(pj))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
        assert_states_equal(js, ts)
        produced += pt
    return produced


M_441 = reduce_ratio(44100, 44101)[1]
M_WIDE = 600013


@pytest.mark.parametrize(
    "in_hz,out_hz,taps,phases,feeds,kw,min_out",
    [
        (44100, 44101, 64, [0, 0, 0], [CHUNK] * 8, {}, 3000),
        (48000, 44101, 32, [0, 0, 0], [CHUNK] * 8, {}, 3000),
        (44100, 48000, 16, [0, 0, 0], [CHUNK] * 8, {}, 3000),
        (44100, 44101, 64, [0, M_441 // 3, M_441 - 1], [CHUNK] * 8, {}, 3000),
        (44100, 44101, 64, [5, 999, 44100 // 2], RAGGED, dict(horizon=2), 3000),
        (44100, 44101, 32, [0, 12345], [CHUNK] * 6, dict(out_layout="tm"), 2000),
        (367500, 1601, 32, [0, 533, 1600], [CHUNK] * 8, {}, 8),
        (22050, 96000, 16, [0, 100, 300], RAGGED[:8], dict(skew=2, horizon=2), 5000),
        (600011, M_WIDE, 32, [0, M_WIDE // 2, M_WIDE - 7], [CHUNK] * 8, {}, 3000),
        (600011, M_WIDE, 32, [5, M_WIDE // 3, M_WIDE - 1], RAGGED, dict(horizon=2), 3000),
        (4_000_000_000, 4_000_000_001, 32, [0, 7, 1_000_000], RAGGED[:8],
         dict(max_out=CHUNK + 64), 2000),
    ],
    ids=["zero-phase-44k1", "zero-phase-down", "zero-phase-48k", "independent-phases",
         "ragged-compaction", "tm-layout", "heavy-downsample", "skew2-upsample", "wide",
         "wide-ragged", "wide-4e9-max-out"],
)
def test_async_step_matches_jax(in_hz, out_hz, taps, phases, feeds, kw, min_out):
    before = dict(_build.LAUNCHES)
    assert run_pair(in_hz, out_hz, taps, phases, feeds, **kw) >= min_out
    assert _build.LAUNCHES == before  # the CPU runs the plain version


def test_max_out_defers():
    """A capped fleet produces at most ``max_out`` per step, defers the
    rest, and its sequences are the uncapped fleet's (and JAX's)."""
    _, tc, coeffs = _configs(44100, 44101, 32)
    phases = np.asarray([0, 7777])
    kw = dict(max_chunk=CHUNK, horizon=3, device="cpu")
    steps = [tfleets.make_fir_fleet_step_async_tm(tc, coeffs, 2, max_out=m, **kw)
             for m in (200, None)]
    states = [tfleets.fir_fleet_init_async_tm(tc, 2, pos_num=phases, **kw) for _ in steps]
    rng = np.random.default_rng(3)
    seqs = [[[], []], [[], []]]
    for k in range(8):
        nv = CHUNK if k < 4 else 0  # starve so the capped fleet drains its backlog
        data = torch.from_numpy(rng.standard_normal((CHUNK, 4)).astype(np.float32))
        for f in range(2):
            states[f], out, _, p = steps[f](states[f], data, nv)
            assert f == 1 or p <= 200
            for b in range(2):
                seqs[f][b].append(out[b, :p].numpy())
    for b in range(2):
        a, full = np.concatenate(seqs[0][b]), np.concatenate(seqs[1][b])
        assert len(a) > 1000
        np.testing.assert_allclose(a, full[: len(a)], atol=ATOL, rtol=0)
    run_pair(44100, 44101, 32, [0, 7777], [CHUNK] * 4 + [0] * 4, max_out=200)


def test_masked_lanes_zero():
    _, tc, coeffs = _configs(44100, 44101, 32)
    step = tfleets.make_fir_fleet_step_async_tm(tc, coeffs, 2, max_chunk=256, device="cpu")
    state = tfleets.fir_fleet_init_async_tm(tc, 2, max_chunk=256, device="cpu")
    data = np.random.default_rng(0).standard_normal((256, 4)).astype(np.float32)
    state, out, _, p = step(state, torch.from_numpy(data), 256)
    assert 0 < p < tc.out_capacity
    assert torch.all(out[:, p:, :] == 0.0) and torch.any(out[:, :p] != 0.0)


def test_init_validation_and_options():
    tc = tfir.FirConfig(channels=1, taps=16, ratio_num=147, ratio_den=160)
    for pos, match in (([0, 161], "skew invariant"), ([0, 1, 2], "shape"), ([-1, 0], "non-negative")):
        with pytest.raises(ValueError, match=match):
            tfleets.fir_fleet_init_async_tm(tc, 2, max_chunk=256, pos_num=np.asarray(pos), device="cpu")
    tfleets.fir_fleet_init_async_tm(tc, 2, max_chunk=256, pos_num=np.asarray([0, 161]),
                                    skew_periods=2, device="cpu")
    coeffs = np.zeros((tfir.PHASES, 16), np.float32)
    make = tfleets.make_fir_fleet_step_async_tm
    with pytest.raises(NotImplementedError, match="A11"):
        make(tc, coeffs, 2, max_chunk=256, mesh=object(), device="cpu")
    for bad in (dict(kernel="pallas_interpret"), dict(out_layout="bt"), dict(skew_periods=0)):
        with pytest.raises(ValueError):
            make(tc, coeffs, 2, max_chunk=256, device="cpu", **bad)
    step = make(tc, coeffs, 2, max_chunk=256, device="cpu")
    state = tfleets.fir_fleet_init_async_tm(tc, 2, max_chunk=256, device="cpu")
    with pytest.raises(ValueError, match="one value per stream"):
        step(dict(state, pos_num=0), torch.zeros((256, 2)), 256)
