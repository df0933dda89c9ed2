"""The time-major sync fleet's ``precision="bf16x4"`` (kernel B7 in four
passes on the card, its plain version here) against the JAX package's
``make_fir_fleet_step_sync_tm(precision="bf16x4")`` on the CPU: ragged
feeds with NaN junk past ``n_valid``, across compactions, schedule ints
and ring exactly equal, samples within 1e-5 (both sides take the same
exact bf16 products; only the f32 sum order differs); a JAX bf16x4
fleet's state carried into the port; and the farrow path, where the
precision does not apply."""

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
from resampler_tpu_torch.utils.state import state_from_numpy, state_to_numpy

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

#: the JAX bf16x4 form against the port's: the same exact products, f32
#: sums (JAX) against one f64 sum rounded once (measured at most 9.5e-7)
ATOL = 1e-5
CHUNK, HORIZON, B, C, TAPS = 512, 2, 4, 2, 64
FEEDS = [512, 300, 512, 0, 512, 17, 512, 512, 401, 512] * 3  # 30 steps, two compactions
RESTORE_AT = 5


def _configs(in_hz, out_hz):
    L, M = reduce_ratio(in_hz, out_hz)
    coeffs = tfir.fir_coefficients(
        TAPS, Attenuation.Db90, tfir.fir_cutoff(TAPS, Attenuation.Db90, in_hz / out_hz)
    )
    kw = dict(channels=C, taps=TAPS, ratio_num=L, ratio_den=M)
    return jfir.FirConfig(**kw), tfir.FirConfig(**kw), coeffs


def _assert_states_equal(jstate_np, tstate):
    ts = state_to_numpy(tstate)
    assert sorted(jstate_np) == sorted(ts)
    for k in jstate_np:
        assert jstate_np[k].dtype == ts[k].dtype, k
        np.testing.assert_array_equal(ts[k], jstate_np[k], err_msg=k)


def _run_pair(in_hz, out_hz, path="auto", restore_at=None):
    """Step JAX's and the port's bf16x4 fleets on the same ragged feed
    (the port's from JAX's state from step ``restore_at`` when given);
    returns the largest output difference and the port's outputs."""
    jc, tc, coeffs = _configs(in_hz, out_hz)
    kw = dict(max_chunk=CHUNK, horizon=HORIZON, out_layout="tm")
    jstep = jax.jit(jfir.make_fir_fleet_step_sync_tm(jc, coeffs, B, precision="bf16x4", path=path, **kw))
    tstep = tfleets.make_fir_fleet_step_sync_tm(tc, coeffs, B, precision="bf16x4", path=path,
                                                device="cpu", **kw)
    js = jfir.fir_fleet_init_sync_tm(jc, B, max_chunk=CHUNK, horizon=HORIZON)
    ts = tfleets.fir_fleet_init_sync_tm(tc, B, max_chunk=CHUNK, horizon=HORIZON, device="cpu")
    rng = np.random.default_rng(3)
    worst, fills, outs = 0.0, [], []
    for i, nv in enumerate(FEEDS):
        chunk = rng.standard_normal((CHUNK, B * C)).astype(np.float32)
        chunk[nv:] = np.nan  # junk past n_valid never reaches the ring
        if i == restore_at:
            ts = state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
        js, oj, cj, pj = jstep(js, chunk, np.int32(nv))
        if restore_at is not None and i < restore_at:
            continue
        ts, ot, ct, pt = tstep(ts, torch.from_numpy(chunk), nv)
        assert (ct, pt) == (int(cj), int(pj))
        assert torch.isfinite(ot).all()
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
        worst = max(worst, float(np.abs(ot.numpy() - np.asarray(oj)).max()))
        _assert_states_equal(jax.tree.map(np.asarray, js), ts)
        fills.append(ts["fill"])
        outs.append(ot)
    if restore_at is None:
        assert sum(b < a for a, b in zip(fills, fills[1:])) >= 2  # compactions
    return worst, outs


@pytest.mark.parametrize("in_hz,out_hz", [(44100, 48000), (48000, 96000)],
                         ids=["44k1-48k", "48k-96k-grouped"])
def test_bf16x4_tm_step_matches_jax(in_hz, out_hz):
    """44.1 -> 48 kHz and the grouped small-M pair (48 -> 96 kHz, g 64)."""
    if in_hz == 48000:
        assert tfir._periodic_group_factor(*reduce_ratio(in_hz, out_hz)) > 1
    before = dict(_build.LAUNCHES)
    _run_pair(in_hz, out_hz)
    assert _build.LAUNCHES == before  # the CPU runs B7's plain version


@pytest.mark.parametrize("in_hz,out_hz", [(44100, 48000), (48000, 96000)],
                         ids=["44k1-48k", "48k-96k-grouped"])
def test_bf16x4_restores_jax_state(in_hz, out_hz):
    """A JAX bf16x4 fleet's state, part-way, loaded into the port's bf16x4
    fleet carries on to JAX's ints, ring and outputs."""
    _run_pair(in_hz, out_hz, restore_at=RESTORE_AT)


def test_bf16x4_differs_from_f32_only_at_its_floor():
    """The bf16x4 fleet against the port's f32 fleet on the same feed:
    close (four passes keep ~16 bits of each operand) but not equal (the
    four products really run)."""
    _, tc, coeffs = _configs(44100, 48000)
    kw = dict(max_chunk=CHUNK, horizon=HORIZON, out_layout="tm", device="cpu")
    steps = [tfleets.make_fir_fleet_step_sync_tm(tc, coeffs, B, precision=p, **kw)
             for p in ("highest", "bf16x4")]
    states = [tfleets.fir_fleet_init_sync_tm(tc, B, max_chunk=CHUNK, horizon=HORIZON, device="cpu")
              for _ in steps]
    rng = np.random.default_rng(4)
    diff = 0.0
    for nv in FEEDS[:6]:
        chunk = torch.from_numpy(rng.standard_normal((CHUNK, B * C)).astype(np.float32))
        outs = []
        for f in range(2):
            states[f], out, _, _ = steps[f](states[f], chunk, nv)
            outs.append(out)
        diff = max(diff, float((outs[0] - outs[1]).abs().max()))
    assert 0 < diff < 1e-4


def test_farrow_bf16x4_is_the_f32_fleet():
    """On the farrow path the precision does not apply (the JAX package's
    farrow contractions are fixed at HIGHEST): the port's bf16x4 fleet
    equals its f32 fleet bit for bit, and JAX's bf16x4 farrow fleet within
    1e-5."""
    jc, tc, coeffs = _configs(44100, 44101)
    kw = dict(max_chunk=CHUNK, horizon=HORIZON, out_layout="tm")
    jstep = jax.jit(jfir.make_fir_fleet_step_sync_tm(jc, coeffs, B, precision="bf16x4", **kw))
    steps = [tfleets.make_fir_fleet_step_sync_tm(tc, coeffs, B, precision=p, device="cpu", **kw)
             for p in ("highest", "bf16x4")]
    js = jfir.fir_fleet_init_sync_tm(jc, B, max_chunk=CHUNK, horizon=HORIZON)
    states = [tfleets.fir_fleet_init_sync_tm(tc, B, max_chunk=CHUNK, horizon=HORIZON, device="cpu")
              for _ in steps]
    rng = np.random.default_rng(5)
    for nv in FEEDS[:8]:
        chunk = rng.standard_normal((CHUNK, B * C)).astype(np.float32)
        js, oj, _, pj = jstep(js, chunk, np.int32(nv))
        outs = []
        for f in range(2):
            states[f], out, _, p = steps[f](states[f], torch.from_numpy(chunk), nv)
            assert p == int(pj)
            outs.append(out)
        torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
        np.testing.assert_allclose(outs[1].numpy(), np.asarray(oj), atol=ATOL, rtol=0)


def test_precision_names():
    _, tc, coeffs = _configs(44100, 48000)
    for bad in ("bf16x3", "high"):
        with pytest.raises(ValueError):
            tfleets.make_fir_fleet_step_sync_tm(tc, coeffs, B, max_chunk=CHUNK, precision=bad, device="cpu")
