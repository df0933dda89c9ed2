"""Kernel B6's plain version (``ops/fir_async_kernel.py``) against the JAX
package: against the TPU kernel ``build_async_combine`` run in Pallas
interpret mode as ``tests/test_async_kernel.py`` runs it (within that
suite's 8e-5, set by the TPU kernel's bf16x4 contraction), and against the
JAX XLA async step's formula on crafted states (within 2e-5), starved ones
with a frame skew past ``skew_periods`` among them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from resampler_tpu.engine import fir as jfir
from resampler_tpu.types import reduce_ratio
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine import fir_fleets as tfleets
from resampler_tpu_torch.ops import _build
from resampler_tpu_torch.ops import fir_async_kernel as b6
from resampler_tpu_torch.types import Attenuation

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

INTERPRET_ATOL = 8e-5  # tests/test_async_kernel.py (bf16x4 degree-banded contraction)
XLA_ATOL = 2e-5  # tests/test_async_fleet.py
CHUNK = 512


def _setup(in_hz, out_hz, taps, C=2):
    L, M = reduce_ratio(in_hz, out_hz)
    coeffs = tfir.fir_coefficients(
        taps, Attenuation.Db90, tfir.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz)
    )
    kw = dict(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    return jfir.FirConfig(**kw), tfir.FirConfig(**kw), coeffs


@pytest.mark.parametrize(
    "in_hz,out_hz,taps,phases,skew,max_out",
    [
        (44100, 44101, 64, [0, 14700, 44100], 1, None),
        (48000, 44101, 32, [0, 999, 44000], 1, None),
        (22050, 96000, 16, [0, 100, 300], 2, None),
        (4_000_000_000, 4_000_000_001, 64, [0, 7, 1_000_000], 1, 512 + 64),
    ],
    ids=["shift", "dual", "shift_skew2", "wide_planes"],
)
def test_plain_matches_pallas_interpret(in_hz, out_hz, taps, phases, skew, max_out):
    """The cases and feeds of ``test_async_kernel_interpret_matches_xla``:
    the JAX step with the TPU kernel in interpret mode against the port's
    step, whose combine on the CPU is B6's plain version."""
    jc, tc, coeffs = _setup(in_hz, out_hz, taps)
    B = len(phases)
    kw = dict(max_chunk=CHUNK, horizon=2, skew_periods=skew)
    jstep = jax.jit(jfir.make_fir_fleet_step_async_tm(
        jc, coeffs, B, kernel="pallas_interpret", max_out=max_out, **kw))
    tstep = tfleets.make_fir_fleet_step_async_tm(tc, coeffs, B, max_out=max_out, device="cpu", **kw)
    pos = np.asarray(phases, object)
    js = jfir.fir_fleet_init_async_tm(jc, B, pos_num=pos, **kw)
    ts = tfleets.fir_fleet_init_async_tm(tc, B, pos_num=pos, device="cpu", **kw)
    rng = np.random.default_rng(5)
    total = 0
    for nv in [512, 0, 300, 512, 17, 512, 512, 400]:
        d = rng.standard_normal((CHUNK, B * 2)).astype(np.float32)
        d[nv:] = 0.0
        js, oj, cj, pj = jstep(js, jnp.asarray(d), jnp.int32(nv))
        ts, ot, ct, pt = tstep(ts, torch.from_numpy(d), nv)
        assert (pt, ct) == (int(pj), int(cj))
        np.testing.assert_allclose(ot[:, :pt].numpy(), np.asarray(oj)[:, :pt], atol=INTERPRET_ATOL, rtol=0)
        total += pt
    assert total > 1000


def _jax_state(jc, B, pos, start, fill, buf, skew):
    state = dict(jfir.fir_fleet_init_async_tm(jc, B, max_chunk=CHUNK, horizon=3, skew_periods=skew))
    state.update(buffer=jnp.asarray(buf), start=jnp.int32(start), fill=jnp.int32(fill))
    M = jc.ratio_den
    if jc.wide:
        state.update(pos_hi=jnp.asarray([p // M for p in pos], jnp.uint32),
                     pos_lo=jnp.asarray([p % M for p in pos], jnp.uint32))
    else:
        state.update(pos_num=jnp.asarray(pos, jnp.int32))
    return state


def _port_inputs(tc, pos, start, fill, out_cap):
    """``(base0, n_out, lanes)`` as the async step derives them."""
    M, avail = tc.ratio_den, fill - start
    pos = np.asarray(pos, np.int64)
    if tc.wide:
        hi, lo = pos // M, pos % M
        mx = int(hi.max())
        n_out = min(tfir.WideSchedule(tc, out_cap).emitted(mx, int(lo[hi == mx].max()), avail), out_cap)
        b0 = min(int(hi.min()), avail)
        base_rel, res = hi - b0, lo
    else:
        n_out = tfir._compute_n_out(tc, int(pos.max()), avail, out_cap)
        b0 = min(int(pos.min()) // M, avail)
        base_rel, res = np.divmod(pos - b0 * M, M)
    lanes = torch.from_numpy(np.stack([np.repeat(res, tc.channels), np.repeat(base_rel, tc.channels)]))
    return start + b0, n_out, lanes


@pytest.mark.parametrize(
    "in_hz,out_hz,taps,pos,skew,start,fill,starved",
    [
        (44100, 44101, 64, [0, 14700, 44100], 1, 3, 1900, False),
        (48000, 44101, 32, [5, 999, 44000], 1, 17, 1100, False),
        (22050, 96000, 16, [0, 100, 3 * 320 // 2], 2, 0, 700, False),
        (4_000_000_000, 4_000_000_001, 64, [0, 7, 1_000_000], 1, 2, 1500, False),
        # the spread passes the skew: stream 1's base_rel is 3 > skew_periods
        # while the laggard still emits, so it reads offset 0
        (44100, 44101, 64, [0, 3 * 44101 + 5, 20000], 1, 0, 1200, True),
        # every stream is past the buffered frames: b0 clamps at avail
        (44100, 44101, 64, [4000 * 44101, 4000 * 44101 + 9, 4001 * 44101], 1, 5, 300, True),
    ],
    ids=["shift", "dual", "skew2", "wide", "starved-emitting", "starved-clamped"],
)
def test_plain_matches_xla_formula(in_hz, out_hz, taps, pos, skew, start, fill, starved):
    """One JAX XLA step (``kernel="xla"``, nothing appended) on a crafted
    ring and positions against B6's plain version called directly."""
    jc, tc, coeffs = _setup(in_hz, out_hz, taps)
    B, R = len(pos), 2 * len(pos)
    jstep = jax.jit(jfir.make_fir_fleet_step_async_tm(
        jc, coeffs, B, max_chunk=CHUNK, horizon=3, skew_periods=skew, out_layout="tm", kernel="xla"))
    rows = tfleets._ring_rows(tc, CHUNK, 3)
    buf = np.random.default_rng(1).standard_normal((rows, R)).astype(np.float32)
    _, oj, _, pj = jstep(_jax_state(jc, B, pos, start, fill, buf, skew), jnp.zeros((CHUNK, R)), jnp.int32(0))
    out_cap = oj.shape[0]
    base0, n_out, lanes = _port_inputs(tc, pos, start, fill, out_cap)
    assert n_out == int(pj)
    assert (int(lanes[1].max()) > skew) == starved
    plan = b6.async_combine_plan(
        A=tfir.farrow_matrix(coeffs)[0], L=tc.ratio_num, M=tc.ratio_den, out_cap=out_cap,
        skew_periods=skew, clamp_j=tc.input_capacity + 2 if tc.wide else None,
    )
    before = dict(_build.LAUNCHES)
    got = b6.async_combine(torch.from_numpy(buf), base0, n_out, lanes, plan)
    assert _build.LAUNCHES == before  # a CPU tensor runs the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(oj), atol=XLA_ATOL, rtol=0)
    assert torch.all(got[n_out:] == 0.0)


def test_wrapper_checks_its_inputs():
    _, tc, coeffs = _setup(44100, 44101, 16)
    plan = b6.async_combine_plan(A=tfir.farrow_matrix(coeffs)[0], L=tc.ratio_num,
                                 M=tc.ratio_den, out_cap=64, skew_periods=1)
    buf = torch.zeros((plan.reach + 4, 6))
    lanes = torch.zeros((2, 6), dtype=torch.int64)
    b6.async_combine(buf, 4, 64, lanes, plan)  # the top bound
    with pytest.raises(IndexError):
        b6.async_combine(buf, 5, 64, lanes, plan)
    with pytest.raises(ValueError):
        b6.async_combine(buf, 0, 65, lanes, plan)
    with pytest.raises(TypeError):
        b6.async_combine(buf, np.int64(0), 1, lanes, plan)
    with pytest.raises(TypeError):
        b6.async_combine(buf, 0, 1, lanes.to(torch.int32), plan)
    with pytest.raises(ValueError):
        b6.async_combine(buf, 0, 1, lanes[:, :5].contiguous(), plan)
    with pytest.raises(ValueError):  # B6 evaluates the degree-7 basis
        b6.async_combine_plan(A=np.zeros((4, 16), np.float32), L=1, M=2, out_cap=4, skew_periods=1)
