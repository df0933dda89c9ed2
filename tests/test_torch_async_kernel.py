"""Kernels B6 and B6b's plain version (``ops/fir_async_kernel.py``) against
the JAX package: against the TPU kernel ``build_async_combine`` run in
Pallas interpret mode as ``tests/test_async_kernel.py`` runs it (B6 within
that suite's 8e-5, set by the TPU kernel's bf16x4 contraction; B6b, the
same bf16x4 products, within 2e-5), and B6 against the JAX XLA async
step's formula on crafted states (within 2e-5), starved ones with a frame
skew past ``skew_periods`` among them.  JAX's interpret-mode step runs once
per case (a module-scoped cache) for all three fleets that are held
against it."""

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
from resampler_tpu_torch.utils.state import state_from_numpy, state_to_numpy

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

INTERPRET_ATOL = 8e-5  # tests/test_async_kernel.py (bf16x4 degree-banded contraction)
XLA_ATOL = 2e-5  # tests/test_async_fleet.py
# B6b against the TPU kernel: the same exact bf16 products; the sums' order,
# the TPU kernel's wrap blend z0 + w (z1 - z0) (B6b selects) and its
# rem * (1/M) (B6b divides) differ.  Measured at most 1.2e-6 over the four
# cases.
BF16X4_ATOL = 2e-5
CHUNK = 512
FEEDS = [512, 0, 300, 512, 17, 512, 512, 400]
RESTORE_AT = 3  # the step whose JAX state the restored port fleet starts from


def _setup(in_hz, out_hz, taps, C=2):
    L, M = reduce_ratio(in_hz, out_hz)
    coeffs = tfir.fir_coefficients(
        taps, Attenuation.Db90, tfir.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz)
    )
    kw = dict(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    return jfir.FirConfig(**kw), tfir.FirConfig(**kw), coeffs


INTERPRET_CASES = {
    "shift": (44100, 44101, 64, [0, 14700, 44100], 1, None),
    "dual": (48000, 44101, 32, [0, 999, 44000], 1, None),
    "shift_skew2": (22050, 96000, 16, [0, 100, 300], 2, None),
    "wide_planes": (4_000_000_000, 4_000_000_001, 64, [0, 7, 1_000_000], 1, 512 + 64),
}


@pytest.fixture(scope="module")
def interpret_runs():
    """The JAX step with the TPU kernel in interpret mode (bf16x4) over
    ``FEEDS``, once per case: per step the state before it (numpy), the
    feed, the output and the schedule ints."""
    runs = {}

    def get(case_id):
        if case_id not in runs:
            in_hz, out_hz, taps, phases, skew, max_out = INTERPRET_CASES[case_id]
            jc, _, coeffs = _setup(in_hz, out_hz, taps)
            B = len(phases)
            kw = dict(max_chunk=CHUNK, horizon=2, skew_periods=skew)
            jstep = jax.jit(jfir.make_fir_fleet_step_async_tm(
                jc, coeffs, B, kernel="pallas_interpret", max_out=max_out, **kw))
            js = jfir.fir_fleet_init_async_tm(jc, B, pos_num=np.asarray(phases, object), **kw)
            rng = np.random.default_rng(5)
            steps = []
            for nv in FEEDS:
                d = rng.standard_normal((CHUNK, B * 2)).astype(np.float32)
                d[nv:] = 0.0
                before = jax.tree.map(np.asarray, js)
                js, oj, cj, pj = jstep(js, jnp.asarray(d), jnp.int32(nv))
                steps.append(dict(state=before, d=d, nv=nv, out=np.asarray(oj), c=int(cj), p=int(pj)))
            runs[case_id] = dict(steps=steps, final=jax.tree.map(np.asarray, js))
        return runs[case_id]

    return get


def _port_run(case_id, run, kernel, atol, *, start=0, check_states=False):
    """Step the port's fleet (on the CPU: the kernel's plain version) over
    the cached JAX run from step ``start`` (from JAX's state there when
    ``start > 0``); returns the largest output difference."""
    in_hz, out_hz, taps, phases, skew, max_out = INTERPRET_CASES[case_id]
    _, tc, coeffs = _setup(in_hz, out_hz, taps)
    B = len(phases)
    kw = dict(max_chunk=CHUNK, horizon=2, skew_periods=skew)
    tstep = tfleets.make_fir_fleet_step_async_tm(
        tc, coeffs, B, max_out=max_out, kernel=kernel, device="cpu", **kw)
    if start:
        ts = state_from_numpy(run["steps"][start]["state"], device="cpu")
    else:
        ts = tfleets.fir_fleet_init_async_tm(tc, B, pos_num=np.asarray(phases, object), device="cpu", **kw)
    steps = run["steps"][start:]
    worst, total = 0.0, 0
    for i, st in enumerate(steps):
        ts, ot, ct, pt = tstep(ts, torch.from_numpy(st["d"]), st["nv"])
        assert (pt, ct) == (st["p"], st["c"])
        np.testing.assert_allclose(ot[:, :pt].numpy(), st["out"][:, :pt], atol=atol, rtol=0)
        worst = max(worst, float(np.abs(ot[:, :pt].numpy() - st["out"][:, :pt]).max(initial=0.0)))
        if check_states:
            want = steps[i + 1]["state"] if i + 1 < len(steps) else run["final"]
            got = state_to_numpy(ts)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        total += pt
    assert total > (1000 if not start else 500)
    return worst


@pytest.mark.parametrize("case_id", list(INTERPRET_CASES))
def test_plain_matches_pallas_interpret(case_id, interpret_runs):
    """The cases and feeds of ``test_async_kernel_interpret_matches_xla``:
    the JAX step with the TPU kernel in interpret mode against the port's
    step, whose combine on the CPU is B6's plain version."""
    _port_run(case_id, interpret_runs(case_id), "auto", INTERPRET_ATOL)


@pytest.mark.parametrize("case_id", list(INTERPRET_CASES))
def test_bf16x4_plain_matches_pallas_interpret(case_id, interpret_runs):
    """``kernel="pallas"``: B6b's plain version against the TPU kernel's
    bf16x4 form, the schedule ints and the ring exactly equal."""
    before = dict(_build.LAUNCHES)
    _port_run(case_id, interpret_runs(case_id), "pallas", BF16X4_ATOL, check_states=True)
    assert _build.LAUNCHES == before  # a CPU tensor runs the plain version


@pytest.mark.parametrize("case_id", list(INTERPRET_CASES))
def test_bf16x4_restores_jax_state(case_id, interpret_runs):
    """A JAX ``kernel="pallas_interpret"`` fleet's state, part-way, loaded
    into the port's ``kernel="pallas"`` fleet carries on to JAX's ints,
    ring and outputs."""
    _port_run(case_id, interpret_runs(case_id), "pallas", BF16X4_ATOL, start=RESTORE_AT,
              check_states=True)


def test_degree_cut_and_weight_split():
    """B6b's degree cut and weight split at the async fleet's basis (Db90,
    44100 -> 44101): the first 5 of 8 degrees take the correction products
    at 16-128 taps, and a_hi, a_lo equal the JAX build's ``astype``
    (``fir_async_kernel.py:400-411``), a_lo zero past the cut."""
    for taps in (16, 32, 64, 128):
        _, tc, coeffs = _setup(44100, 44101, taps)
        A = tfir.farrow_matrix(coeffs)[0]
        plan = b6.async_combine_plan(A=A, L=tc.ratio_num, M=tc.ratio_den, out_cap=64,
                                     skew_periods=1, precision="bf16x4")
        assert plan.dc == 4
        hi = jnp.asarray(A, jnp.float32).astype(jnp.bfloat16)
        lo = (jnp.asarray(A, jnp.float32) - hi.astype(jnp.float32)).astype(jnp.bfloat16)
        np.testing.assert_array_equal(plan.a_hi, np.asarray(hi, np.float32))
        np.testing.assert_array_equal(plan.a_lo[: plan.dc + 1], np.asarray(lo, np.float32)[: plan.dc + 1])
        assert not plan.a_lo[plan.dc + 1 :].any()
    with pytest.raises(ValueError):
        b6.async_combine_plan(A=A, L=1, M=2, out_cap=4, skew_periods=1, precision="bf16x3")


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
