"""The port's async multi-tenant fleet against the benchmark's plain
reference (``perfbench/reference/fir_async.py``): 5 stereo tenants at
44100 -> 44101 Hz joined at drawn phases, full 2048-frame chunks, a slew
of every tenant after every step (one of them cut by the history clamp).
Counts and applied slews exactly equal; samples within 2e-5 (f32 sums
through the Farrow basis against f64 direct sums); the reference in TF32
(the benchmark's control) beyond the benchmark's 1e-4; and the reference's
one departure from the crate (rows past the last polyphase branch) pinned
both ways."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import resampler_tpu_torch as rtt
from perfbench.reference import fir_async as ref
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine.batched import _synchronized_step
from resampler_tpu_torch.engine.fir_fleets import make_fir_fleet_step_async_tm

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ATOL = 2e-5  # f32 sums of a 128-tap window, the Farrow fit's ~6e-6 included
LIMIT = 1e-4  # perfbench/limits/fir.async.json
B, C, CHUNK, MAX_OUT, STEPS = 5, 2, 2048, 2176, 9
CLAMP_STEP = 4  # the step after which every tenant is slewed past the history
CONFIG = dict(input_rate=44100, output_rate=44101, taps=128, phases=1024, kaiser_beta=10.0,
              input_capacity=4096)


def _fleet(kernel, phases):
    fleet = rtt.BatchedResamplerFir(
        B, C, 44100, 44101, rtt.Latency.Sample64, rtt.Attenuation.Db90, synchronized=True,
        sync_variant="async_tm", max_chunk=CHUNK, max_out=MAX_OUT, initial_positions=phases,
        device="cpu")
    if kernel != "auto":
        cutoff = tfir.fir_cutoff(128, rtt.Attenuation.Db90, 44100 / 44101)
        coeffs = tfir.fir_coefficients(128, rtt.Attenuation.Db90, cutoff)
        # the same fleet on another kernel: its step through the fleet's step contract
        fleet._fleet_step = _synchronized_step(make_fir_fleet_step_async_tm(
            fleet.config, coeffs, B, max_chunk=CHUNK, max_out=MAX_OUT, kernel=kernel,
            device="cpu"), B, ring=True)
    return fleet


def _run(kernel, seed=11):
    """Drive the fleet and the reference's schedule side by side: ``(x [R,
    frames] f64, [(start, n_out, out [R, out_cap])], clamps)``, asserting
    counts and applied slews equal on the way."""
    L, M = 44100, 44101
    rng = np.random.default_rng(seed)
    # phases in the first half period: the slews keep the spread under M
    phases = rng.integers(0, M // 2, B)
    fleet = _fleet(kernel, phases)
    sched = ref.AsyncSchedule(L, M, 128, 4096, MAX_OUT, phases)
    xs, steps, clamps = [], [], 0
    for k in range(STEPS):
        x = rng.uniform(-1, 1, (B, CHUNK, C)).astype(np.float32)
        out, consumed, produced, _ = fleet.resample(x)
        taken, emitted, start = sched.feed(CHUNK)
        assert (consumed == taken).all() and (produced == emitted).all(), k
        xs.append(x[:, :taken])
        steps.append((start, emitted, out.numpy().transpose(0, 2, 1).reshape(B * C, -1)))
        if k == CLAMP_STEP:
            v = np.full(B, -(int(sched.pos.min()) + 50))  # past the oldest frame kept
        else:
            v = rng.integers(-441, 442, B)
        got = np.rint(fleet.slew(v / M) * M).astype(np.int64)
        want = sched.slew(v)
        np.testing.assert_array_equal(got, want, err_msg=f"applied slew, step {k}")
        clamps += int((want != v).sum())
        if k == CLAMP_STEP:
            assert (want != v).any(), "the history clamp cut no slew"
    x = np.concatenate(xs, axis=1).transpose(0, 2, 1).reshape(B * C, -1)
    return torch.from_numpy(x.astype(np.float64)), steps, clamps


def _worst(x, steps, W, control=False):
    Wt = torch.from_numpy(W)
    worst = 0.0
    for start, n_out, out in steps:
        want = ref.outputs(x, 0, start, n_out, Wt, 44100, 44101, C, control=control)
        got = torch.from_numpy(out[:, :n_out].astype(np.float64))
        worst = max(worst, float((got - want).abs().max()))
        assert not out[:, n_out:].any(), "lanes past the step's outputs hold zeros"
    return worst


@pytest.fixture(scope="module", params=["auto", "xla"])
def driven(request):
    return _run(request.param)


def test_counts_slews_and_samples_match_the_reference(driven):
    x, steps, clamps = driven
    assert clamps >= 1
    assert min(n for _, n, _ in steps[1:]) >= 2047  # steady steps emit a chunk's worth
    W, _, _ = ref.phase_weights(CONFIG)
    assert _worst(x, steps, W) < ATOL


def test_tf32_control_is_beyond_the_limit(driven):
    """The reference with TF32 operands, the benchmark's control, would be
    refused."""
    x, steps, _ = driven
    W, _, _ = ref.phase_weights(CONFIG)
    Wt = torch.from_numpy(W)
    worst = 0.0
    for start, n_out, _ in steps:
        exact = ref.outputs(x, 0, start, n_out, Wt, 44100, 44101, C)
        tf32 = ref.outputs(x, 0, start, n_out, Wt, 44100, 44101, C, control=True)
        worst = max(worst, float((tf32 - exact).abs().max()))
    assert worst > LIMIT


@pytest.mark.parametrize("clamped", [False, True], ids=["continued", "crate_clamp"])
def test_rows_past_the_last_branch(driven, clamped):
    """The departure from the crate, pinned both ways: the fleet follows
    the blend continued to the prototype's next point, not the crate's
    clamped last branch, and the residues past branch 1023 are reached."""
    x, steps, _ = driven
    W, L, M = ref.phase_weights(CONFIG, clamped=clamped)
    rho = np.concatenate([((start[:, None] + np.arange(n)[None] * L) % M).ravel()
                          for start, n, _ in steps])
    assert (rho * 1024 // M == 1023).any(), "no output sat past the last branch"
    worst = _worst(x, steps, W)
    if clamped:
        assert worst > 1e-3
    else:
        assert worst < ATOL


def test_rows_agree_with_the_crate_elsewhere():
    """Only the residues past the last branch differ between the two."""
    W, _, M = ref.phase_weights(CONFIG)
    Wc, _, _ = ref.phase_weights(CONFIG, clamped=True)
    rho = np.arange(M)
    last = rho * 1024 // M == 1023
    np.testing.assert_array_equal(W[~last], Wc[~last])
    assert last.sum() == 43
    assert np.abs(W[last] - Wc[last]).max() > 5e-4  # a weight; the outputs sum 128 of them
