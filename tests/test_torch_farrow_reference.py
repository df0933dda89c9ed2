"""The port's phase-locked tm fleet at a coprime pair against the
benchmark's plain reference: 3 stereo streams at 44100 -> 44101 Hz
through ``BatchedResamplerFir(synchronized=True)``, path ``auto`` (the
farrow path: M 44101 is past the periodic path's periods), 5 full
4096-frame chunks of seeded white noise, so that outputs 1..43 (the
residues past the last polyphase branch, ``p1`` = 1023) are among them.
Counts exactly equal ``perfbench/reference/fir.py``'s schedule; samples
within 2e-5 of direct sums over the continued rows of
``perfbench/reference/fir_async.py``; the reference in TF32 (the
benchmark's control) beyond the benchmark's 1e-4; and the departure from
the crate pinned both ways."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import resampler_tpu_torch as rtt
from perfbench.reference import fir as ref
from perfbench.reference import fir_async as rows
from resampler_tpu_torch.engine.fir import resolve_convolve_path

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ATOL = 2e-5  # f32 sums of a 128-tap window, the Farrow fit's ~6e-6 included
LIMIT = 1e-4  # perfbench/limits/fir.farrow.json
B, C, CHUNK, STEPS = 3, 2, 4096, 5
L, M = 44100, 44101
CONFIG = dict(input_rate=L, output_rate=M, taps=128, phases=1024, kaiser_beta=10.0,
              input_capacity=4096)


@pytest.fixture(scope="module")
def driven():
    """``(x [R, frames] f64, [(first, n_out, out [R, out_cap])])``, the
    counts asserted equal to the reference schedule's on the way."""
    fleet = rtt.BatchedResamplerFir(B, C, L, M, rtt.Latency.Sample64, rtt.Attenuation.Db90,
                                    synchronized=True, max_chunk=CHUNK, horizon=16, device="cpu")
    assert resolve_convolve_path(fleet.config, "auto") == "farrow"
    sched = ref.Schedule(L, M, 128, 4096, ref.out_capacity(CONFIG))
    assert fleet.config.out_capacity == ref.out_capacity(CONFIG)
    rng = np.random.default_rng(2024)
    xs, steps, first = [], [], 0
    for k in range(STEPS):
        x = rng.uniform(-1, 1, (B, CHUNK, C)).astype(np.float32)
        out, consumed, produced, _ = fleet.resample(x)
        taken, emitted = (int(v[0]) for v in sched.feed(CHUNK))
        assert (consumed == taken).all() and (produced == emitted).all(), k
        xs.append(x[:, :taken])
        steps.append((first, emitted, out.numpy().transpose(0, 2, 1).reshape(B * C, -1)))
        first += emitted
    x = np.concatenate(xs, axis=1).transpose(0, 2, 1).reshape(B * C, -1)
    return torch.from_numpy(x.astype(np.float64)), steps


def _errors(x, steps, W, control=False):
    """Every output's ``|fleet - reference|`` (``control``: the reference
    in TF32 against the exact one), ``[R, outputs]`` f64."""
    Wt = torch.from_numpy(W)
    errs = []
    for first, n_out, out in steps:
        want = ref.outputs(x, 0, first, n_out, Wt, L, M)
        if control:
            got = ref.outputs(x, 0, first, n_out, Wt, L, M, control=True)
        else:
            got = torch.from_numpy(out[:, :n_out].astype(np.float64))
            assert not out[:, n_out:].any(), "lanes past the step's outputs hold zeros"
        errs.append((got - want).abs())
    return torch.cat(errs, dim=1)


def test_steps_emit_a_chunks_worth(driven):
    _, steps = driven
    emitted = [n for _, n, _ in steps]
    assert emitted[0] == 3970 and all(n in (3969, 3970) for n in emitted[1:])


def test_samples_match_the_continued_rows(driven):
    x, steps = driven
    W, _, _ = rows.phase_weights(CONFIG)
    assert float(_errors(x, steps, W).max()) < ATOL


def test_tf32_control_is_beyond_the_limit(driven):
    """The reference with TF32 operands, the benchmark's control, would be
    refused."""
    x, steps = driven
    W, _, _ = rows.phase_weights(CONFIG)
    assert float(_errors(x, steps, W, control=True).max()) > LIMIT


@pytest.mark.parametrize("clamped", [False, True], ids=["continued", "crate_clamp"])
def test_rows_past_the_last_branch(driven, clamped):
    """The departure from the crate, pinned both ways: at the outputs whose
    residue lies past branch 1023 (outputs 1..43 here) the fleet follows
    the blend continued to the prototype's next point, not the crate's
    clamped last branch."""
    x, steps = driven
    i = np.arange(sum(n for _, n, _ in steps))
    past = torch.from_numpy((i * L % M) * 1024 // M == 1023)
    assert int(past.sum()) == 43 and bool(past[1:44].all())
    W, _, _ = rows.phase_weights(CONFIG, clamped=clamped)
    worst = float(_errors(x, steps, W)[:, past].max())
    if clamped:
        assert worst > 1e-3
    else:
        assert worst < ATOL
