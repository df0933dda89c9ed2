"""The port's phase-locked tm fleet on the wide two-word schedule against
the benchmark's plain reference: 3 stereo streams at 48,000,000 ->
48,000,066 (a clock-domain bridge's rates in millihertz, L/M 8,000,000 /
8,000,011) through ``BatchedResamplerFir(synchronized=True)``, path
``auto`` (the farrow path on the wide schedule: M is past the int32
envelope), 185 full 4096-frame chunks of seeded white noise.

The subframe word ``pos_lo`` is M - 43,670 after step 0 (3970 outputs of
-11/M frames' drift each), falls by 43,659 a step (3969 outputs) and
wraps at step 183: there the lanes' carry splits (945 of its 3970 outputs
carry a frame, against all but output 0 on the steps before and after).
Counts exactly equal ``perfbench/reference/fir.py``'s schedule on every
step; the samples of steps 0-2 and 181-184 are within 2e-5 of
``perfbench/reference/fir_wide.py``'s direct sums; the reference in TF32
(the benchmark's control) lies beyond the cell's 1e-4."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import resampler_tpu_torch as rtt
from perfbench.reference import fir as ref
from perfbench.reference import fir_wide
from resampler_tpu_torch.engine.fir import resolve_convolve_path

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ATOL = 2e-5  # f32 sums of a 128-tap window, the Farrow fit's ~6e-6 included
LIMIT = 1e-4  # perfbench/limits/fir.wide.json
B, C, CHUNK, STEPS = 3, 2, 4096, 185
IN_HZ, OUT_HZ = 48000000, 48000066
L, M = 8000000, 8000011
WRAP_STEP = 183
CHECKED = (0, 1, 2, 181, 182, WRAP_STEP, 184)
CONFIG = dict(input_rate=IN_HZ, output_rate=OUT_HZ, taps=128, phases=1024, kaiser_beta=10.0,
              input_capacity=4096)


@pytest.fixture(scope="module")
def driven():
    """``(x [R, frames] f64, {step: (first, n_out, out [R, out_cap])},
    [pos_lo before each step])``, the counts asserted equal to the
    reference schedule's on the way."""
    fleet = rtt.BatchedResamplerFir(B, C, IN_HZ, OUT_HZ, rtt.Latency.Sample64,
                                    rtt.Attenuation.Db90, synchronized=True, max_chunk=CHUNK,
                                    horizon=16, device="cpu")
    assert fleet.config.wide and (fleet.config.ratio_num, fleet.config.ratio_den) == (L, M)
    assert resolve_convolve_path(fleet.config, "auto") == "farrow"
    sched = ref.Schedule(L, M, 128, 4096, ref.out_capacity(CONFIG))
    assert fleet.config.out_capacity == ref.out_capacity(CONFIG)
    rng = np.random.default_rng(2028)
    xs, steps, words, first = [], {}, [], 0
    for k in range(STEPS):
        words.append(int(fleet.state["pos_lo"]))
        x = rng.uniform(-1, 1, (B, CHUNK, C)).astype(np.float32)
        out, consumed, produced, _ = fleet.resample(x)
        taken, emitted = (int(v[0]) for v in sched.feed(CHUNK))
        assert (consumed == taken).all() and (produced == emitted).all(), k
        xs.append(x[:, :taken])
        if k in CHECKED:
            steps[k] = (first, emitted, out.numpy().transpose(0, 2, 1).reshape(B * C, -1))
        first += emitted
    x = np.concatenate(xs, axis=1).transpose(0, 2, 1).reshape(B * C, -1)
    return torch.from_numpy(x.astype(np.float64)), steps, words


def _errors(x, steps, control=False):
    """Every checked output's ``|fleet - reference|`` (``control``: the
    reference in TF32 against the exact one), ``[R, outputs]`` f64."""
    ext, _, _ = fir_wide.branches(CONFIG)
    errs = []
    for first, n_out, out in steps.values():
        want = fir_wide.outputs(x, 0, first, n_out, ext, L, M)
        if control:
            got = fir_wide.outputs(x, 0, first, n_out, ext, L, M, control=True)
        else:
            got = torch.from_numpy(out[:, :n_out].astype(np.float64))
            assert not out[:, n_out:].any(), "lanes past the step's outputs hold zeros"
        errs.append((got - want).abs())
    return torch.cat(errs, dim=1)


def test_the_checked_steps_cross_a_pos_lo_wrap(driven):
    """``pos_lo`` falls every step and wraps after step 183; in that step
    the lanes' carries split, in the others every lane but 0 carries."""
    _, steps, words = driven
    assert words[0] == 0 and words[1] == M - 11 * 3970
    falls = np.diff(words)
    assert (falls[1:WRAP_STEP] == -11 * 3969).all() and falls[WRAP_STEP] > 0
    s_lane = (np.arange(4096, dtype=np.int64) * L) % M
    for k in CHECKED[1:]:
        n_out = steps[k][1]
        carried = int((words[k] + s_lane[:n_out] >= M).sum())
        assert carried == (945 if k == WRAP_STEP else n_out - 1), k


def test_samples_match_the_reference(driven):
    x, steps, _ = driven
    assert float(_errors(x, steps).max()) < ATOL


def test_tf32_control_is_beyond_the_limit(driven):
    """The reference with TF32 operands, the benchmark's control, would be
    refused."""
    x, steps, _ = driven
    assert float(_errors(x, steps, control=True).max()) > LIMIT
