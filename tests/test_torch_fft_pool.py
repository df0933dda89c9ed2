"""The FFT fleet's ``resample_many`` at the batch transcoder's pair, 48000
-> 44100 Hz (1280 frames in, 1176 out a chunk; the magsplit band at N >
M): 3 stereo streams, T 3 and T 1, on the magsplit plain version (whose
``resample_many`` takes the pool step for chunks 1..T-1) and on
``matmul`` (which loops the fleet step).  ``resample_many`` against T
calls of ``resample``, and against the benchmark's plain reference
(``perfbench/reference/fft.py``) across two chained calls; a pool step
reading its own slot as ``prev`` fails that comparison; the counters
``fft.chunks`` and ``fft.pool_steps`` per call."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import resampler_tpu_torch as rtt
from perfbench.reference.fft import FftReference
from resampler_tpu_torch.utils import tracing

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

B, C, N, M = 3, 2, 1280, 1176
RATES = (48000, 44100)
#: against the float64 reference: the magsplit plain version's three bf16
#: passes (107.5 dB floor) read 1.2e-5 here, the dense f32 projector 2e-6;
#: the benchmark's limit is 2e-4 and its control (TF32) reads ~6e-4
ATOL = {"magsplit": 3e-5, "matmul": 1e-5}
BACKENDS = sorted(ATOL)


def _fleet(backend):
    return rtt.BatchedResamplerFft(B, C, *RATES, backend=backend, device="cpu")


def _stack(seed, T):
    x = np.random.default_rng(seed).uniform(-1, 1, (T, B, C, N)).astype(np.float32)
    return torch.from_numpy(x)


def _reference_err(outs, stacks) -> float:
    """The largest distance of the chained calls' outputs from the
    reference, each chunk on the one before it (chunk 0 of a call on the
    previous call's last)."""
    ref = FftReference(dict(fft_size_input=N, fft_size_output=M, kaiser_beta=10.0), "cpu")
    x = torch.cat(stacks).reshape(-1, B * C, N)
    got = torch.cat(outs).reshape(-1, B * C, M)
    return max(float((got[k].double() - ref.step(x[k - 1] if k else None, x[k])).abs().max())
               for k in range(x.shape[0]))


def test_the_fleet_plans_the_transcoders_chunks():
    cfg = _fleet("matmul").config
    assert (cfg.fft_size_input, cfg.fft_size_output) == (N, M)


@pytest.mark.parametrize("T", [3, 1])
@pytest.mark.parametrize("backend", BACKENDS)
def test_resample_many_is_t_calls_of_resample(backend, T):
    many, one = _fleet(backend), _fleet(backend)
    for call in range(2):
        x = _stack(10 + call, T)
        got = many.resample_many(x)
        want = torch.stack([one.resample(x[t]) for t in range(T)])
        assert got.shape == (T, B, C, M)
        assert torch.equal(got, want)


@pytest.mark.parametrize("T", [3, 1])
@pytest.mark.parametrize("backend", BACKENDS)
def test_chained_calls_match_the_reference(backend, T):
    fleet = _fleet(backend)
    stacks = [_stack(20 + call, T) for call in range(2)]
    outs = [fleet.resample_many(x) for x in stacks]
    assert _reference_err(outs, stacks) <= ATOL[backend]


def test_a_pool_step_reading_its_own_slot_as_prev_fails():
    """The planted fault: chunk ``t``'s pool step reads slot ``t``, its own
    chunk, where the chunk before it belongs."""
    fleet = _fleet("magsplit")
    stacks = [_stack(30 + call, 3) for call in range(2)]
    outs = [fleet.resample_many(stacks[0])]
    inner = fleet._pool_step
    fleet._pool_step = lambda state, pool, idx: inner({"prev_idx": idx}, pool, idx)
    outs.append(fleet.resample_many(stacks[1]))
    assert _reference_err(outs, stacks) > 100 * ATOL["magsplit"]
    assert _reference_err(outs[:1], stacks[:1]) <= ATOL["magsplit"]


@pytest.mark.parametrize("backend,T,pooled", [("magsplit", 3, 2), ("magsplit", 1, 0),
                                              ("matmul", 3, 0), ("matmul", 1, 0)])
def test_counters_count_chunks_and_pool_steps_per_call(backend, T, pooled):
    fleet = _fleet(backend)
    tracing.reset_counters()
    for call in range(2):
        fleet.resample_many(_stack(40 + call, T))
        c = tracing.counters()
        assert c["fft.chunks"] == T * (call + 1)
        assert c["fft.pool_steps"] == pooled * (call + 1)
    fleet.resample(_stack(42, 1)[0])
    c = tracing.counters()
    assert (c["fft.chunks"], c["fft.pool_steps"]) == (2 * T + 1, 2 * pooled)
