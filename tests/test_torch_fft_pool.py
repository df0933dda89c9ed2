"""The FFT fleet's ``resample_many`` at the batch transcoder's pair, 48000
-> 44100 Hz (1280 frames in, 1176 out a chunk; the magsplit band at N >
M): 3 stereo streams, T 3 and T 1, on the magsplit plain version (whose
``resample_many`` takes the pool step for chunks 1..T-1) and on
``matmul`` (which loops the fleet step).  ``resample_many`` against T
calls of ``resample``, and against the benchmark's plain reference
(``perfbench/reference/fft.py``) across two chained calls; a pool step
reading its own slot as ``prev`` fails that comparison; the counters
``fft.chunks``, ``fft.pool_steps`` and ``fft.in_place`` per call; the
projector wrappers' ``out=``: its refusals, and on the plain path the
caller's tensor back with the bits ``out=None`` gives."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import resampler_tpu_torch as rtt
from perfbench.reference.fft import FftReference
from resampler_tpu_torch.engine import fft as tfft
from resampler_tpu_torch.ops import fft_magsplit_kernel as mag
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
    fleet._pool_step = lambda state, pool, idx, **kw: inner({"prev_idx": idx}, pool, idx, **kw)
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


@pytest.mark.parametrize("backend,T,in_place", [("magsplit", 3, 3), ("magsplit", 1, 0),
                                                ("matmul", 3, 0), ("matmul", 1, 0)])
def test_in_place_counts_the_chunks_stored_into_the_result(backend, T, in_place):
    """``fft.in_place`` counts T a call where ``resample_many`` pools (chunk
    0 from B4's step, 1..T-1 from B5's, each into its slot), none on the
    looped path and none on ``resample``."""
    fleet = _fleet(backend)
    tracing.reset_counters()
    for call in range(2):
        fleet.resample_many(_stack(50 + call, T))
        c = tracing.counters()
        assert (c["fft.in_place"], c["fft.chunks"]) == (in_place * (call + 1), T * (call + 1))
    fleet.resample(_stack(52, 1)[0])
    assert tracing.counters()["fft.in_place"] == 2 * in_place


R = B * C


@pytest.fixture(scope="module")
def projector():
    plan = mag.plan_magsplit(N, M)
    wh, wcorr = mag.magsplit_weights(plan, "cpu")
    g = torch.Generator().manual_seed(60)
    pool = torch.rand((3, R, N), generator=g) * 2 - 1
    return plan, wh, wcorr, pool


def _call(form, projector, out):
    """``magsplit_projector`` on slots 0 and 1 of the pool, or
    ``magsplit_projector_pool`` on the same slots."""
    plan, wh, wcorr, pool = projector
    if form == "pool":
        return mag.magsplit_projector_pool(pool, 0, 1, wh, wcorr, plan=plan, out=out)
    return mag.magsplit_projector(pool[0], pool[1], wh, wcorr, plan=plan, out=out)


#: an ``out`` each wrapper refuses, built from the pool, and the error;
#: those of their own memory hold 7.0, which must stay
BAD_OUTS = {
    "shape": (lambda pool: torch.full((R, M + 1), 7.0), ValueError),
    "rows": (lambda pool: torch.full((R + 1, M), 7.0), ValueError),
    "dtype": (lambda pool: torch.full((R, M), 7.0, dtype=torch.float64), TypeError),
    "not_a_tensor": (lambda pool: np.full((R, M), 7.0, np.float32), TypeError),
    "non_contiguous": (lambda pool: torch.full((M, R), 7.0).t(), ValueError),
    # views of the pool's memory inside slot 0 (prev) and slot 1 (cur)
    "overlaps_prev": (lambda pool: pool.view(-1)[: R * M].view(R, M), ValueError),
    "overlaps_cur": (lambda pool: pool.view(-1)[R * N : R * N + R * M].view(R, M), ValueError),
}


@pytest.mark.parametrize("bad", sorted(BAD_OUTS))
@pytest.mark.parametrize("form", ["projector", "pool"])
def test_a_bad_out_is_refused_before_anything_is_written(projector, form, bad):
    pool = projector[3]
    make, err = BAD_OUTS[bad]
    pool_before = pool.clone()
    out = make(pool)
    out_before = torch.as_tensor(out).clone()
    with pytest.raises(err, match="out"):
        _call(form, projector, out)
    assert torch.equal(pool, pool_before)
    assert torch.equal(torch.as_tensor(out), out_before)


@pytest.mark.parametrize("form", ["projector", "pool"])
def test_out_on_the_plain_path_comes_back_with_the_same_bits(projector, form):
    want = _call(form, projector, None)
    for out in (torch.full((R, M), float("nan")), torch.empty((2, R, M))[1]):
        got = _call(form, projector, out)
        assert got is out and got.data_ptr() == out.data_ptr()
        assert torch.equal(got, want)


def test_the_fleet_steps_store_into_a_slot_and_refuse_a_bad_one():
    """The magsplit fleet step and the pool step write into an ``out``
    slot of a ``[T, B, C, M]`` and return it; a slot of the wrong shape or
    a strided one is refused."""
    fleet = _fleet("magsplit")
    x = _stack(70, 2)
    want0 = fleet._step(fleet.state, x[0])[1]
    pool_step = tfft.make_fft_fleet_step_pool(fleet.config, B, backend="magsplit", device="cpu")
    want1 = pool_step({"prev_idx": 0}, x.reshape(2, R, N), 1)[1]
    outs = torch.full((2, B, C, M), float("nan"))
    got0 = fleet._step(fleet.state, x[0], out=outs[0])[1]
    got1 = pool_step({"prev_idx": 0}, x.reshape(2, R, N), 1, out=outs[1])[1]
    assert got0.data_ptr() == outs[0].data_ptr() and got1.data_ptr() == outs[1].data_ptr()
    assert torch.equal(outs[0], want0) and torch.equal(outs[1], want1)
    for bad, err in ((torch.zeros((B, C, M + 1)), ValueError),
                     (torch.zeros((B, M, C)).transpose(1, 2), ValueError),
                     ([0.0], TypeError)):
        with pytest.raises(err, match="out"):
            fleet._step(fleet.state, x[0], out=bad)
        with pytest.raises(err, match="out"):
            pool_step({"prev_idx": 0}, x.reshape(2, R, N), 1, out=bad)
