"""The port's async wrapper (``BatchedResamplerFir(sync_variant="async_tm")``),
its serving runtime ``StreamingFleet`` (on the vmapped, time-major and
async fleets) and staging pool, and the async state's conversion, against
the JAX package on the same seeded inputs: ints and states exactly equal,
samples within the JAX suite's 2e-5."""

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import resampler_tpu as jrt
import resampler_tpu_torch as trt
from resampler_tpu.runtime import StreamingFleet as JaxStreamingFleet
from resampler_tpu.utils.checkpoint import load_state, save_state
from resampler_tpu.utils.native import HostStreamPool as JaxPool
from resampler_tpu_torch.utils import tracing
from resampler_tpu_torch.utils.native import HostStreamPool
from resampler_tpu_torch.utils.state import state_from_numpy, state_to_numpy

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ATOL = 2e-5  # tests/test_async_fleet.py
CHUNK = 256
M_441, M_WIDE = 44101, 600013


def _fleets(in_hz, out_hz, phases, B=3, C=2, **kw):
    kw = dict(synchronized=True, sync_variant="async_tm", max_chunk=CHUNK, horizon=3,
              initial_positions=np.asarray(phases, object), **kw)
    args = (B, C, in_hz, out_hz)
    j = jrt.BatchedResamplerFir(*args, jrt.Latency.Sample32, jrt.Attenuation.Db90, **kw)
    t = trt.BatchedResamplerFir(*args, trt.Latency.Sample32, trt.Attenuation.Db90,
                                device="cpu", **kw)
    return j, t


def _assert_states_equal(jstate, tstate):
    js, ts = jax.tree.map(np.asarray, jstate), state_to_numpy(tstate)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert js[k].dtype == ts[k].dtype, k
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def _compare(jres, tres):
    (oj, cj, pj, kj), (ot, ct, pt, kt) = jres, tres
    np.testing.assert_array_equal(ct, np.asarray(cj))
    np.testing.assert_array_equal(pt, np.asarray(pj))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
    assert abs(float(kt) - float(kj)) <= ATOL


@pytest.mark.parametrize(
    "in_hz,out_hz,phases,slews",
    [
        # a per-stream slew within the skew, a scalar one, then the
        # history clamp (every stream back to its oldest buffered frame)
        (44100, 44101, [0, 11111, 44100 // 2], ([0.25, -0.0, 0.125], 0.75, -40.0)),
        (600011, M_WIDE, [0, M_WIDE // 2, 17], ([0.25, 0.0, -0.125], -0.125, -40.0)),
    ],
    ids=["narrow", "wide"],
)
def test_async_wrapper_matches_jax(in_hz, out_hz, phases, slews):
    """``resample`` over ragged feeds, per-stream and scalar ``slew``, the
    history clamp, the skew refusal, and ``resample_many``."""
    j, t = _fleets(in_hz, out_hz, phases)
    _assert_states_equal(j.state, t.state)
    rng = np.random.default_rng(9)
    for i, nv in enumerate([CHUNK, 100, CHUNK, 0, CHUNK, 37, CHUNK, CHUNK, CHUNK]):
        chunks = rng.standard_normal((3, CHUNK, 2)).astype(np.float32)
        n_valid = np.full(3, nv)
        n_valid[0] += 3  # the cadence takes the fleet minimum
        _compare(j.resample(chunks, n_valid), t.resample(chunks, n_valid))
        _assert_states_equal(j.state, t.state)
        if i in (2, 4, 6):
            s = slews[(i - 2) // 2]
            got, want = t.slew(s), j.slew(np.asarray(s, np.float64))
            assert got.shape == (3,) and got.dtype == np.float64
            np.testing.assert_array_equal(got, np.asarray(want))
            _assert_states_equal(j.state, t.state)
    with pytest.raises(ValueError, match="spread"):
        t.slew(np.asarray([10.0, -10.0, 0.0]))
    with pytest.raises(ValueError, match="spread"):
        j.slew(np.asarray([10.0, -10.0, 0.0]))
    _assert_states_equal(j.state, t.state)  # a refused slew moves nothing
    chunks4 = rng.standard_normal((4, 3, CHUNK, 2)).astype(np.float32)
    nv4 = np.asarray([CHUNK, 50, 0, CHUNK])
    _compare(j.resample_many(chunks4, nv4), t.resample_many(chunks4, nv4))
    _assert_states_equal(j.state, t.state)


def test_async_wrapper_options():
    args = (2, 2, 44100, 44101)
    with pytest.raises(ValueError, match="initial_positions"):
        trt.BatchedResamplerFir(*args, synchronized=True, initial_positions=[0, 1], device="cpu")
    with pytest.raises(ValueError, match="path"):
        trt.BatchedResamplerFir(*args, synchronized=True, sync_variant="async_tm",
                                path="lerp", device="cpu")
    with pytest.raises(ValueError, match="skew invariant"):
        trt.BatchedResamplerFir(*args, synchronized=True, sync_variant="async_tm",
                                initial_positions=[0, M_441], device="cpu")
    s = trt.StreamingFleet(2, 2, 44100, 48000, device="cpu")  # the vmapped fleet
    s.push(0, np.ones(2 * 700, np.float32))
    y0, y1 = s.step()
    assert y0.size > 0 and y1.size == 0 and s.pending(1) == 0
    with pytest.raises(ValueError):
        trt.StreamingFleet(2, 2, 44100, 48000, synchronized="yes", device="cpu")


def _stream(fleet_cls, kw, pushes, n_steps, B, C):
    fleet = fleet_cls(B, C, 44100, 44101, chunk_frames=CHUNK, **kw)
    outs = [[] for _ in range(B)]
    for k in range(n_steps):
        for b in range(B):
            if pushes[k][b].size:
                assert fleet.push(b, pushes[k][b]) == pushes[k][b].size
        for b, o in enumerate(fleet.step()):
            outs[b].append(o)
    return [np.concatenate(o) for o in outs], [fleet.pending(b) for b in range(B)]


@pytest.mark.parametrize("mode", [False, True, "async"])
def test_streaming_fleet_matches_jax(mode):
    """Ragged per-stream pushes through the staging pool and the carry."""
    B, C = 3, 2
    rng = np.random.default_rng(2)
    pushes = [[(rng.standard_normal(C * int(rng.integers(0, 2 * CHUNK))) * 0.5).astype(np.float32)
               for _ in range(B)] for _ in range(8)]
    kw = dict(synchronized=mode)
    if mode == "async":
        kw["initial_positions"] = np.asarray([0, 9999, 44100])
    jaxo, jpend = _stream(JaxStreamingFleet, dict(kw, latency=jrt.Latency.Sample32,
                                                  attenuation=jrt.Attenuation.Db90), pushes, 8, B, C)
    tor, tpend = _stream(trt.StreamingFleet, dict(kw, latency=trt.Latency.Sample32,
                                                  attenuation=trt.Attenuation.Db90, device="cpu"),
                         pushes, 8, B, C)
    assert tpend == jpend
    for a, b in zip(jaxo, tor):
        assert a.shape == b.shape and a.size > 1000
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)


def _lockstep(args, kw, feeds, rtol=0.0):
    """A JAX and a port ``StreamingFleet`` fed the same pushes, step for
    step; ``feeds`` yields ``(pushes {stream: interleaved}, steps)``."""
    j = JaxStreamingFleet(*args, jrt.Latency.Sample16, jrt.Attenuation.Db90, **kw)
    t = trt.StreamingFleet(*args, trt.Latency.Sample16, trt.Attenuation.Db90, device="cpu", **kw)
    outs = [[] for _ in range(args[0])]
    for pushes, steps in feeds:
        for b, x in pushes.items():
            assert j.push(b, x) == t.push(b, x) == x.size
        for _ in range(steps):
            for b, (yj, yt) in enumerate(zip(j.step(), t.step())):
                assert yj.shape == yt.shape
                np.testing.assert_allclose(yt, yj, atol=ATOL, rtol=rtol)
                outs[b].append(yt)
            assert [t.pending(b) for b in range(args[0])] == [j.pending(b) for b in range(args[0])]
    return [np.concatenate(o) for o in outs]


@pytest.mark.parametrize("case", ["ragged-lengths", "incremental", "backpressure"])
def test_vmapped_streaming_fleet_matches_jax(case):
    """The default runtime (``synchronized=False``, the vmapped fleet)
    against the JAX runtime in the scenarios of tests/test_runtime.py:
    ragged stream lengths drained, incremental pushes, and a push past
    what the fleet's buffer takes in one step."""
    rng = np.random.default_rng(12)
    if case == "ragged-lengths":
        args, kw = (6, 2, 48000, 44100), dict(chunk_frames=512)
        lengths = [100, 4096, 7777, 0, 1, 9000]
        feeds = [({b: (rng.standard_normal(2 * n) * 0.5).astype(np.float32)
                   for b, n in enumerate(lengths) if n}, 24)]
        outs = _lockstep(args, kw, feeds)
        assert outs[3].size == 0 and outs[5].size > 8000
    elif case == "incremental":
        args, kw = (3, 1, 44100, 48000), dict(chunk_frames=256)
        feeds = [({0: rng.standard_normal(int(rng.integers(1, 700))).astype(np.float32),
                   2: rng.standard_normal(int(rng.integers(0, 300))).astype(np.float32)}, 1)
                 for _ in range(16)]
        outs = _lockstep(args, kw, feeds + [({}, 3)])
        assert outs[0].size > outs[2].size > 0 and outs[1].size == 0
    else:
        args, kw = (1, 1, 48000, 48000), dict(chunk_frames=4096, queue_capacity_frames=1 << 15)
        # a ramp up to 12288: f32 sums in another order differ by ulps
        # of ~1e-3 there, so this case holds a relative 2e-6
        outs = _lockstep(args, kw, [({0: np.arange(3 * 4096, dtype=np.float32)}, 6)], rtol=2e-6)
        assert outs[0].size > 3 * 4096 - 64  # all but the filter's tail


def test_host_pool_matches_jax():
    B, C = 3, 2
    ours, theirs = HostStreamPool(B, C, capacity_frames=300), JaxPool(B, C, capacity_frames=300)
    rng = np.random.default_rng(4)
    for _ in range(6):
        for b in range(B):
            x = rng.standard_normal(int(rng.integers(0, 333))).astype(np.float32)
            assert ours.push(b, x) == theirs.push(b, x)  # whole frames, up to capacity
            assert ours.pending(b) == theirs.pending(b)
        n = int(rng.integers(1, 200))
        (bo, vo), (bt, vt) = ours.fill(n), theirs.fill(n)
        np.testing.assert_array_equal(vo, vt)
        np.testing.assert_array_equal(bo, bt)


def test_async_state_round_trip(tmp_path):
    """A JAX async fleet state (and its ``.npz`` checkpoint) loaded into
    the port steps like JAX's; the port's numpy form is JAX's."""
    for in_hz, out_hz, phases in ((44100, 44101, [0, 11111, 30000]),
                                  (600011, M_WIDE, [0, M_WIDE // 2, 17])):
        j, t = _fleets(in_hz, out_hz, phases)
        rng = np.random.default_rng(6)
        for _ in range(4):
            j.resample(rng.standard_normal((3, CHUNK, 2)).astype(np.float32))
        save_state(tmp_path / "fleet.npz", j.state)
        for state_np in (jax.tree.map(np.asarray, j.state),
                         load_state(tmp_path / "fleet.npz", to_device=False)):
            t.state = state_from_numpy(state_np, device="cpu")
            _assert_states_equal(j.state, t.state)
        for _ in range(3):
            chunks = rng.standard_normal((3, CHUNK, 2)).astype(np.float32)
            _compare(j.resample(chunks), t.resample(chunks))
            _assert_states_equal(j.state, t.state)


def _stage_plain(carry, carry_len, drained, pool_valid, n):
    """``StreamingFleet``'s staging as whole-batch numpy regathers over
    every stream: ``(batch, n_valid, rest, rest_len)``."""
    pool_valid = np.asarray(pool_valid, np.int64)
    cap = carry.shape[1]
    combined = np.concatenate([carry, drained], axis=1)
    lens = carry_len + pool_valid
    take = np.minimum(lens, n)
    pos = np.arange(cap + n)[None, :]
    src = np.where(pos < carry_len[:, None], pos, cap + pos - carry_len[:, None])
    np.clip(src, 0, cap + n - 1, out=src)
    packed = np.take_along_axis(combined, src[:, :, None], axis=1)
    lane = np.arange(n)[None, :, None]
    batch = np.where(lane < take[:, None, None], packed[:, :n], 0.0)
    rest_idx = take[:, None] + np.arange(cap)[None, :]
    np.clip(rest_idx, 0, cap + n - 1, out=rest_idx)
    rest = np.take_along_axis(packed, rest_idx[:, :, None], axis=1)
    return batch, take.astype(np.int32), rest, lens - take


def _recarry_plain(batch, n_valid, consumed, rest, rest_len, n):
    """The carry rebuilt from the whole batch: ``(carry, carry_len)``."""
    tail_len = n_valid - consumed
    new_len = tail_len + rest_len
    cap = max(rest.shape[1], int(new_len.max(initial=0)))
    pos = np.arange(cap)[None, :]
    both = np.concatenate([batch, rest], axis=1)
    src = np.where(pos < tail_len[:, None], consumed[:, None] + pos, n + pos - tail_len[:, None])
    np.clip(src, 0, both.shape[1] - 1, out=src)
    carry = np.take_along_axis(both, src[:, :, None], axis=1)
    carry[pos >= new_len[:, None]] = 0.0
    return carry, new_len


#: per case: the carry lengths before the first step (from ``(rng, B, n)``)
#: and the frames each step's fleet takes (from ``(rng, n_valid)``)
STAGING = {
    "none-carrying": (lambda rng, B, n: np.zeros(B, np.int64), lambda rng, nv: nv),
    "all-carrying": (lambda rng, B, n: rng.integers(1, n, B),
                     lambda rng, nv: np.maximum(nv - rng.integers(1, 64, nv.size), 0)),
    "random-mix": (lambda rng, B, n: rng.integers(0, 2, B) * rng.integers(1, n, B),
                   lambda rng, nv: np.where(rng.random(nv.size) < 0.3, nv // 2, nv)),
    "rest-past-chunk": (lambda rng, B, n: rng.integers(n, 2 * n, B),
                        lambda rng, nv: nv // 4),
    "capacity-growth": (lambda rng, B, n: np.zeros(B, np.int64),
                        lambda rng, nv: np.where(np.arange(nv.size) % 2, 0, nv)),
    "consumed-below-valid": (lambda rng, B, n: np.zeros(B, np.int64),
                             lambda rng, nv: rng.integers(0, nv + 1)),
}


@pytest.mark.parametrize("case", sorted(STAGING))
def test_staging_matches_the_whole_batch_regather(case):
    """``_stage`` and ``_recarry``, which touch only the streams that carry,
    against the whole-batch regathers over every stream, step after step:
    the batch bit for bit, the valid counts, the carry rows up to their
    lengths and the lengths; with no stream carrying the batch is the
    drained array itself."""
    B, C, n = 16, 2, 64
    fleet = trt.StreamingFleet(B, C, 44100, 48000, chunk_frames=n, device="cpu")
    rng = np.random.default_rng(sorted(STAGING).index(case))
    first_len, take = STAGING[case]
    carry_len = np.asarray(first_len(rng, B, n), np.int64)
    carry = np.zeros((B, 2 * n, C), np.float32)
    for s in range(B):
        carry[s, : carry_len[s]] = rng.standard_normal((carry_len[s], C))
    fleet._carry[:], fleet._carry_len = carry, carry_len.copy()
    cap0 = carry.shape[1]
    for _ in range(6):
        pool_valid = rng.integers(0, n + 1, B).astype(np.int32)
        pool_valid[rng.integers(B)] = n  # a full chunk each step
        drained = np.zeros((B, n, C), np.float32)
        for s in range(B):
            drained[s, : pool_valid[s]] = rng.standard_normal((pool_valid[s], C))
        want_batch, want_valid, rest, rest_len = _stage_plain(carry, carry_len, drained.copy(),
                                                              pool_valid, n)
        staged = tracing.counters()["runtime.staged_streams"]
        batch, n_valid, got_rest = fleet._stage(drained, pool_valid)
        assert tracing.counters()["runtime.staged_streams"] - staged == np.count_nonzero(carry_len)
        if not carry_len.any():
            assert batch is drained and not got_rest
        assert batch.dtype == want_batch.dtype and n_valid.dtype == want_valid.dtype
        np.testing.assert_array_equal(batch.view(np.uint32), want_batch.view(np.uint32))
        np.testing.assert_array_equal(n_valid, want_valid)
        consumed = np.asarray(take(rng, n_valid.astype(np.int64)), np.int64)
        carry, carry_len = _recarry_plain(want_batch, want_valid, consumed, rest, rest_len, n)
        fleet._recarry(batch, n_valid, consumed, got_rest)
        np.testing.assert_array_equal(fleet._carry_len, carry_len)
        assert fleet._carry_len.dtype == np.int64
        for s in range(B):
            np.testing.assert_array_equal(fleet._carry[s, : carry_len[s]].view(np.uint32),
                                          carry[s, : carry_len[s]].view(np.uint32))
    if case == "capacity-growth":
        assert carry_len.max() > cap0 and fleet._carry.shape[1] >= carry_len.max()
    if case == "none-carrying":
        assert not carry_len.any()
    else:
        assert carry_len.any()
