"""Kernels B9 and B8 (the fused steps of the vmapped and slide FIR fleets):
their plain PyTorch versions against the JAX package's Pallas kernels in
interpret mode (``make_fir_fleet_step_pallas``,
``make_fir_fleet_step_sync_pallas``) on the same seeded inputs: counts,
positions and buffers exact, outputs within the JAX suite's 1e-6
(tests/test_pallas.py).  The kernels themselves run only on the card
(tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from resampler_tpu.engine import fir as jfir
from resampler_tpu.ops.fir_kernel import make_fir_fleet_step_pallas
from resampler_tpu.ops.fir_sync_kernel import make_fir_fleet_step_sync_pallas
from resampler_tpu.types import Attenuation, reduce_ratio
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.ops import _build
from resampler_tpu_torch.ops import fir_kernel as b9
from resampler_tpu_torch.ops import fir_sync_kernel as b8

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ATOL = 1e-6  # tests/test_pallas.py


def _configs(in_hz, out_hz, taps, C):
    L, M = reduce_ratio(in_hz, out_hz)
    coeffs = jfir.fir_coefficients(taps, Attenuation.Db90, jfir.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz))
    return (jfir.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M),
            tfir.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M), coeffs)


@pytest.mark.parametrize("in_hz,out_hz,taps", [(44100, 48000, 64), (48000, 44100, 32)])
def test_b9_plain_matches_jax_pallas(in_hz, out_hz, taps):
    """Ragged per-stream valid counts (0 among them) with NaN junk past
    them, so the streams' schedules diverge."""
    B, C, n_in = 3, 2, 512
    jc, tc, coeffs = _configs(in_hz, out_hz, taps, C)
    pal = make_fir_fleet_step_pallas(jc, coeffs, n_in, interpret=True)
    plan = b9.FleetStepPlan(tc, coeffs)
    state = jax.vmap(lambda _: jfir.fir_init(jc))(jnp.arange(B))
    bufs, avail, pos = state["buffer"], state["available_frames"], state["pos_num"]
    tbuf = torch.zeros(tuple(bufs.shape))
    tavail, tpos = np.zeros(B, np.int64), np.zeros(B, np.int64)
    rng = np.random.default_rng(0)
    launches = dict(_build.LAUNCHES)
    produced = set()
    for it in range(4):
        chunks = rng.standard_normal((B, n_in, C)).astype(np.float32)
        nv = rng.integers(0, n_in + 1, B)
        nv[it % B] = 0
        chunks[np.arange(n_in)[None, :] >= nv[:, None]] = np.nan
        budget = np.full(B, jc.out_capacity)
        budget[1] = 200  # a budget below the producible count defers output
        bufs, out_p, avail, pos, cons_p, prod_p = pal(
            bufs, jnp.asarray(chunks), avail, pos, jnp.asarray(nv, jnp.int32),
            jnp.asarray(budget, jnp.int32),
        )
        tbuf, out_t, tavail, tpos, cons_t, prod_t = b9.fir_fleet_step(
            plan, tbuf, torch.from_numpy(chunks), tavail, tpos, nv, budget
        )
        for want, got in ((cons_p, cons_t), (prod_p, prod_t), (avail, tavail), (pos, tpos)):
            np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_p), atol=ATOL)
        np.testing.assert_array_equal(tbuf.numpy(), np.asarray(bufs))
        produced.update(prod_t.tolist())
    assert 0 in produced and len(produced) > 3
    assert _build.LAUNCHES == launches  # CPU tensors run the plain version


def test_b8_plain_matches_jax_pallas():
    """The shared-schedule step against the JAX sync kernel (which takes
    channel-major chunks), fed channel-major and, the same data
    transposed, frames-major."""
    B, C, n_in = 4, 2, 512
    jc, tc, coeffs = _configs(44100, 48000, 64, C)
    pal = make_fir_fleet_step_sync_pallas(jc, coeffs, B, n_in, interpret=True)
    plan = b9.FleetStepPlan(tc, coeffs)
    js = jfir.fir_fleet_init_sync(jc, B)
    ports = {cm: [torch.zeros(tuple(js["buffer"].shape)), 0, 0, b9.SpareBuffer()]
             for cm in (True, False)}
    rng = np.random.default_rng(1)
    for _ in range(5):
        chunks = rng.standard_normal((B, C, n_in)).astype(np.float32)
        nv = int(rng.integers(0, n_in + 1))
        chunks[:, :, nv:] = np.nan
        js, oj, cj, pj = pal(js, jnp.asarray(chunks), jnp.int32(nv))
        for cm, (tbuf, tavail, tpos, spare) in ports.items():
            feed = chunks if cm else np.ascontiguousarray(chunks.transpose(0, 2, 1))
            tbuf, ot, tavail, tpos, ct, pt = b8.fir_fleet_step_sync(
                plan, tbuf, torch.from_numpy(feed), tavail, tpos, nv, channel_major=cm,
                out_buffers=spare.swap(tbuf),
            )
            ports[cm][:3] = tbuf, tavail, tpos
            assert (ct, pt) == (int(cj), int(pj))
            assert (tavail, tpos) == (int(js["available_frames"]), int(js["pos_num"]))
            np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL)
            np.testing.assert_array_equal(tbuf.numpy(), np.asarray(js["buffer"]))


def test_fleet_step_wrappers_check_their_inputs():
    _, tc, coeffs = _configs(44100, 48000, 32, 2)
    plan = b9.FleetStepPlan(tc, coeffs)
    buf = torch.zeros((2, 2, tc.buffer_alloc))
    chunks = torch.zeros((2, 64, 2))
    zeros, full = np.zeros(2, np.int64), np.full(2, tc.out_capacity)
    with pytest.raises(ValueError, match="overlaps"):
        b9.fir_fleet_step(plan, buf, chunks, zeros, zeros, zeros, full, out_buffers=buf)
    with pytest.raises(ValueError, match="n_valid"):
        b9.fir_fleet_step(plan, buf, chunks, zeros, zeros, np.array([1, -1]), full)
    with pytest.raises(ValueError, match="one value per stream"):
        b9.fir_fleet_step(plan, buf, chunks, zeros, zeros, np.zeros(3, np.int64), full)
    with pytest.raises(ValueError, match="chunks"):
        b9.fir_fleet_step(plan, buf, torch.zeros((2, 64, 3)), zeros, zeros, zeros, full)
    with pytest.raises(TypeError):
        b9.fir_fleet_step(plan, buf.double(), chunks, zeros, zeros, zeros, full)
    with pytest.raises(TypeError, match="shared schedule"):
        b8.fir_fleet_step_sync(plan, buf, chunks, zeros, 0, 64)
    # a state whose position runs past its buffered frames reads nothing
    # out of range: it emits nothing
    new, out, avail, pos, c, p = b9.fir_fleet_step(
        plan, buf, chunks, zeros, np.array([0, 10**6]), np.full(2, 64), full
    )
    assert p[1] == 0 and not out[1].any() and c.tolist() == [64, 64]
    spare = b9.SpareBuffer()
    first = spare.swap(buf)
    assert first is not buf and not first.any()
    assert spare.swap(first) is buf
