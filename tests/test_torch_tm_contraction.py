"""The tm fleet step's ``contraction=`` and ``mesh=`` keywords
(``resampler_tpu_torch.engine.fir_fleets.make_fir_fleet_step_sync_tm``),
called with the same keywords as the JAX package's step at the size of
``tests/test_pallas.py``'s dma-vs-xla tests: schedule ints equal, samples
within that test's 1e-5.  ``"xla"`` and ``"dma_interpret"`` run the plain
versions on any device, ``"dma"`` refuses the CPU, ``mesh`` raises
``NotImplementedError`` (ROADMAP A11)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from resampler_tpu.engine import fir as jfir
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine import fir_fleets as tfleets
from resampler_tpu_torch.ops import _build
from resampler_tpu_torch.types import Attenuation, reduce_ratio

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ATOL = 1e-5  # tests/test_pallas.py test_tm_dma_contraction_matches_xla
B, C, CHUNK, HORIZON, TAPS = 2, 2, 512, 3, 64
# (in_hz, out_hz, precision): the periodic path in f32 and bf16x4 (the
# JAX package's "dma" forms take f32 whatever the precision), farrow
CASES = [(44100, 48000, "highest"), (44100, 48000, "bf16x4"), (44100, 44101, "highest")]


def _configs(in_hz, out_hz):
    L, M = reduce_ratio(in_hz, out_hz)
    kw = dict(channels=C, taps=TAPS, ratio_num=L, ratio_den=M)
    coeffs = tfir.fir_coefficients(TAPS, Attenuation.Db90, tfir.fir_cutoff(TAPS, Attenuation.Db90, in_hz / out_hz))
    return jfir.FirConfig(**kw), tfir.FirConfig(**kw), coeffs


@pytest.mark.parametrize("contraction", ["xla", "dma_interpret", "auto"])
@pytest.mark.parametrize("case", CASES, ids=["periodic", "periodic-bf16x4", "farrow"])
def test_contraction_keyword_matches_jax(case, contraction):
    in_hz, out_hz, precision = case
    jc, tc, coeffs = _configs(in_hz, out_hz)
    kw = dict(max_chunk=CHUNK, horizon=HORIZON, out_layout="tm", contraction=contraction)
    jprec = {} if precision == "highest" else dict(precision=precision)
    jstep = jax.jit(jfir.make_fir_fleet_step_sync_tm(jc, coeffs, B, **jprec, **kw))
    tstep = tfleets.make_fir_fleet_step_sync_tm(tc, coeffs, B, precision=precision, device="cpu", **kw)
    js = jfir.fir_fleet_init_sync_tm(jc, B, max_chunk=CHUNK, horizon=HORIZON)
    ts = tfleets.fir_fleet_init_sync_tm(tc, B, max_chunk=CHUNK, horizon=HORIZON, device="cpu")
    rng = np.random.default_rng(0)
    before = dict(_build.LAUNCHES)
    produced = 0
    for _ in range(6):
        ch = rng.standard_normal((CHUNK, B * C)).astype(np.float32)
        js, oj, cj, pj = jstep(js, jnp.asarray(ch), jnp.int32(CHUNK))
        ts, ot, ct, pt = tstep(ts, torch.from_numpy(ch), CHUNK)
        assert (ct, pt) == (int(cj), int(pj))
        assert (ts["start"], ts["fill"]) == (int(js["start"]), int(js["fill"]))
        if pt:
            produced += 1
            np.testing.assert_allclose(ot[:pt].numpy(), np.asarray(oj)[:pt], atol=ATOL, rtol=0)
            assert not ot[pt:].any()
    assert produced >= 4
    assert _build.LAUNCHES == before  # the CPU runs plain versions only


@pytest.mark.parametrize("in_hz,out_hz", [(44100, 48000), (44100, 44101)], ids=["periodic", "farrow"])
def test_dma_refuses_the_cpu(in_hz, out_hz):
    _, tc, coeffs = _configs(in_hz, out_hz)
    with pytest.raises(ValueError, match="dma"):
        tfleets.make_fir_fleet_step_sync_tm(tc, coeffs, B, max_chunk=CHUNK, contraction="dma", device="cpu")


def test_mesh_and_unknown_contraction_raise():
    _, tc, coeffs = _configs(44100, 48000)
    with pytest.raises(NotImplementedError, match="A11"):
        tfleets.make_fir_fleet_step_sync_tm(tc, coeffs, B, max_chunk=CHUNK, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="contraction"):
        tfleets.make_fir_fleet_step_sync_tm(tc, coeffs, B, max_chunk=CHUNK, contraction="pallas", device="cpu")
