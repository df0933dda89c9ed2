"""The port's FFT design layer equals the JAX package's: the copied
planner, the filter spectrum and projection operators, the magsplit plan
search and weights, and the bf16 rounding the port writes with integer
operations (against ``ml_dtypes`` and JAX's ``split_hi_lo``)."""

import dataclasses
import itertools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from resampler_tpu import types as jtypes
from resampler_tpu.dsp import planner as jplanner
from resampler_tpu.engine import fft as jfft
from resampler_tpu.ops import fft_magsplit_kernel as jmag
from resampler_tpu.ops.matmul3 import split_hi_lo as jax_split_hi_lo
from resampler_tpu_torch import types as ttypes
from resampler_tpu_torch.dsp import planner as tplanner
from resampler_tpu_torch.engine import fft as tfft
from resampler_tpu_torch.ops import fft_magsplit_kernel as tmag
from resampler_tpu_torch.ops import matmul3 as tm3

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

#: the bench pair, the stopband pair, a 2x-output pair (each both ways)
#: and two pairs without a band plan
PAIRS = [
    (1176, 1280), (1280, 1176), (588, 1280), (1280, 588),
    (1176, 2560), (2560, 1176), (640, 882), (882, 640), (512, 1536), (1536, 512),
]


def test_planner_copy_matches_jax():
    assert tplanner.TARGET_INPUT_SAMPLES == jplanner.TARGET_INPUT_SAMPLES
    for a, b in itertools.product(list(jtypes.SampleRate), repeat=2):
        jc = jplanner.plan_conversion(a, b)
        tc = tplanner.plan_conversion(ttypes.SampleRate(a.value), ttypes.SampleRate(b.value))
        assert dataclasses.astuple(tc) == dataclasses.astuple(jc), (a, b)
        assert dataclasses.astuple(tc.scale_for_throughput()) == (
            dataclasses.astuple(jc.scale_for_throughput())
        )


@pytest.mark.parametrize("pair", PAIRS, ids=[f"{a}-{b}" for a, b in PAIRS])
def test_design_and_plan_match_jax(pair):
    n_in, n_out = pair
    np.testing.assert_array_equal(
        tfft.fft_filter_spectrum(n_in, n_out), jfft.fft_filter_spectrum(n_in, n_out)
    )
    np.testing.assert_array_equal(
        tfft.spectral_projection_matrix(n_in, n_out),
        jfft.spectral_projection_matrix(n_in, n_out),
    )
    np.testing.assert_array_equal(
        tfft.input_domain_conv_operator(n_in, n_out),
        jfft.input_domain_conv_operator(n_in, n_out),
    )
    assert tfft.conv_backend_viable(n_in, n_out) == jfft.conv_backend_viable(n_in, n_out)
    jp, tp = jmag.plan_magsplit(n_in, n_out), tmag.plan_magsplit(n_in, n_out)
    if jp is None:
        assert tp is None
        return
    assert dataclasses.astuple(tp) == dataclasses.astuple(jp)
    assert (tp.s, tp.cols, tp.rows, tp.wc) == (jp.s, jp.cols, jp.rows, jp.wc)
    T2 = jmag._t2_f64(n_in, n_out)
    np.testing.assert_array_equal(tmag._t2_f64(n_in, n_out), T2)
    args = (n_in, n_out, tp.bps, tp.b0, tp.w_p, T2)
    assert tmag.simulate_magsplit_floor(*args) == jmag.simulate_magsplit_floor(*args)


def test_bench_pair_plan():
    """The full-width FFT path's geometry: 44.1 -> 48 kHz, N 1176, M 1280."""
    p = tmag.plan_magsplit(1176, 1280)
    assert (p.g, p.lp, p.mp, p.bps, p.b0, p.w_p, p.floor_db) == (8, 147, 160, 2, 2, 5, 107.4)
    assert (p.s, p.rows, p.wc, p.cols) == (4, 1470, 882, 320)
    assert tfft.get_projection_matrix(1176, 1280) is tfft.get_projection_matrix(1176, 1280)


@pytest.mark.parametrize("pair", [(1176, 1280), (588, 1280), (1280, 1176)])
def test_magsplit_weights_bit_equal(pair):
    tp = tmag.plan_magsplit(*pair)
    wh, wcorr = tmag.magsplit_weights(tp, "cpu")
    assert wh.dtype == wcorr.dtype == torch.bfloat16
    assert tmag.magsplit_weights(tp, "cpu") == (wh, wcorr)  # cached per (plan, device)
    jwh, jwcorr = jmag.magsplit_weights(jmag.plan_magsplit(*pair))
    for t, j in ((wh, jwh), (wcorr, jwcorr)):
        assert tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), np.asarray(j).view(np.int16))


def _special_values(rng) -> np.ndarray:
    """Random values over the whole exponent range, exact round-to-even
    ties (upper half even and odd), subnormals, +-0, +-Inf, NaNs with
    high and low payloads, and finites that round up to Inf."""
    bits = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    ties = (rng.integers(0, 1 << 16, 256, dtype=np.uint64).astype(np.uint32) << 16) | 0x8000
    subnormal = rng.integers(1, 1 << 23, 256, dtype=np.uint64).astype(np.uint32)
    special = np.array(
        [0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001,
         0xFF800001, 0x7FBFFFFF, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF,
         0x00008000, 0x00018000, 0x80008000, 0x3F808000, 0x3F818000, 0x3F807FFF],
        np.uint32,
    )
    u = np.concatenate([bits, ties, ties | 0x80000000, subnormal, subnormal | 0x80000000, special])
    return u.view(np.float32)


def test_bf16_rounding_matches_ml_dtypes():
    a = _special_values(np.random.default_rng(0))
    with np.errstate(invalid="ignore"):
        want = a.astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(tm3.bf16_bits_np(a), want.view(np.uint16))
    with np.errstate(invalid="ignore"):
        want32 = want.astype(np.float32)
    np.testing.assert_array_equal(tm3.bf16_round_np(a).view(np.uint32), want32.view(np.uint32))
    # float64 input is rounded to float32 first, as the JAX package does
    d = np.random.default_rng(1).standard_normal(1000) * 1e-3
    np.testing.assert_array_equal(
        tm3.bf16_round_np(d), d.astype(np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)
    )


def test_split_hi_lo_matches_jax_bit_for_bit():
    a = _special_values(np.random.default_rng(2))
    jhi, jlo = (np.asarray(x).view(np.uint16) for x in jax_split_hi_lo(jnp.asarray(a)))
    hi, lo = tm3.split_hi_lo(torch.from_numpy(a))
    assert hi.dtype == lo.dtype == torch.float32
    for got, want in ((hi, jhi), (lo, jlo)):
        bits = got.view(torch.int32).numpy().view(np.uint32)
        assert not (bits & 0xFFFF).any()  # exact bfloat16 values
        np.testing.assert_array_equal((bits >> 16).astype(np.uint16), want)
