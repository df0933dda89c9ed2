"""The PyTorch port's host-side design layer equals the JAX package's:
config geometry, coefficient tables, banded atlases (incl. the grouped
small-M form), group factors and the copied type / window modules."""

import dataclasses

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from resampler_tpu import types as jtypes
from resampler_tpu.dsp import window as jwindow
from resampler_tpu.engine import fir as jfir
from resampler_tpu.engine import fir_fleets as jfleets
from resampler_tpu_torch import types as ttypes
from resampler_tpu_torch.dsp import window as twindow
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine import fir_fleets as tfleets

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

# the four bench pairs (bench.py main + bench_fir)
PAIRS = [(44100, 48000), (48000, 44100), (22050, 48000), (48000, 96000)]
TAPS = [16, 64, 128]


def _configs(pair, taps, channels=2):
    L, M = jtypes.reduce_ratio(*pair)
    assert (L, M) == ttypes.reduce_ratio(*pair)
    return (
        jfir.FirConfig(channels=channels, taps=taps, ratio_num=L, ratio_den=M),
        tfir.FirConfig(channels=channels, taps=taps, ratio_num=L, ratio_den=M),
    )


@pytest.mark.parametrize("pair", PAIRS)
def test_fir_config_geometry_matches_jax(pair):
    for taps in TAPS:
        jc, tc = _configs(pair, taps)
        for prop in ("wide", "read_slack", "buffer_alloc", "out_capacity", "delay"):
            assert getattr(tc, prop) == getattr(jc, prop), (pair, taps, prop)
        assert tfir.resolve_convolve_path(tc) == jfir.resolve_convolve_path(jc)
        L, M = tc.ratio_num, tc.ratio_den
        assert tfir._use_im2col(L, taps) == jfir._use_im2col(L, taps)
        assert tfir._periodic_group_factor(L, M) == jfir._periodic_group_factor(L, M)
        jfleet_ring = jfleets.fir_fleet_init_sync_tm(
            jc, 1, max_chunk=512, horizon=3
        )["buffer"].shape[0]
        assert tfleets._ring_rows(tc, 512, 3) == jfleet_ring


@pytest.mark.parametrize("pair", PAIRS)
def test_coefficients_and_atlas_match_jax(pair):
    for taps in (16, 64):
        for att in ("Db60", "Db90", "Db120"):
            ja, ta = getattr(jtypes.Attenuation, att), getattr(ttypes.Attenuation, att)
            ratio = pair[0] / pair[1]
            cut = tfir.fir_cutoff(taps, ta, ratio)
            assert cut == jfir.fir_cutoff(taps, ja, ratio)
            table = tfir.fir_coefficients(taps, ta, cut)
            np.testing.assert_array_equal(table, jfir.fir_coefficients(taps, ja, cut))
            assert table is tfir.fir_coefficients(taps, ta, cut)  # process cache
        jc, tc = _configs(pair, taps)
        np.testing.assert_array_equal(
            tfleets._sync_atlas(tc, table), jfleets._sync_atlas(jc, table)
        )
        g = tfir._periodic_group_factor(tc.ratio_num, tc.ratio_den)
        if g > 1:  # the grouped (gL, gM) atlas the tm fleet contracts against
            rep = dict(ratio_num=tc.ratio_num * g, ratio_den=tc.ratio_den * g)
            np.testing.assert_array_equal(
                tfleets._sync_atlas(dataclasses.replace(tc, **rep), table),
                jfleets._sync_atlas(dataclasses.replace(jc, **rep), table),
            )


def test_grouped_48_to_96_factor():
    assert tfir._periodic_group_factor(1, 2) == 64  # Mg = 128 atlas rows


def test_main_path_geometry():
    """The headline fleet's geometry: stereo 44.1 -> 48 kHz, taps 128
    (Latency.Sample64), 1024 streams, max_chunk 4096, horizon 16."""
    _, tc = _configs((44100, 48000), ttypes.Latency.Sample64.taps)
    L, M = tc.ratio_num, tc.ratio_den
    assert (L, M) == (147, 160)
    assert tfir.resolve_convolve_path(tc) == "periodic"
    assert tfir._periodic_group_factor(L, M) == 1
    assert tc.out_capacity == 4321
    assert tc.read_slack == 4608
    assert -(-tc.out_capacity // M) == 28  # K period blocks
    assert L + tc.taps + 1 == 276  # span
    assert tfleets._ring_rows(tc, 4096, 16) == 74240


def test_main_path_geometry_taps64():
    """The same pair at taps 64 (Latency.Sample32), the second shape
    chip_smoke.py runs the kernel at: span 212 over the same 28 period
    blocks and ring."""
    _, tc = _configs((44100, 48000), 64)
    assert tc.out_capacity == 4391
    assert tc.ratio_num + tc.taps + 1 == 212
    assert -(-tc.out_capacity // tc.ratio_den) == 28
    assert tfleets._ring_rows(tc, 4096, 16) == 74240


def test_constants_match_jax():
    for name in (
        "PHASES", "INPUT_CAPACITY", "MAX_CHUNK", "MIN_READ_SLACK",
        "MAX_REDUCED_RATE", "OUT_CAP_MAX", "MAX_PERIOD", "MAX_PERIOD_L",
        "MAX_ATLAS_BYTES",
    ):
        assert getattr(tfir, name) == getattr(jfir, name), name


def test_copied_types_match_jax():
    for enum_name in ("SampleRate", "SampleRateFamily", "Latency", "Attenuation"):
        je, te = getattr(jtypes, enum_name), getattr(ttypes, enum_name)
        assert [(m.name, m.value) for m in je] == [(m.name, m.value) for m in te]
    for a in ttypes.Attenuation:
        assert a.kaiser_beta == jtypes.Attenuation(a.value).kaiser_beta
    for la in ttypes.Latency:
        assert la.taps == jtypes.Latency(la.value).taps
    for r in ttypes.SampleRate:
        assert r.family_multiplier == jtypes.SampleRate(r.value).family_multiplier
    for pair in PAIRS + [(44100, 44101), (1, 600013)]:
        assert ttypes.reduce_ratio(*pair) == jtypes.reduce_ratio(*pair)
    with pytest.raises(ValueError):
        ttypes.reduce_ratio(0, 48000)
    assert issubclass(ttypes.InvalidInputBufferSize, ttypes.ResampleError)


def test_copied_window_matches_jax():
    for wt in ("PERIODIC", "SYMMETRIC"):
        np.testing.assert_array_equal(
            twindow.make_kaiser_window(257, 10.0, getattr(twindow.WindowType, wt)),
            jwindow.make_kaiser_window(257, 10.0, getattr(jwindow.WindowType, wt)),
        )
    for taps in TAPS:
        assert twindow.calculate_cutoff_kaiser(taps, 13.0) == (
            jwindow.calculate_cutoff_kaiser(taps, 13.0)
        )
    np.testing.assert_array_equal(
        twindow.make_sincs_for_kaiser(32, 64, 0.9, 10.0, twindow.WindowType.SYMMETRIC),
        jwindow.make_sincs_for_kaiser(32, 64, 0.9, 10.0, jwindow.WindowType.SYMMETRIC),
    )
