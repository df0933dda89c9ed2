"""The port's coprime-ratio design layer equals the JAX package's: Farrow
block sizes, the Chebyshev fit, the SVD table basis, the fleet's Farrow
plan (the JAX XLA-form plan, ``widen=0``) for both bases, config
geometry, and the path rules.  Everything here is exact equality."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from resampler_tpu import types as jtypes
from resampler_tpu.engine import fir as jfir
from resampler_tpu.engine import fir_fleets as jfleets
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine import fir_fleets as tfleets
from resampler_tpu_torch.types import Attenuation

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

# near-unity, mild downsampling, the three packed (q < 8) pairs, wide u32
PAIRS = [
    (44100, 44101), (48000, 44101), (367500, 1601),
    (48000, 1601), (48000, 3001), (600011, 600013),
]
TAPS = [32, 128]


def _configs(pair, taps, channels=2):
    L, M = jtypes.reduce_ratio(*pair)
    return (
        jfir.FirConfig(channels=channels, taps=taps, ratio_num=L, ratio_den=M),
        tfir.FirConfig(channels=channels, taps=taps, ratio_num=L, ratio_den=M),
    )


def _coeffs(pair, taps):
    cut = tfir.fir_cutoff(taps, Attenuation.Db90, pair[0] / pair[1])
    return tfir.fir_coefficients(taps, Attenuation.Db90, cut)


def test_farrow_constants_match_jax():
    for name in ("FARROW_DEGREE", "FARROW_BLOCK", "FARROW_BLOCK_MAX"):
        assert getattr(tfir, name) == getattr(jfir, name), name


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_farrow_design_matches_jax(pair):
    for taps in TAPS:
        jc, tc = _configs(pair, taps)
        L, M = tc.ratio_num, tc.ratio_den
        assert tfir.farrow_block_size(L, M) == jfir.farrow_block_size(L, M)
        for prop in ("wide", "read_slack", "buffer_alloc", "out_capacity"):
            assert getattr(tc, prop) == getattr(jc, prop), (pair, taps, prop)
        assert tfir.resolve_convolve_path(tc) == jfir.resolve_convolve_path(jc) == "farrow"
        coeffs = _coeffs(pair, taps)
        (ta, tr), (ja, jr) = tfir.farrow_matrix(coeffs), jfir.farrow_matrix(coeffs)
        np.testing.assert_array_equal(ta, ja)
        assert tr == jr
        for t_arr, j_arr in zip(tfir._table_svd_basis(coeffs), jfir._table_svd_basis(coeffs)):
            np.testing.assert_array_equal(t_arr, j_arr)
        for basis in ("cheb", "lerp"):
            tp = tfleets._farrow_tm_plan(tc, coeffs, basis=basis)
            jp = jfleets._farrow_tm_plan(jc, coeffs, widen=0, basis=basis)
            assert sorted(tp) == sorted(jp)
            for key in jp:
                if jp[key] is None:
                    assert tp[key] is None, key
                else:
                    np.testing.assert_array_equal(tp[key], jp[key], err_msg=key)
                    assert np.asarray(tp[key]).dtype == np.asarray(jp[key]).dtype, key
            assert tp["region_rows"] <= tc.read_slack


def test_bench_plan_geometry():
    """The fleet plans chip_smoke.py runs at full width (128 taps)."""
    _, tc = _configs((44100, 44101), 128)
    p = tfleets._farrow_tm_plan(tc, _coeffs((44100, 44101), 128))
    assert (p["q"], p["K"], p["d1"], p["n_jl"], p["w_blk"], p["region_rows"]) == (
        64, 63, 8, 65, 192, 4159,
    )
    _, tc = _configs((367500, 1601), 128)
    p = tfleets._farrow_tm_plan(tc, _coeffs((367500, 1601), 128))
    assert (p["q"], p["K"], p["w_blk"]) == (1, 20, 129)
    _, tc = _configs((600011, 600013), 128)
    assert tc.wide and tfleets._farrow_tm_plan(tc, _coeffs((600011, 600013), 128))["q"] == 64


def test_path_rules_mirror_jax():
    _, narrow = _configs((44100, 44101), 32)
    _, wide = _configs((600011, 600013), 32)
    _, periodic = _configs((44100, 48000), 32)
    assert tfir.resolve_path(narrow) == "farrow"
    assert tfir.resolve_path(narrow, "lerp") == "lerp"
    assert tfir.resolve_path(periodic, "farrow") == "farrow"
    assert tfir.resolve_path(wide) == "farrow"
    for path in ("lerp", "periodic"):
        with pytest.raises(ValueError, match="farrow"):
            tfir.resolve_path(wide, path)
    with pytest.raises(NotImplementedError, match="A9"):
        tfir.resolve_path(narrow, "gather")
    with pytest.raises(ValueError):
        tfir.resolve_path(narrow, "spline")


def test_combine_basis_matches_jax_formulas():
    """The host-side Chebyshev values and lerped U rows against the JAX
    per-stream step's own f32 formulas, over every residue of a small M
    and the wide u32 residues near 2^32."""
    coeffs = _coeffs((44100, 44101), 32)
    U, _ = tfir._table_svd_basis(coeffs)
    M = 997
    rem = np.arange(M, dtype=np.int64)
    frac = rem.astype(np.float32) / np.float32(M)
    u = 2.0 * frac - 1.0
    ts = [np.ones_like(u), u]
    for _ in range(tfir.FARROW_DEGREE - 1):
        ts.append(2.0 * u * ts[-1] - ts[-2])
    np.testing.assert_array_equal(tfir.combine_basis(rem, M), np.stack(ts, -1))
    pf = rem * tfir.PHASES
    p1 = pf // M
    p2 = np.minimum(p1 + 1, tfir.PHASES - 1)
    fp = (pf - p1 * M).astype(np.float32) / np.float32(M)
    np.testing.assert_array_equal(
        tfir.combine_basis(rem, M, U), U[p1] + fp[:, None] * (U[p2] - U[p1])
    )
    # wide residues: u32 sums that wrap, carries detected by comparison
    Mw = (1 << 32) - 5
    s = np.asarray([0, 1, Mw - 1, 1 << 31], np.int64)
    wrap, rem = tfir.lane_residues(s, Mw, (0, Mw - 2))
    np.testing.assert_array_equal(wrap, [0, 0, 1, 1])
    np.testing.assert_array_equal(rem, [Mw - 2, Mw - 1, Mw - 3, (Mw - 2 + (1 << 31)) - Mw])
