"""Kernel B7's plain version (``ops/matmul3.py``) against the JAX package's
``matmul3`` (``resampler_tpu/ops/matmul3.py``) run in Pallas interpret
mode, against float64 sums of the same bf16 products, on ragged strided
views (an overlapping ring window, a permuted output) and with a NaN row;
its floor through the FFT engine's 1176 -> 1280 projector; the FFT
engine's CPU backends, which stay float32 ``torch.matmul``; and the card's
layout plan (``plan_matmul3``) and split pass (``split_pass_reference``)
at the views the card sees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from resampler_tpu.ops import matmul3 as jm3
from resampler_tpu_torch.engine import fft as tfft
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine import fir_fleets as tfleets
from resampler_tpu_torch.ops import _build
from resampler_tpu_torch.ops import matmul3 as m3

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS (eight each oversubscribe the machine)
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

#: against the TPU kernel, relative to the output's peak: both take the same
#: exact products; JAX sums them in f32 over K = 384 (measured 1.6e-7 of
#: the peak, 97)
JAX_REL = 1e-6


def floor_db(out, ref) -> float:
    err = np.asarray(out, np.float64) - ref
    return float(-20 * np.log10(np.sqrt((err**2).mean() / (ref**2).mean())))


def f64_products(x, t_hi, t_lo, passes):
    """The products of B7's contract from JAX's split, summed in numpy
    float64 (independent of the port's split and sums)."""
    x_hi, x_lo = (np.asarray(h, np.float64) for h in jm3.split_hi_lo(jnp.asarray(x)))
    th, tl = (np.asarray(t, np.float64) for t in (t_hi, t_lo))
    acc = x_hi @ th + x_lo @ th + x_hi @ tl
    return acc + x_lo @ tl if passes == 4 else acc


def test_plain_matches_jax_interpret():
    """The inputs of ``tests/test_pallas.py``'s matmul3 test: seed 5,
    ``[512, 384] @ [384, 512]``, tiles 256, three passes; the port's
    weight split equals JAX's bit for bit."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((512, 384)).astype(np.float32)
    t = rng.standard_normal((384, 512)).astype(np.float32)
    jt_hi, jt_lo = jm3.split_hi_lo(jnp.asarray(t))
    out_j = np.asarray(jm3.matmul3(jnp.asarray(x), jt_hi, jt_lo, tile_m=256, tile_n=256, interpret=True))
    t_hi, t_lo = m3.split_weight(torch.from_numpy(t))
    for mine, theirs in ((t_hi, jt_hi), (t_lo, jt_lo)):
        np.testing.assert_array_equal(mine.float().numpy(), np.asarray(theirs, np.float32))
    before = dict(_build.LAUNCHES)
    out = m3.matmul3(torch.from_numpy(x), t_hi, t_lo, passes=3).numpy()
    assert _build.LAUNCHES == before  # a CPU tensor runs the plain version
    peak = np.abs(out_j).max()
    assert 50 < peak < 150
    np.testing.assert_allclose(out, out_j, atol=JAX_REL * peak, rtol=0)
    ref = x.astype(np.float64) @ t.astype(np.float64)
    assert floor_db(out, ref) > 90.0 and floor_db(out_j, ref) > 90.0


@pytest.mark.parametrize("passes", [3, 4])
def test_passes_match_f64_products(passes):
    """Three and four passes against float64 sums of the same products:
    the plain version rounds its f64 sum once."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((96, 200)).astype(np.float32)
    t = rng.standard_normal((200, 72)).astype(np.float32)
    t_hi, t_lo = m3.split_weight(torch.from_numpy(t))
    out = m3.matmul3_reference(torch.from_numpy(x), t_hi, t_lo, passes=passes).numpy()
    ref = f64_products(x, t_hi.float().numpy(), t_lo.float().numpy(), passes)
    np.testing.assert_allclose(out, ref, rtol=2.0**-23, atol=1e-12 * np.abs(ref).max())
    # the fourth pass is the lo*lo product, second order
    other = f64_products(x, t_hi.float().numpy(), t_lo.float().numpy(), 7 - passes)
    assert 0 < np.abs(other - ref).max() < 1e-3


def test_ragged_strided_views():
    """An overlapping ring window ``[batch, lanes, rows]`` with contiguous
    lanes (the FIR fleet's), M, N and K off any tile size, a weight window
    with a leading stride and a permuted output view, against the same
    product on dense copies."""
    rng = np.random.default_rng(7)
    ring = torch.from_numpy(rng.standard_normal((300, 7)).astype(np.float32))
    x = ring[5:].as_strided((4, 7, 41), (30 * 7, 1, 7))  # blocks 30 rows apart, 41 rows each
    big = torch.from_numpy(rng.standard_normal((50, 90)).astype(np.float32))
    w_hi, w_lo = m3.split_weight(big)
    t_hi, t_lo = w_hi[3:44, 11:24], w_lo[3:44, 11:24]  # [41, 13], row stride 90
    out = torch.full((4, 13, 7), float("nan")).permute(0, 2, 1)  # [4, 7, 13], lanes contiguous
    got = m3.matmul3(x, t_hi, t_lo, passes=4, out=out)
    assert got is out
    want = m3.matmul3(x.contiguous(), t_hi.contiguous(), t_lo.contiguous(), passes=4)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    ref = f64_products(x.numpy(), t_hi.float().numpy(), t_lo.float().numpy(), 4)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2.0**-23, atol=1e-12 * np.abs(ref).max())
    # 2-D inputs give 2-D outputs
    two = m3.matmul3(x[1], t_hi, t_lo, passes=4)
    torch.testing.assert_close(two, want[1], rtol=0, atol=0)


def test_nan_row_stays_in_its_row():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 33, 50)).astype(np.float32))
    x[1, 7, 20] = float("nan")
    x[0, 3, 0] = float("inf")
    t_hi, t_lo = m3.split_weight(torch.from_numpy(rng.standard_normal((50, 17)).astype(np.float32)))
    out = m3.matmul3(x, t_hi, t_lo, passes=3)
    bad = torch.zeros(2, 33, dtype=torch.bool)
    bad[1, 7] = bad[0, 3] = True
    assert torch.isnan(out[bad]).all()  # Inf's lo is NaN: visibly non-finite
    assert torch.isfinite(out[~bad]).all()


def test_wrapper_checks_its_inputs():
    x = torch.zeros((3, 5, 8))
    t_hi, t_lo = m3.split_weight(torch.ones((8, 6)))
    m3.matmul3(x, t_hi, t_lo, passes=4)
    with pytest.raises(ValueError):
        m3.matmul3(x, t_hi, t_lo, passes=2)
    with pytest.raises(TypeError):
        m3.matmul3(x.double(), t_hi, t_lo)
    with pytest.raises(TypeError):
        m3.matmul3(x, t_hi.float(), t_lo.float())
    with pytest.raises(ValueError):  # K mismatch
        m3.matmul3(x[..., :7], t_hi, t_lo)
    with pytest.raises(ValueError):  # the weight's columns must be contiguous
        m3.matmul3(x, t_hi.t().contiguous().t(), t_lo.t().contiguous().t())
    with pytest.raises(ValueError):  # out of the wrong shape
        m3.matmul3(x, t_hi, t_lo, out=torch.empty((3, 5, 5)))
    with pytest.raises(ValueError):  # out whose elements overlap
        m3.matmul3(x, t_hi, t_lo, out=torch.empty(6).as_strided((3, 5, 6), (0, 0, 1)))


def test_fft_projector_floor_three_passes():
    """Three passes through the FFT engine's dense 1176 -> 1280 projector
    reach >= 99 dB against float64 (the FFT gates' level; a numpy probe of
    the same products measured 108.1 dB)."""
    T = tfft.get_projection_matrix(1176, 1280)
    t_hi, t_lo = m3.split_weight(torch.from_numpy(T))
    x = np.random.default_rng(9).standard_normal((64, 1176)).astype(np.float32)
    out = m3.matmul3_reference(torch.from_numpy(x), t_hi, t_lo, passes=3).numpy()
    db = floor_db(out, x.astype(np.float64) @ T.astype(np.float64))
    assert db >= 99.0, db


@pytest.mark.parametrize("backend", ["matmul", "conv"])
def test_fft_cpu_backends_stay_f32(backend):
    """On the CPU the matmul and conv backends are float32 ``torch.matmul``
    (JAX's ``Precision.HIGH`` is f32 there), ``auto`` resolves to matmul,
    and no kernel launches."""
    cfg = tfft.FftConfig(channels=2, fft_size_input=588, fft_size_output=1280)
    cpu = torch.device("cpu")
    assert tfft._resolve_backend(cfg, "auto", cpu) == "matmul"
    assert tfft._resolve_backend(cfg, backend, cpu) == backend
    step = tfft.make_fft_fleet_step(cfg, 3, backend=backend, device="cpu")
    state = tfft.fft_fleet_init(cfg, 3, backend=backend, device="cpu")
    chunks = torch.from_numpy(np.random.default_rng(10).standard_normal((3, 2, 588)).astype(np.float32))
    before = dict(_build.LAUNCHES)
    _, out = step(state, chunks)
    assert _build.LAUNCHES == before
    T = torch.from_numpy(tfft.get_projection_matrix(588, 1280))
    if backend == "matmul":
        want = torch.matmul(chunks.reshape(6, 588), T)[:, :1280].reshape(3, 2, 1280)
        torch.testing.assert_close(out, want, rtol=0, atol=0)
    else:
        x2 = torch.cat([torch.zeros_like(chunks), chunks], dim=2).reshape(6, 2 * 588)
        w = torch.from_numpy(tfft.input_domain_conv_operator(588, 1280))
        g = w.shape[0] - 1
        lp, mp = w.shape[1], w.shape[2]
        windows = x2.as_strided((6, g, (g + 1) * lp), (2 * 588, lp, 1))
        want = torch.matmul(windows, w.reshape((g + 1) * lp, mp)).reshape(3, 2, 1280)
        torch.testing.assert_close(out, want, rtol=0, atol=0)


def _coeffs(taps, ratio):
    db90 = tfir.Attenuation.Db90
    return tfir.fir_coefficients(taps, db90, tfir.fir_cutoff(taps, db90, ratio))


def _tm_window(i0, L=147, M=160, taps=128, R=8, seed=11):
    """The bf16x4 tm fleet's call at atlas column ``i0``: the overlapping
    ring window ``[K, R, span]`` (lanes contiguous), the padded split atlas's
    weight window and the time-major output view."""
    cfg = tfir.FirConfig(channels=1, taps=taps, ratio_num=L, ratio_den=M)
    span, K = L + taps + 1, -(-cfg.out_capacity // M)
    rng = np.random.default_rng(seed)
    t_hi, t_lo = tfleets._split_atlas_t(tfleets._sync_atlas(cfg, _coeffs(taps, L / M)), "cpu")
    c0 = (i0 * L) // M
    ring = torch.from_numpy(rng.standard_normal(((K - 1) * L + span + 3, R)).astype(np.float32))
    x = ring[3:].as_strided((K, R, span), (L * R, 1, R))
    out = torch.empty((K, M, R)).permute(0, 2, 1)
    return (x, tfleets._atlas_window(t_hi, c0, i0, span, M), tfleets._atlas_window(t_lo, c0, i0, span, M),
            out)


def _conv_windows(R=6, n_in=1176, n_out=1280):
    """The FFT conv backend's call: windows ``[g, R, (g+1) L']`` of ``x2 [R,
    2N]`` at an offset of L' = 147 floats, the output ``[R, g, M']`` as
    ``[g, R, M']``."""
    g = np.gcd(n_in, n_out)
    lp, mp = n_in // g, n_out // g
    x2 = torch.from_numpy(np.random.default_rng(12).standard_normal((R, 2 * n_in)).astype(np.float32))
    w = tfft.input_domain_conv_operator(n_in, n_out).reshape((g + 1) * lp, mp)
    t_hi, t_lo = m3.split_weight(torch.from_numpy(np.ascontiguousarray(w)))
    x = x2.as_strided((g, R, (g + 1) * lp), (lp, 2 * n_in, 1))
    return x, t_hi, t_lo, torch.empty((R, g, mp)).permute(1, 0, 2)


def _ragged():
    rng = np.random.default_rng(13)
    big = torch.from_numpy(rng.standard_normal((3, 77, 301)).astype(np.float32))
    x = big[:, 5:, 7:300]  # [3, 72, 293], row stride 301 floats (1204 bytes)
    x[1, 9, 4] = float("nan")
    x[2, 70, 0] = float("inf")
    t_hi, t_lo = m3.split_weight(torch.from_numpy(rng.standard_normal((293, 97)).astype(np.float32) / 17))
    return x, t_hi, t_lo, None


@pytest.mark.parametrize(
    "case,i0",
    [("projector", None), ("tm-window", 0), ("tm-window", 77), ("tm-window", 159), ("conv", None),
     ("ragged", None), ("unaligned-window", 77)],
)
def test_layout_plan(case, i0):
    """The card's layout for the four views B7 sees: ``Kp``, the scratch,
    the maps' extents and 16-byte strides, whether the weight needs a copy
    (a row stride or a base off 16 bytes: the ragged weight's 194-byte rows,
    an atlas window at an odd column taken from a single, unshifted copy)
    and the per-batch coordinates."""
    if case == "projector":
        T = tfft.get_projection_matrix(1176, 1280)
        t_hi, t_lo = m3.split_weight(torch.from_numpy(T))
        x = torch.empty((16384, 1176))  # never touched: the plan reads shapes only
        want = dict(Kp=1176, weight_copy=False, ldt=2560, grid=(16, 128, 1))
    elif case == "tm-window":
        x, t_hi, t_lo, _ = _tm_window(i0)
        want = dict(Kp=280, weight_copy=False, ldt=320, grid=(1, 1, 28))
    elif case == "unaligned-window":
        x = _tm_window(i0)[0]
        # a window at column 5 of one unshifted copy: its base lies 10 bytes past 16
        t_hi, t_lo = (torch.zeros((276, 328), dtype=torch.bfloat16)[:, 5:165] for _ in range(2))
        want = dict(Kp=280, weight_copy=True, ldt=160, grid=(1, 1, 28))
    elif case == "conv":
        x, t_hi, t_lo, _ = _conv_windows()
        want = dict(Kp=1328, weight_copy=False, ldt=160, grid=(1, 1, 8))
    else:
        x, t_hi, t_lo, _ = _ragged()
        want = dict(Kp=296, weight_copy=True, ldt=104, grid=(1, 1, 3))
    x3 = x if x.ndim == 3 else x.unsqueeze(0)
    batch, M, K = x3.shape
    N = t_hi.shape[1]
    plan = m3.plan_matmul3(x3, t_hi, t_lo)
    assert {k: getattr(plan, k) for k in want} == want
    assert plan.scratch_shape == (batch, M, plan.Kp) and plan.Kp % 8 == 0 and 0 <= plan.Kp - K < 8
    assert plan.a_dims == (plan.Kp, M, batch) and plan.b_dims == (N, K)
    assert all(s % 16 == 0 for s in plan.a_strides + plan.b_strides)
    assert plan.a_strides == (2 * plan.Kp, 2 * plan.Kp * M) and plan.b_strides == (2 * plan.ldt,)
    assert plan.a_box == (64, 128, 1) and plan.b_box == (32, 64)
    if not plan.weight_copy:
        for t in (t_hi, t_lo):
            assert t.data_ptr() % 16 == 0 and plan.ldt == t.stride(0)
    b, n_k = batch - 1, -(-K // 64)
    at = m3.tile_coords(plan, b, plan.grid[1] - 1, plan.grid[0] - 1, n_k - 1)
    assert at["a"] == ((n_k - 1) * 64, (plan.grid[1] - 1) * 128, b)
    cols = [c for c, _ in at["b"]]
    assert cols == [(plan.grid[0] - 1) * 160 + 32 * j for j in range(5)]
    assert {k for _, k in at["b"]} == {(n_k - 1) * 64}
    # the last tiles reach past the data: TMA fills zeros there
    assert at["a"][0] + 64 >= plan.Kp and cols[-1] + 32 >= plan.b_dims[0]


@pytest.mark.parametrize("case", ["ragged", "tm-window", "conv"])
@pytest.mark.parametrize("passes", [3, 4])
def test_split_scratch_gives_reference_bit_for_bit(case, passes):
    """The split pass's plain version: ``split_hi_lo`` into compact K-major
    bf16 ``[batch, M, Kp]`` with zeros past K.  The GEMM's products over
    that scratch, the weight's rows zero past K and summed in float64, are
    ``matmul3_reference`` bit for bit (NaN and Inf rows included)."""
    x, t_hi, t_lo, _ = {"ragged": _ragged, "tm-window": lambda: _tm_window(77), "conv": _conv_windows}[case]()
    K = x.shape[-1]
    Kp = -(-K // 8) * 8
    x_hi, x_lo = m3.split_pass_reference(x, Kp)
    assert x_hi.dtype == x_lo.dtype == torch.bfloat16 and tuple(x_hi.shape) == tuple(x.shape[:-1]) + (Kp,)
    assert not x_hi[..., K:].any() and not x_lo[..., K:].any()
    hi, lo = m3.split_hi_lo(x)
    fin = torch.isfinite(x)
    assert torch.equal(x_hi[..., :K].float()[fin], hi[fin]) and torch.equal(x_lo[..., :K].float()[fin], lo[fin])
    th, tl = (torch.nn.functional.pad(t.double(), (0, 0, 0, Kp - K)) for t in (t_hi, t_lo))
    ah, al = x_hi.double(), x_lo.double()
    acc = ah @ th + al @ th + ah @ tl
    if passes == 4:
        acc += al @ tl
    got = acc.to(torch.float32)
    ref = m3.matmul3_reference(x, t_hi, t_lo, passes=passes)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(got[~torch.isnan(ref)], ref[~torch.isnan(ref)])
    if case == "ragged":
        assert torch.isnan(ref[1, 9]).all() and torch.isnan(ref[2, 70]).all() and int(torch.isnan(ref).sum()) == 2 * 97


def test_tm_atlas_windows_start_on_16_bytes():
    """The bf16x4 tm fleet's split atlas: 8 copies shifted by 0-7 columns,
    rows padded to a multiple of 8 elements (2M = 294 at 48 -> 44.1 kHz), so
    that every window starts on 16 bytes and needs no copy; each window
    holds the split atlas's values."""
    L, M, taps = 160, 147, 64
    cfg = tfir.FirConfig(channels=1, taps=taps, ratio_num=L, ratio_den=M)
    a2 = tfleets._sync_atlas(cfg, _coeffs(taps, L / M))
    t_hi, t_lo = tfleets._split_atlas_t(a2, "cpu")
    assert a2.shape[0] == 2 * M and t_hi.shape == (8, a2.shape[1], 296) and t_hi.stride(1) == 296
    want_hi, want_lo = m3.split_weight(torch.from_numpy(a2.T))
    span, x = L + taps + 1, torch.empty((2, 4, L + taps + 1))
    for i0 in range(M):
        c0 = (i0 * L) // M
        win = [tfleets._atlas_window(t, c0, i0, span, M) for t in (t_hi, t_lo)]
        assert torch.equal(win[0], want_hi[c0 : c0 + span, i0 : i0 + M])
        assert torch.equal(win[1], want_lo[c0 : c0 + span, i0 : i0 + M])
        assert m3.plan_matmul3(x, *win).weight_copy is False
