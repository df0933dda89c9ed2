"""Kernel B6's tiling (``ops/fir_async_kernel.py`` ``F32TilePlan``) on the
CPU: every output's position ``j[n] + off + c`` (each frame skew ``off`` in
``[0, skew]``, both wrap bits; the starved fall-through reads ``off = 0``)
lies in its tile's computed positions and every row those positions read
is staged; a torch-ops emulation of the kernel's loop (the per-call stage,
passes of 32 positions, each thread's 8 positions over the sliding window
of ``x``, the outputs found through ``pfirst`` and taken by exactly one
thread, the Chebyshev combine; in the per-output form each output's own
window among the staged rows) matches the plain version summed in f64
within 1e-9 and the f32 plain version within the kernels' 1e-5, at the
card's async cases (a)-(g) at small R and at 16, 32 and 64 taps, in both
forms; the form that ``L/M`` picks; the plan's checks of its inputs.  The
CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine import fir_fleets as tfleets
from resampler_tpu_torch.ops import fir_async_kernel as b6
from resampler_tpu_torch.types import Attenuation, reduce_ratio

# several test workers share the machine's cores: one thread each for
# torch and for numpy's BLAS
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

_U32 = (1 << 32) - 1
# chip_smoke.py's ASYNC_CASES at small R, plus narrower filters: (in_hz,
# out_hz, taps, R, skew, starved, the form L/M picks)
CASES = {
    "a": (44100, 44101, 128, 6, 1, False, "positions"),
    "a-taps16": (44100, 44101, 16, 6, 1, False, "positions"),
    "a-taps32": (44100, 44101, 32, 5, 1, False, "positions"),
    "a-taps64": (44100, 44101, 64, 4, 1, False, "positions"),
    "b-skew2": (22050, 96000, 128, 6, 2, False, "positions"),
    "c-48000-44101": (48000, 44101, 128, 6, 1, False, "positions"),
    "d-wide": (4_000_000_000, 4_000_000_001, 128, 6, 1, False, "positions"),
    "e-367500-1601": (367500, 1601, 128, 6, 1, False, "outputs"),
    "f-ragged-R5": (44100, 44101, 128, 5, 1, False, "positions"),
    "g-starved": (44100, 44101, 128, 6, 1, True, "positions"),
}
FORMS = ("positions", "outputs")


def _plan(in_hz, out_hz, taps, skew, chunk=2048):
    """The plan of chip_smoke.py's ``async_plan``: the async fleet's
    ``max_out`` bound of a 2048-frame chunk."""
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=1, taps=taps, ratio_num=L, ratio_den=M)
    coeffs = tfir.fir_coefficients(taps, Attenuation.Db90, tfir.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz))
    out_cap = min(cfg.out_capacity, (chunk * M) // L + 128)
    plan = b6.async_combine_plan(
        A=tfir.farrow_matrix(coeffs)[0], L=L, M=M, out_cap=out_cap, skew_periods=skew,
        clamp_j=cfg.input_capacity + 2 if cfg.wide else None,
    )
    return cfg, plan, (L, M)


def _residues(plan, res, n):
    """Wrap bits ``c [n, R]`` and Chebyshev arguments ``u`` (f64 of the f32
    value) of outputs ``n`` for lanes with residue words ``res``."""
    t = (res[None, :] + torch.from_numpy(plan.s)[n][:, None]) & _U32
    wrap = (t < res[None, :]) | (t >= plan.M)
    rem = torch.where(wrap, (t - plan.M) & _U32, t)
    u = (2.0 * (rem.to(torch.float32) / torch.tensor(np.float32(plan.M))) - 1.0).double()
    return wrap.long(), u


def _cheb(u, y):
    """``sum_d T_d(u) y[..., d]`` in the kernel's order (f64)."""
    acc = y[..., 0]
    t_prev, t_cur = torch.ones_like(u), u
    for d in range(1, 8):
        acc = t_cur * y[..., d] + acc
        t_prev, t_cur = t_cur, 2.0 * u * t_cur - t_prev
    return acc


def _emulate(buffer, base0, n_out, lanes, plan, form):
    """B6's loop in torch ops, f64 sums.  Per computed tile: the rows the
    call stages; in the positions form each pass's 4 warps x 8 positions,
    every thread's 64 sums over the sliding window (``xw`` = rows ``pb +
    t0 + m``, ``xn`` the next 8), the candidates ``[n_a, n_b)`` of each
    lane from ``pfirst``, each output taken by the one thread whose
    positions hold its ``q``; in the per-output form each output's window
    from ``win[n] + off + c``.  Rows past the computed tiles stay zero."""
    tp = plan.f32_tiles(form)
    R = buffer.shape[1]
    A = torch.from_numpy(plan.A).double()  # [8, taps]
    out = torch.zeros((plan.out_cap, R), dtype=torch.float64)
    res, base_rel = lanes[0], lanes[1]
    off = torch.where((base_rel >= 1) & (base_rel <= plan.skew), base_rel, 0)
    j = torch.from_numpy(plan.j)
    kk, ii = torch.meshgrid(torch.arange(8), torch.arange(8), indexing="ij")
    for tt in range(tp.emit[n_out]):
        n_lo, n_hi = (int(v) for v in tp.tiles[tt])
        n_end = min(n_hi, n_out)
        n = torch.arange(n_lo, n_end)
        c, u = _residues(plan, res, n)
        if form == "positions":
            p0 = int(tp.rowmap[tt, 0])
            passes = -(-(int(plan.j[n_end - 1]) + plan.skew + 2 - p0) // b6.F32_PASS)
            rows = passes * b6.F32_PASS + plan.taps
            assert rows <= tp.rows_pad
            stage = buffer[base0 + torch.from_numpy(tp.rowmap[tt, :rows].astype(np.int64))].double()
            pbs = torch.arange(passes * b6.F32_WARPS) * b6.F32_KP  # each (pass, warp)'s first position
            acc = torch.zeros((pbs.numel(), 8, 8, R), dtype=torch.float64)  # [block, i, d, R]
            for t0 in range(0, plan.taps, 8):
                win = stage[pbs[:, None] + t0 + torch.arange(16)]  # xw | xn: [block, 16, R]
                acc += torch.einsum("dk,bkir->bidr", A[:, t0 : t0 + 8], win[:, kk + ii])
            pfirst = torch.from_numpy(tp.aux.astype(np.int64))
            pa = p0 + pbs  # [block]
            lo_idx = (pa[:, None] - off[None, :] - 1).clamp(0, tp.aux.size - 1)
            hi_idx = (pa[:, None] + 8 - off[None, :]).clamp(0, tp.aux.size - 1)
            n_a = pfirst[lo_idx].clamp(min=n_lo)  # [block, R]
            n_b = pfirst[hi_idx].clamp(max=n_end)
            q = j[n][None, :, None] + off[None, None, :] + c[None] - pa[:, None, None]  # [block, n, R]
            take = ((n[None, :, None] >= n_a[:, None]) & (n[None, :, None] < n_b[:, None])
                    & (q >= 0) & (q < 8))
            assert torch.equal(take.sum(0), torch.ones((n.numel(), R), dtype=torch.long)), "one thread per output"
            b = take.long().argmax(0)  # [n, R]
            y = acc[b, q.gather(0, b[None])[0], :, torch.arange(R)[None, :]]  # [n, R, 8]
        else:
            win = torch.from_numpy(tp.aux.astype(np.int64))
            rows = int(win[n_end - 1]) + tp.window
            stage = buffer[base0 + torch.from_numpy(tp.rowmap[tt, :rows].astype(np.int64))].double()
            start = win[n][:, None] + off[None, :] + c  # [n, R]
            x = stage[start[..., None] + torch.arange(plan.taps), torch.arange(R)[None, :, None]]  # [n, R, taps]
            y = torch.einsum("nrt,dt->nrd", x, A)
        out[n_lo:n_end] = _cheb(u, y)
    return out


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", list(CASES))
def test_every_position_is_computed_from_staged_rows(case, form):
    in_hz, out_hz, taps, _, skew, _, picked = CASES[case]
    _, plan, (L, M) = _plan(in_hz, out_hz, taps, skew)
    assert plan.f32_tiles().form == picked == ("positions" if L <= b6.POSITIONS_MAX_RATIO * M else "outputs")
    tp = plan.f32_tiles(form)
    lo, hi = tp.tiles[:, 0].astype(np.int64), tp.tiles[:, 1].astype(np.int64)
    assert lo[0] == 0 and hi[-1] == plan.out_cap and np.array_equal(lo[1:], hi[:-1]) and np.all(hi > lo)
    assert tp.rowmap.shape == (tp.n_tiles, tp.rows_pad) and tp.smem_bytes <= b6.SMEM_MAX
    assert tp.rowmap.max() < plan.reach and tp.rowmap.min() >= 0
    # every position an output may take: j[n] + off + c, off in [0, skew]
    # (the starved fall-through is off = 0), c in {0, 1}
    shifts = np.arange(skew + 2)
    for t in range(tp.n_tiles):
        n = np.arange(lo[t], hi[t])
        if form == "positions":
            p0 = int(tp.rowmap[t, 0])
            assert p0 == plan.j[lo[t]]
            for n_out in (int(lo[t]) + 1, int(hi[t])):  # a call that stops in the tile, then the whole tile
                ne = n[n < n_out]
                passes = -(-(int(plan.j[ne[-1]]) + skew + 2 - p0) // b6.F32_PASS)
                assert passes * b6.F32_PASS + taps <= tp.rows_pad
                q = plan.j[ne][:, None] + shifts - p0
                assert q.min() >= 0 and q.max() < passes * b6.F32_PASS
                # the staged rows those positions read are the ring's
                # p0 + i, up to the last row an output of the tile reads
                need = int(q.max()) + taps
                np.testing.assert_array_equal(tp.rowmap[t, :need], p0 + np.arange(need))
            assert np.all(tp.rowmap[t, need:] == p0 + need - 1)
            # pfirst: the first output whose j reaches each position
            np.testing.assert_array_equal(tp.aux, np.searchsorted(plan.j, np.arange(tp.aux.size)))
            assert tp.aux.size >= plan.j[-1] + skew + 2 + b6.F32_KP
        else:
            for k in n:
                start = tp.aux[k] + shifts
                got = tp.rowmap[t][start[:, None] + np.arange(taps)]
                np.testing.assert_array_equal(got, plan.j[k] + shifts[:, None] + np.arange(taps), err_msg=f"{k}")
    assert tp.emit[0] == 0 and tp.z0[0] == 0
    assert tp.emit[plan.out_cap] == tp.n_tiles and tp.z0[plan.out_cap] == plan.out_cap
    for n_out in (1, plan.out_cap // 2, plan.out_cap - 1):
        e = tp.emit[n_out]
        assert lo[e - 1] < n_out <= hi[e - 1] == tp.z0[n_out]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", list(CASES))
def test_emulation_matches_plain(case, form):
    in_hz, out_hz, taps, R, skew, starved, _ = CASES[case]
    cfg, plan, (L, M) = _plan(in_hz, out_hz, taps, skew)
    ring = tfleets._ring_rows(cfg, 2048, 16)
    rng = np.random.default_rng(len(case) + taps + len(form))
    buf = torch.from_numpy(rng.standard_normal((ring, R), dtype=np.float32))
    res = rng.integers(0, M, R)
    base_rel = rng.integers(0, skew + 1 + (6 if starved else 0), R)
    if starved:
        base_rel[0] = skew + 3  # a frame skew past skew_periods reads offset 0
    lanes = torch.from_numpy(np.stack([res, base_rel]))
    n_main = min(plan.out_cap, (2048 * M) // L)
    top = ring - plan.reach
    for base0 in (0, 3, top):
        for n_out in sorted({0, 1, n_main, plan.out_cap}):
            got = _emulate(buf, base0, n_out, lanes, plan, form)
            exact = b6._reference(buf, base0, n_out, lanes, plan, torch.float64)
            ref = b6.async_combine_reference(buf, base0, n_out, lanes, plan)
            assert (got - exact).abs().max().item() <= 1e-9, (base0, n_out)
            assert (got - ref.double()).abs().max().item() <= 1e-5, (base0, n_out)
            assert not got[n_out:].any()


def test_non_finite_sample_reaches_exactly_the_outputs_whose_window_holds_it():
    """A NaN in one lane's ring and an Inf in another's: the outputs whose
    window (rows ``j[n] + off + c + t``) holds one are non-finite, every
    other output is finite and within 1e-5 of the plain version wherever
    that is finite (the plain version's banded einsum also spreads a
    non-finite sample over its band's other positions: 0 x NaN)."""
    _, plan, _ = _plan(44100, 44101, 32, 1)
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(rng.standard_normal((plan.reach + 4, 4), dtype=np.float32))
    buf[100, 1] = float("nan")
    buf[57, 2] = float("inf")
    res = rng.integers(0, plan.M, 4)
    lanes = torch.from_numpy(np.stack([res, np.array([0, 1, 0, 1])]))
    n_out = plan.out_cap
    c, _ = _residues(plan, lanes[0], torch.arange(n_out))
    first = torch.from_numpy(plan.j)[:, None] + lanes[1][None, :] + c  # [n, R]: each window's first row
    bad = ~torch.isfinite(buf)
    holds = torch.stack([bad[first[:, r, None] + torch.arange(plan.taps), r].any(1) for r in range(4)], 1)
    assert holds[:, 1].any() and holds[:, 2].any() and not holds[:, [0, 3]].any()
    ref = b6.async_combine_reference(buf, 0, n_out, lanes, plan).double()
    assert not torch.isfinite(ref[holds]).any()
    for form in FORMS:
        got = _emulate(buf, 0, n_out, lanes, plan, form)
        assert torch.equal(~torch.isfinite(got), holds)
        fin = torch.isfinite(ref)
        assert (got[fin] - ref[fin]).abs().max().item() <= 1e-5


@pytest.mark.parametrize(
    "j,taps,skew,L,M,form,match",
    [
        (np.arange(8), 12, 1, 1, 1, None, "multiple of 8"),
        (np.arange(8), 4, 1, 1, 1, None, "multiple of 8"),
        (np.arange(8), 128, 0, 1, 1, None, "skew"),
        (np.arange(8), 128, 1, 0, 1, None, "L >= 1"),
        (np.arange(8), 128, 200, 1, 1, "positions", "budget"),
        (np.arange(8), 128, 300, 3, 1, "outputs", "exceeds"),
        (np.arange(8), 128, 1, 1, 1, "band", "form"),
        (np.array([0, 2, 1]), 32, 1, 1, 1, None, "non-decreasing"),
        (np.array([-1, 0]), 32, 1, 1, 1, None, "non-decreasing"),
        (np.zeros(0, np.int64), 32, 1, 1, 1, None, "non-empty"),
    ],
    ids=["taps12", "taps4", "skew0", "L0", "positions-skew", "outputs-window", "form", "decreasing", "negative",
         "empty"],
)
def test_tile_plan_checks_its_inputs(j, taps, skew, L, M, form, match):
    with pytest.raises(ValueError, match=match):
        b6.F32TilePlan(j, taps, skew, L, M, form)


def test_form_follows_the_ratio():
    """Positions up to L/M = POSITIONS_MAX_RATIO, per output above; the
    plan's L is the ratio's, j[1] M + s[1]."""
    j = np.arange(64)
    assert b6.F32TilePlan(j, 32, 1, 3, 2).form == "positions"
    assert b6.F32TilePlan(j * 2, 32, 1, 2, 1).form == "outputs"
    assert b6.F32TilePlan(j, 32, 1, 2, 1, "positions").form == "positions"
    plan = b6.async_combine_plan(A=np.ones((8, 32), np.float32), L=147, M=640, out_cap=50, skew_periods=2)
    assert plan.L == 147 and plan.f32_tiles().form == "positions"
    heavy = b6.async_combine_plan(A=np.ones((8, 32), np.float32), L=7350, M=32, out_cap=9, skew_periods=1)
    assert heavy.f32_tiles().form == "outputs"
