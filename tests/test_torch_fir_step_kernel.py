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


# --------------------------------------------------------------------------
# the band form's tile plan (ops/fir_kernel.py BandTile), emulated in torch
# ops: the kernel's index map, held against the plain version on the CPU
# --------------------------------------------------------------------------


def _new_columns(buffers, view, rows, x, valid_end):
    """``new(row, x)`` read through the copy-in select, as the band kernel
    stages it: ``old[row, x + to_copy]`` for ``x < valid_end - to_copy``,
    then chunk frame ``x - (valid_end - to_copy)``, 0 outside ``[0,
    valid_end)``.  ``x [P, ...]`` int64 for the ``P`` padded rows; junk
    frames are selected out, never multiplied."""
    B, C, alloc = buffers.shape
    n = view.shape[1]
    P = x.shape[0]
    flat = x.reshape(P, -1)
    lim = (valid_end - rows["to_copy"])[:, None]
    old = torch.zeros((P, alloc), dtype=buffers.dtype)
    old[: B * C] = buffers.reshape(B * C, alloc)
    chunk = torch.zeros((P, max(n, 1)), dtype=view.dtype)
    chunk[: B * C, :n] = view.transpose(1, 2).reshape(B * C, n)
    from_old = old.gather(1, (flat + rows["to_copy"][:, None]).clamp(0, alloc - 1))
    from_chunk = chunk.gather(1, (flat - lim).clamp(0, max(n, 1) - 1))
    v = torch.where(flat < lim, from_old, from_chunk)
    return torch.where((flat >= 0) & (flat < valid_end), v, 0.0).reshape(x.shape)


def emulate_band_step(plan, buffers, view, sched):
    """One step of the band form through ``plan.tile``, every block of
    the kernel at once, in torch ops with f64 sums: the copy-in, then for
    every q tile and row group each row's staged window, each warp's band
    from the start-phase table, the contraction and the masked epilogue.
    ``sched`` holds ``[S]`` arrays (``S`` 1: one shared schedule).
    Returns ``(next buffers, out [B, out_cap, C], writes [B, out_cap,
    C])``, ``writes`` counting the stores to each output."""
    cfg, tile = plan.config, plan.tile
    L, M, out_cap = cfg.ratio_num, cfg.ratio_den, cfg.out_capacity
    valid_end = cfg.input_capacity
    B, C, _ = buffers.shape
    n_rows = B * C
    P = -(-n_rows // b9.TILE_ROWS) * b9.TILE_ROWS
    shared = len(sched["r"]) == 1
    live = np.arange(P) < n_rows
    stream = np.minimum(np.arange(P) // C, B - 1)
    s = {k: np.where(live, np.broadcast_to(np.asarray(v, np.int64), (B,))[stream], 0)
         for k, v in sched.items() if k in ("to_copy", "n_out", "base", "r")}
    i0 = s["r"] * plan.l_inv % M
    rows = dict(to_copy=torch.from_numpy(s["to_copy"]), x_q0=s["base"] - (i0 * L - s["r"]) // M)

    # the copy-in launch
    nxt = torch.zeros_like(buffers)
    cols = torch.arange(valid_end).expand(P, valid_end)
    nxt[:, :, :valid_end] = _new_columns(buffers, view, rows, cols, valid_end)[:n_rows].reshape(
        B, C, valid_end)

    # the band launch: q tiles x row groups (every group at once)
    R, G, T = tile.R, tile.warps, tile.q_tile
    q_first = (i0[0] if shared else 0) + T * np.arange(tile.q_tiles(shared))
    d_first = tile.d(q_first)
    win_cols = rows["x_q0"][:, None, None] + d_first[None, :, None] + np.arange(tile.win)
    xs = _new_columns(buffers, view, rows, torch.from_numpy(win_cols), valid_end).double()
    q0 = q_first[:, None] + R * np.arange(G)  # [tiles, warps]
    wst = tile.d(q0) - d_first[:, None]
    band = tile.bands[q0 % M][..., :R].astype(np.float64)  # [tiles, warps, band_w, R]
    idx = torch.from_numpy(wst[:, :, None] + np.arange(tile.band_w))  # [tiles, warps, band_w]
    xw = xs.gather(2, idx.reshape(1, len(q_first), -1).expand(P, -1, -1))
    acc = torch.einsum("ptgs,tgsr->ptgr", xw.reshape(P, len(q_first), G, tile.band_w),
                       torch.from_numpy(band))
    i = torch.from_numpy(q0[None, :, :, None] + np.arange(R) - i0[:, None, None, None])
    n_out = torch.from_numpy(s["n_out"])[:, None, None, None]
    stored = (i >= 0) & (i < out_cap) & torch.from_numpy(live)[:, None, None, None]
    vals = torch.where(i < n_out, acc, 0.0).float()
    p_idx = torch.arange(P)[:, None, None, None].expand_as(i)
    out = torch.zeros((P, out_cap))
    writes = torch.zeros((P, out_cap), dtype=torch.int64)
    out.index_put_((p_idx[stored], i[stored]), vals[stored])
    writes.index_put_((p_idx[stored], i[stored]), torch.ones_like(i[stored]), accumulate=True)
    out, writes = (t[:n_rows].reshape(B, C, out_cap).transpose(1, 2) for t in (out, writes))
    return nxt, out, writes


def _band_case(in_hz, out_hz, taps, B, C, n, ragged, seed):
    """A state and feeds as chip_smoke.py's phase 16 makes them: steady
    (taps - 1 frames left, one position) or ragged (frames, positions and
    valid counts 0, 1 or n per stream, stream 0 empty), NaN junk past the
    valid counts; the second feed has junk past the last stream's count
    (B8's shared one)."""
    _, tc, coeffs = _configs(in_hz, out_hz, taps, C)
    M = tc.ratio_den
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((B, C, tc.buffer_alloc), dtype=np.float32)
    buf[:, :, tc.input_capacity:] = 0.0
    if ragged:
        avail, pos, nv = rng.integers(0, 600, B), rng.integers(0, 3 * M, B), rng.choice([0, 1, n], B)
        avail[0], nv[0] = 0, 0
    else:
        avail, pos, nv = np.full(B, taps - 1), np.full(B, M // 3), np.full(B, n)
    chunks = rng.standard_normal((B, n, C), dtype=np.float32)
    shared = chunks.copy()
    shared[:, int(nv[-1]):] = np.nan
    chunks[np.arange(n)[None, :] >= nv[:, None]] = np.nan
    feeds = torch.from_numpy(chunks), torch.from_numpy(shared)
    return b9.FleetStepPlan(tc, coeffs), torch.from_numpy(buf), feeds, avail, pos, nv


BAND_CASES = {
    "44k1-48k": (44100, 48000, 128, 20, 2, 4096, False),
    "ragged": (44100, 48000, 128, 20, 2, 4096, True),
    "48k-44k1": (48000, 44100, 128, 20, 2, 4096, False),
    "M2": (48000, 96000, 128, 20, 2, 4096, False),
    "47952-48k": (47952, 48000, 32, 20, 2, 4096, False),
    "47952-48k-ragged-C3": (47952, 48000, 32, 13, 3, 2048, True),
}


@pytest.mark.parametrize("case", list(BAND_CASES))
def test_band_tile_emulation_matches_plain(case):
    """B9 (a schedule per stream) and B8 (the last stream's schedule,
    shared) through the tile plan: outputs within 1e-6 of
    ``step_reference`` (both sum in f64, so this checks the index map),
    the next buffer bit-equal, every output in ``[0, out_cap)`` stored
    once, and the outputs finite with NaN junk in the feed."""
    in_hz, out_hz, taps, B, C, n, ragged = BAND_CASES[case]
    plan, buf, (chunks, shared), avail, pos, nv = _band_case(in_hz, out_hz, taps, B, C, n,
                                                             ragged, 3)
    assert plan.form == "band"
    budget = np.full(B, plan.config.out_capacity)
    s9 = b9.schedule(plan, avail, pos, nv, budget, n)
    s8 = b9.schedule(plan, avail[-1:], pos[-1:], nv[-1:], budget[-1:], n)
    for sched, feed in ((s9, chunks), (s8, shared)):
        new_ref, out_ref = b9.step_reference(plan, buf, feed, sched, None)
        new, out, writes = emulate_band_step(plan, buf, feed, sched)
        assert torch.equal(new, new_ref)
        assert bool((writes == 1).all())
        assert bool(torch.isfinite(out).all())
        assert (out - out_ref).abs().max().item() <= ATOL
    if ragged:  # the streams' canonical starts diverge
        assert len(np.unique(s9["r"] * plan.l_inv % plan.config.ratio_den)) > 1
        assert (s9["n_out"] == 0).any() and (s9["n_out"] > 0).any()


@pytest.mark.parametrize(
    "in_hz,out_hz,taps,C,form",
    [(44100, 48000, 128, 2, "band"), (48000, 44100, 128, 2, "band"), (48000, 96000, 128, 2, "band"),
     (44100, 48000, 32, 3, "band"), (44100, 48000, 32, 8, "band"), (48000, 44100, 64, 2, "band"),
     (48000, 96000, 64, 2, "band"), (47952, 48000, 128, 2, "band"), (48000, 8000, 128, 2, "band"),
     (44100, 1000, 128, 2, "thread"), (44100, 2000, 64, 2, "thread")],
)
def test_band_form_shape_rule(in_hz, out_hz, taps, C, form):
    """The band form unless its tile's shared memory would pass 227 KB:
    phase 16's shapes, the card test's and 47952 -> 48000 take it; heavy
    downsampling (a window of q_tile L / M columns) takes the per-output
    form."""
    _, tc, coeffs = _configs(in_hz, out_hz, taps, C)
    plan = b9.FleetStepPlan(tc, coeffs)
    tile = plan.tile
    assert plan.form == form
    assert (tile.smem_bytes > b9.SMEM_MAX) == (form == "thread")
    M = tc.ratio_den
    assert tile.R == min(8, M) and tile.warps == 8 and tile.pitch % 2 == 1
    assert tile.smem_bytes == 24 * 32 + 4 * (tile.warps * tile.Rp * tile.band_w + 32 * tile.pitch)
    q = np.arange(3 * M + tile.q_tile, dtype=np.int64)
    np.testing.assert_array_equal(tile.d(q), q * tc.ratio_num // M)
    if (in_hz, out_hz, taps) == (44100, 48000, 128):  # bands 135 x 8 x 8, windows 187 x 32
        assert (tile.band_w, tile.win, tile.smem_bytes) == (135, 187, 59264)
