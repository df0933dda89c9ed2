"""Tests that need an NVIDIA card: kernels B1-B9 and B6b, the FIR fleets
(periodic in f32 and bf16x4, coprime, async in f32 and bf16x4, vmapped,
slide), the serving runtime and the FFT engine on the card against
the port's plain PyTorch versions and the CPU on the same inputs.  They skip
without a GPU.  This file imports neither JAX nor the JAX package, so it
also runs on a GPU host without JAX (``--noconftest`` skips
tests/conftest.py, which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import resampler_tpu_torch as rt
from resampler_tpu_torch.engine import fft as tfft
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine import fir_fleets
from resampler_tpu_torch.engine.fir_fleets import _farrow_tm_plan, _sync_atlas
from resampler_tpu_torch.ops import fft_magsplit_kernel as mag
from resampler_tpu_torch.ops import fir_async_kernel as b6
from resampler_tpu_torch.ops import fir_dma_kernel as kern
from resampler_tpu_torch.ops import fir_kernel as b9
from resampler_tpu_torch.ops import fir_sync_kernel as b8
from resampler_tpu_torch.ops import matmul3 as m3
from resampler_tpu_torch.utils import tracing

torch.set_num_threads(1)  # several test workers share the machine's cores

KERNEL_ATOL = 1e-5  # f32 sums in another order
DEVICE_ATOL = 5e-5  # bench.py's device-vs-CPU gate
#: the bf16x4 fleet against the f32 one: four passes keep ~16 bits of each
#: operand (measured 3.3e-5 on the CPU at outputs up to 4.3)
BF16X4_VS_F32_ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "in_hz,out_hz,taps,R",
    [(44100, 48000, 128, 256), (48000, 96000, 16, 128), (44100, 48000, 64, 6)],
)
def test_kernel_matches_plain_on_card(cuda, in_hz, out_hz, taps, R):
    L, M = rt.types.reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=1, taps=taps, ratio_num=L, ratio_den=M)
    g = tfir._periodic_group_factor(L, M)
    Lg, Mg = L * g, M * g
    span = Lg + taps + 1
    K = -(-cfg.out_capacity // Mg)
    coeffs = tfir.fir_coefficients(
        taps, rt.Attenuation.Db90, tfir.fir_cutoff(taps, rt.Attenuation.Db90, in_hz / out_hz)
    )
    a2 = _sync_atlas(dataclasses.replace(cfg, ratio_num=Lg, ratio_den=Mg), coeffs)
    rng = np.random.default_rng(0)
    rows = (K - 1) * Lg + span
    buf = torch.from_numpy(rng.standard_normal((rows + 37, R), dtype=np.float32)).to(cuda)
    geo = dict(L=Lg, M=Mg, span=span, K=K)
    before = kern.LAUNCHES["dma_banded_contract"]
    n = 0
    for i0 in (0, M - 1):
        c0 = (i0 * L) // M
        a = torch.from_numpy(np.ascontiguousarray(a2[i0 : i0 + Mg, c0 : c0 + span])).to(cuda)
        for base in (1, 5, 37):  # odd bases; 37 is the top bound
            got = kern.dma_banded_contract(buf, base, a, **geo)
            ref = kern.dma_banded_contract_reference(buf, base, a, **geo)
            torch.cuda.synchronize()
            assert (got - ref).abs().max().item() <= KERNEL_ATOL
            n += 1
    assert kern.LAUNCHES["dma_banded_contract"] == before + n
    with pytest.raises(IndexError):
        kern.dma_banded_contract(buf, 38, a, **geo)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "in_hz,out_hz,taps,R",
    [(44100, 48000, 128, 256), (44100, 48000, 64, 256), (48000, 96000, 64, 128), (44100, 48000, 128, 6),
     (48000, 8000, 128, 132)],
    ids=["main", "taps64", "grouped", "ragged-R6", "rows16"],
)
def test_band_kernel_matches_plain_on_card(cuda, in_hz, out_hz, taps, R):
    """B1 as the fleet calls it (band plan, the transposed atlas's window
    read in place) at three start phases, against the plain version and
    against the full span (``band=None``) on the same inputs; one launch
    per call."""
    L, M = rt.types.reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=1, taps=taps, ratio_num=L, ratio_den=M)
    g = tfir._periodic_group_factor(L, M)
    Lg, Mg = L * g, M * g
    span = Lg + taps + 1
    K = -(-cfg.out_capacity // Mg)
    coeffs = tfir.fir_coefficients(
        taps, rt.Attenuation.Db90, tfir.fir_cutoff(taps, rt.Attenuation.Db90, in_hz / out_hz)
    )
    a2 = _sync_atlas(dataclasses.replace(cfg, ratio_num=Lg, ratio_den=Mg), coeffs)
    a2_t = torch.from_numpy(np.ascontiguousarray(a2.T)).to(cuda)
    plan = kern.BandPlan(Lg, Mg, taps)
    rng = np.random.default_rng(3)
    rows = (K - 1) * Lg + span
    buf = torch.from_numpy(rng.standard_normal((rows + 37, R), dtype=np.float32)).to(cuda)
    geo = dict(L=Lg, M=Mg, span=span, K=K)
    n = 0
    for i0 in sorted({0, int(rng.integers(0, M)), M - 1}):
        c0 = (i0 * L) // M
        a = a2_t[c0 : c0 + span, i0 : i0 + Mg].T
        for base in (1, 5, 37):  # odd bases; 37 is the top bound
            ref = kern.dma_banded_contract_reference(buf, base, a, **geo)
            before = kern.LAUNCHES["dma_banded_contract"]
            got = kern.dma_banded_contract(buf, base, a, band=(plan, i0), **geo)
            assert kern.LAUNCHES["dma_banded_contract"] == before + 1
            full = kern.dma_banded_contract(buf, base, a, **geo)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all()
            assert (got - ref).abs().max().item() <= KERNEL_ATOL
            assert (got - full).abs().max().item() <= KERNEL_ATOL
            n += 1
    assert n >= 3


#: the fused epilogue's card cases: rates, streams, channels, chunk
#: frames, horizon, each step's valid frames, and whether a valid input row
#: holds a NaN
FUSED_CASES = {
    "main": (44100, 48000, 1024, 2, 4096, 16, [4096] * 3, False),
    "masked": (44100, 48000, 8, 2, 512, 3, [512, 100, 37, 512, 260, 512, 1], False),
    # R 303: no 16-byte ring copies (vec 0), and stream 85's lanes 255-257
    # lie in two lane tiles
    "ragged-lanes": (44100, 48000, 101, 3, 512, 3, [512] * 4, False),
    "nan": (44100, 48000, 8, 2, 512, 3, [512] * 4, True),
    "compaction": (44100, 48000, 8, 2, 512, 1, [512] * 18, False),  # compactions after steps 8, 16
    # the grouped atlas (g 64) and the 16-row tile, mono
    "grouped": (48000, 96000, 4, 2, 512, 3, [512] * 3, False),
    "rows16-mono": (48000, 8000, 5, 1, 2048, 3, [2048] * 3, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_tm_step_matches_aten_epilogue_on_card(cuda, case):
    """The tm step's fused epilogue (B1 writes ``[B, out_cap, C]``, zeroes
    the rows past ``n_out`` and meters the peak) against the ATen one on
    the same feed: B1 time-major (``out_layout="tm"``), then the mask, the
    relayout and ``abs().amax()``.  Outputs and peak equal bit for bit
    (the same sums in the same order, stored elsewhere); frames past
    ``n_valid`` are NaN and reach nothing; a NaN in a valid row makes the
    peak NaN; the compaction case compares the steps after the ring moved."""
    in_hz, out_hz, B, C, n, horizon, feeds, poison = FUSED_CASES[case]
    L, M = rt.types.reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=C, taps=128, ratio_num=L, ratio_den=M)
    coeffs = tfir.fir_coefficients(
        128, rt.Attenuation.Db90, tfir.fir_cutoff(128, rt.Attenuation.Db90, in_hz / out_hz)
    )
    kw = dict(max_chunk=n, horizon=horizon, device=cuda)
    fused = fir_fleets.make_fir_fleet_step_sync_tm(cfg, coeffs, B, meter_peak=True, **kw)
    aten = fir_fleets.make_fir_fleet_step_sync_tm(cfg, coeffs, B, out_layout="tm", **kw)
    s_f = fir_fleets.fir_fleet_init_sync_tm(cfg, B, max_chunk=n, horizon=horizon, device=cuda)
    s_a = fir_fleets.fir_fleet_init_sync_tm(cfg, B, max_chunk=n, horizon=horizon, device=cuda)
    out_cap = cfg.out_capacity
    gen = torch.Generator(device=cuda).manual_seed(21)
    tracing.reset_counters()
    nan_peaks = emitting = 0
    for k, nv in enumerate(feeds):
        chunk = torch.randn((n, B * C), generator=gen, device=cuda)
        chunk[nv:] = float("nan")
        if poison and k == 1:
            chunk[100, 3 * C + C - 1] = float("nan")
        before = kern.LAUNCHES["dma_banded_contract"]
        s_f, out, c_f, p_f, peak = fused(s_f, chunk, nv)
        s_a, out_tm, c_a, p_a = aten(s_a, chunk, nv)
        assert (c_f, p_f) == (c_a, p_a)
        assert kern.LAUNCHES["dma_banded_contract"] == before + 2 * (p_f > 0)
        want = out_tm.reshape(out_cap, B, C).permute(1, 0, 2).contiguous()
        want_peak = want.abs().amax()
        if peak is None:  # a step that emits nothing keeps the ATen epilogue
            assert p_f == 0
            peak = out.abs().amax()
        emitting += p_f > 0
        torch.cuda.synchronize()
        assert out.shape == (B, out_cap, C)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32)), f"step {k}"
        assert torch.equal(peak.view(torch.int32), want_peak.view(torch.int32)), f"step {k}"
        assert not out[:, p_f:].any()
        nan_peaks += bool(torch.isnan(peak))
        assert all(s_f[key] == s_a[key] for key in ("start", "fill", "pos_num"))
    counts = tracing.counters()
    assert counts["fir.fused_epilogue"] == emitting >= len(feeds) - 1
    assert (nan_peaks > 0) == poison
    if case == "compaction":
        assert counts["fir.compactions"] >= 2
    assert torch.equal(s_f["buffer"].view(torch.int32), s_a["buffer"].view(torch.int32))


#: the farrow / lerp / wide fused epilogue's card cases: rates, path,
#: streams, channels, chunk frames, horizon, each step's valid frames, and
#: whether a valid input row holds a NaN
FUSED_FARROW_CASES = {
    # the cell's width
    "farrow": (44100, 44101, "auto", 1024, 2, 4096, 16, [4096] * 3, False),
    "lerp-masked": (44100, 44101, "lerp", 8, 2, 512, 3, [512, 100, 37, 512, 260, 512, 1], False),
    "wide": (600011, 600013, "auto", 8, 2, 512, 3, [512, 300, 512, 512], False),
    # R 301 (mono) and R 262 (stereo): lanes past the last 256-lane tile
    "ragged-mono": (44100, 44101, "auto", 301, 1, 512, 3, [512] * 4, False),
    "ragged-wide-stereo": (600011, 600013, "auto", 131, 2, 512, 3, [512] * 4, False),
    "nan": (44100, 44101, "auto", 8, 2, 512, 3, [512] * 4, True),
    "compaction": (44100, 44101, "lerp", 8, 2, 512, 1, [512] * 18, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FUSED_FARROW_CASES))
def test_fused_farrow_step_matches_aten_epilogue_on_card(cuda, case):
    """The farrow / lerp / wide tm step's fused epilogue (B2 writes ``[B,
    out_cap, C]``, zeroes the rows past ``n_out`` and meters the peak)
    against the ATen one on the same feed: B2 time-major
    (``out_layout="tm"``), then the mask, the relayout and
    ``abs().amax()``.  Outputs and peak equal bit for bit (the same sums in
    the same order, stored elsewhere), and so do the counts, the state's
    ints and the ring; frames past ``n_valid`` are NaN and reach nothing; a
    NaN in a valid row makes the peak NaN; the compaction case compares the
    steps after the ring moved.  B2 launches once per emitting step of
    each step function."""
    in_hz, out_hz, path, B, C, n, horizon, feeds, poison = FUSED_FARROW_CASES[case]
    L, M = rt.types.reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=C, taps=128, ratio_num=L, ratio_den=M)
    coeffs = tfir.fir_coefficients(
        128, rt.Attenuation.Db90, tfir.fir_cutoff(128, rt.Attenuation.Db90, in_hz / out_hz)
    )
    kw = dict(max_chunk=n, horizon=horizon, path=path, device=cuda)
    fused = fir_fleets.make_fir_fleet_step_sync_tm(cfg, coeffs, B, meter_peak=True, **kw)
    aten = fir_fleets.make_fir_fleet_step_sync_tm(cfg, coeffs, B, out_layout="tm", **kw)
    s_f = fir_fleets.fir_fleet_init_sync_tm(cfg, B, max_chunk=n, horizon=horizon, device=cuda)
    s_a = fir_fleets.fir_fleet_init_sync_tm(cfg, B, max_chunk=n, horizon=horizon, device=cuda)
    out_cap = cfg.out_capacity
    gen = torch.Generator(device=cuda).manual_seed(23)
    tracing.reset_counters()
    nan_peaks = emitting = 0
    for k, nv in enumerate(feeds):
        chunk = torch.randn((n, B * C), generator=gen, device=cuda)
        chunk[nv:] = float("nan")
        if poison and k == 1:
            chunk[100, 3 * C + C - 1] = float("nan")
        before = kern.LAUNCHES["dma_farrow_contract"]
        s_f, out, c_f, p_f, peak = fused(s_f, chunk, nv)
        s_a, out_tm, c_a, p_a = aten(s_a, chunk, nv)
        assert (c_f, p_f) == (c_a, p_a)
        assert kern.LAUNCHES["dma_farrow_contract"] == before + 2 * (p_f > 0)
        want = out_tm.reshape(out_cap, B, C).permute(1, 0, 2).contiguous()
        want_peak = want.abs().amax()
        if peak is None:  # a step that emits nothing keeps the ATen epilogue
            assert p_f == 0
            peak = out.abs().amax()
        emitting += p_f > 0
        torch.cuda.synchronize()
        assert out.shape == (B, out_cap, C)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32)), f"step {k}"
        assert torch.equal(peak.view(torch.int32), want_peak.view(torch.int32)), f"step {k}"
        assert not out[:, p_f:].any()
        nan_peaks += bool(torch.isnan(peak))
        assert all(s_f[key] == s_a[key] for key in s_a if key != "buffer")
    counts = tracing.counters()
    assert counts["fir.fused_epilogue"] == emitting >= len(feeds) - 1
    assert counts["fir.farrow_steps"] == 2 * emitting
    assert (nan_peaks > 0) == poison
    if case == "compaction":
        assert counts["fir.compactions"] >= 2
    assert torch.equal(s_f["buffer"].view(torch.int32), s_a["buffer"].view(torch.int32))


#: ``fir.fused_epilogue / fir.steps`` by fleet on the card: the tm fleet on
#: the periodic path (B1) and on the coprime path (B2) fuse; the coprime
#: fleet whose blocks are B3's does not (on the CPU every fleet reads 0)
SHARES = {"tm": 1, "tm-layout-tm": 0, "coprime": 1, "async": 0, "vmapped": 0, "packed": 0}
#: the rate pair of each fleet of ``SHARES`` that is not 44.1 -> 48 kHz
SHARE_RATES = {"coprime": (44100, 44101), "packed": (48000, 1601)}


@pytest.mark.parametrize(
    "dev,fleet",
    [("cpu", name) for name in SHARES]
    + [pytest.param("cuda", name, marks=pytest.mark.cuda) for name in SHARES],
)
def test_fused_epilogue_share(request, dev, fleet):
    """The share of steps the fused epilogue served: 1 on the tm fleet
    with ``"bm"`` outputs on the card, periodic (B1) or coprime (B2); 0 for
    ``out_layout="tm"``, the coprime tm fleet on B3 (48 -> 1.601 kHz), the
    async fleet and the vmapped fleet, and 0 for every fleet on the CPU."""
    device = torch.device("cpu") if dev == "cpu" else request.getfixturevalue("cuda")
    B, C, n, steps = 4, 2, 512, 5
    in_hz, out_hz = SHARE_RATES.get(fleet, (44100, 48000))
    rng = np.random.default_rng(17)
    tracing.reset_counters()
    if fleet == "tm-layout-tm":
        L, M = rt.types.reduce_ratio(44100, out_hz)
        cfg = tfir.FirConfig(channels=C, taps=128, ratio_num=L, ratio_den=M)
        coeffs = tfir.fir_coefficients(
            128, rt.Attenuation.Db90, tfir.fir_cutoff(128, rt.Attenuation.Db90, 44100 / out_hz)
        )
        step = fir_fleets.make_fir_fleet_step_sync_tm(
            cfg, coeffs, B, max_chunk=n, out_layout="tm", meter_peak=True, device=device)
        state = fir_fleets.fir_fleet_init_sync_tm(cfg, B, max_chunk=n, device=device)
        for _ in range(steps):
            chunk = torch.from_numpy(rng.standard_normal((n, B * C), dtype=np.float32)).to(device)
            state, _, _, produced, peak = step(state, chunk, n)
            assert produced > 0 and peak is None
    else:
        kw = {"tm": dict(synchronized=True), "coprime": dict(synchronized=True),
              "packed": dict(synchronized=True),
              "async": dict(synchronized=True, sync_variant="async_tm"), "vmapped": {}}[fleet]
        f = rt.BatchedResamplerFir(B, C, in_hz, out_hz, rt.Latency.Sample64, rt.Attenuation.Db90,
                                   max_chunk=n, device=device, **kw)
        for _ in range(steps):
            _, _, produced, peak = f.resample(rng.standard_normal((B, n, C), dtype=np.float32))
            assert int(produced[0]) > 0 and peak.shape == ()
        assert tracing.counters()["fir.steps"] == steps
    share = SHARES[fleet] if dev == "cuda" else 0
    assert tracing.counters()["fir.fused_epilogue"] == share * steps


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", [3, 1])
def test_fleet_on_card_matches_cpu(cuda, horizon):
    """Card vs CPU, ints and ring exact; horizon 1 with a crafted feed
    makes a compaction whose source window overlaps its destination."""
    kw = dict(synchronized=True, max_chunk=512, horizon=horizon)
    args = (3, 2, 44100, 48000, rt.Latency.Sample64, rt.Attenuation.Db90)
    dev = rt.BatchedResamplerFir(*args, device=cuda, **kw)
    cpu = rt.BatchedResamplerFir(*args, device="cpu", **kw)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    rng = np.random.default_rng(1)
    before = kern.LAUNCHES["dma_banded_contract"]
    produced_steps = 0
    feeds = [512 if i % 2 else int(rng.integers(0, 513)) for i in range(24)]
    if horizon == 1:
        feeds[:9] = [512] * 8 + [3]
    for nv in feeds:
        chunks = rng.standard_normal((3, 512, 2), dtype=np.float32)
        chunks[:, nv:] = np.nan
        od, cd, pd, _ = dev.resample(chunks, np.full((3,), nv))
        oc, cc, pc, _ = cpu.resample(chunks, np.full((3,), nv))
        assert np.array_equal(cd, cc) and np.array_equal(pd, pc)
        assert (od.cpu() - oc).abs().max().item() <= DEVICE_ATOL
        for k in ("start", "fill", "pos_num"):
            assert dev.state[k] == cpu.state[k]
        assert torch.equal(dev.state["buffer"].cpu(), cpu.state["buffer"])
        produced_steps += int(pd[0]) > 0
    assert kern.LAUNCHES["dma_banded_contract"] == before + produced_steps


@pytest.mark.cuda
@pytest.mark.parametrize(
    "in_hz,out_hz,R",
    [(44100, 44101, 256), (367500, 1601, 256), (48000, 3001, 128), (48000, 1601, 6), (44100, 44101, 6)],
    ids=["b2-q64", "b3-q1", "b3-q4", "b3-q2-ragged", "b2-ragged"],
)
def test_farrow_kernels_match_plain_on_card(cuda, in_hz, out_hz, R):
    L, M = rt.types.reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=1, taps=128, ratio_num=L, ratio_den=M)
    plan = _farrow_tm_plan(cfg, np.zeros((tfir.PHASES, 128), np.float32))
    K, q, w, bb = plan["K"], plan["q"], plan["w_blk"], plan["block_base"]
    name = "dma_farrow_contract" if q >= 8 else "dma_farrow_contract_packed"
    fn = getattr(kern, name)
    rng = np.random.default_rng(2)
    a_blk = torch.from_numpy((rng.standard_normal((K, q, w)) / np.sqrt(w)).astype(np.float32)).to(cuda)
    rows = int(bb.max()) + w
    buf = torch.from_numpy(rng.standard_normal((rows + 41, R), dtype=np.float32)).to(cuda)
    before = kern.LAUNCHES[name]
    bases = (1, 7, 41)  # odd bases; 41 is the top bound
    for base in bases:
        got = fn(buf, base, a_blk, bb)
        ref = kern.dma_farrow_contract_reference(buf, base, a_blk, bb)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() <= KERNEL_ATOL
    assert kern.LAUNCHES[name] == before + len(bases)
    with pytest.raises(IndexError):
        fn(buf, 42, a_blk, bb)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "in_hz,out_hz,path,name",
    [(44100, 44101, "auto", "dma_farrow_contract"),
     (44100, 44101, "lerp", "dma_farrow_contract"),
     (600011, 600013, "auto", "dma_farrow_contract"),
     (48000, 1601, "auto", "dma_farrow_contract_packed")],
    ids=["farrow", "lerp", "wide", "packed"],
)
def test_coprime_fleet_on_card_matches_cpu(cuda, in_hz, out_hz, path, name):
    """Card vs CPU on ragged feeds with NaN junk: ints equal, ring
    bit-equal, samples within the device gate; one launch per emitting
    step."""
    kw = dict(synchronized=True, max_chunk=512, horizon=3, path=path)
    args = (3, 2, in_hz, out_hz, rt.Latency.Sample64, rt.Attenuation.Db90)
    dev = rt.BatchedResamplerFir(*args, device=cuda, **kw)
    cpu = rt.BatchedResamplerFir(*args, device="cpu", **kw)
    rng = np.random.default_rng(3)
    before = kern.LAUNCHES[name]
    weights_before = kern.LAUNCHES["farrow_weights"]
    produced_steps = 0
    for i in range(30):
        nv = 512 if i % 2 else int(rng.integers(0, 513))
        chunks = rng.standard_normal((3, 512, 2), dtype=np.float32)
        chunks[:, nv:] = np.nan
        od, cd, pd, _ = dev.resample(chunks, np.full((3,), nv))
        oc, cc, pc, _ = cpu.resample(chunks, np.full((3,), nv))
        assert np.array_equal(cd, cc) and np.array_equal(pd, pc)
        assert (od.cpu() - oc).abs().max().item() <= DEVICE_ATOL
        for k, v in cpu.state.items():
            if k != "buffer":
                assert dev.state[k] == v, k
        assert torch.equal(dev.state["buffer"].cpu(), cpu.state["buffer"])
        produced_steps += int(pd[0]) > 0
    assert produced_steps > 0
    assert kern.LAUNCHES[name] == before + produced_steps
    assert kern.LAUNCHES["farrow_weights"] == weights_before + produced_steps


#: B2's band cases: the pair (its plan's q), the lanes (R 262: not a
#: multiple of 4, so no 16-byte ring copies, nor of 256) and the channels
#: of the fused form's ``[R / C, out_cap, C]`` output
BAND_B2_CASES = {
    "q64": ((44100, 44101), 512, 2),
    "q64-ragged": ((44100, 44101), 262, 2),
    "q16": ((48000, 12001), 512, 2),
    "q16-ragged-mono": ((48000, 12001), 262, 1),
    "q8": ((48000, 6001), 256, 2),
    "q8-ragged": ((48000, 6001), 262, 2),
}


def _b2_band_case(pair, R, device, seed):
    """The tm fleet's Farrow plan at ``pair`` (128 taps), its band plan,
    three weight sets from the plain ``farrow_weights`` (positions on both
    sides of a row's wrap) and a ring with room for the top bound."""
    L, M = rt.types.reduce_ratio(*pair)
    cfg = tfir.FirConfig(channels=1, taps=128, ratio_num=L, ratio_den=M)
    coeffs = tfir.fir_coefficients(
        128, rt.Attenuation.Db90, tfir.fir_cutoff(128, rt.Attenuation.Db90, pair[0] / pair[1])
    )
    fp = _farrow_tm_plan(cfg, coeffs)
    band = kern.FarrowBandPlan(fp["j_loc"], 128, fp["w_blk"])
    ashift2 = torch.from_numpy(fp["ashift2"]).to(device)
    s = int(fp["s_pad"][0, 1])
    weights = [fir_fleets.farrow_weights(fp, M, pos, ashift2) for pos in (0, M - s - 1, M - s)]
    rng = np.random.default_rng(seed)
    rows = int(fp["block_base"].max()) + fp["w_blk"]
    buf = torch.from_numpy(rng.standard_normal((rows + 21, R), dtype=np.float32)).to(device)
    return fp, band, weights, buf


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BAND_B2_CASES))
def test_banded_b2_matches_plain_on_card(cuda, case):
    """B2 with the fleet's band plan, both forms, against its plain version
    (the full contraction) and against B2 over the full width (``band=None``)
    on the same weights: the time-major form within the kernels' tolerance
    of both; the fused form with ``n_out`` inside a row tile bit for bit the
    banded time-major form's rows below ``n_out`` (the same loop), zeros
    past it, its peak that of those rows, and within the tolerance of the
    plain fused version.  One launch a call."""
    pair, R, C = BAND_B2_CASES[case]
    fp, band, weights, buf = _b2_band_case(pair, R, cuda, seed=len(case))
    K, q, w = band.shape
    bb = fp["block_base"]
    out_cap = K * q - 3
    n_out = 32 * (out_cap // 32 - 2) + 13  # inside a row tile and a block
    for a_blk in weights:
        for base in (1, 21):  # an odd base and the top bound
            ref = kern.dma_farrow_contract_reference(buf, base, a_blk, bb)
            before = kern.LAUNCHES["dma_farrow_contract"]
            got = kern.dma_farrow_contract(buf, base, a_blk, bb, band=band)
            assert kern.LAUNCHES["dma_farrow_contract"] == before + 1
            full = kern.dma_farrow_contract(buf, base, a_blk, bb)
            out = torch.full((R // C, out_cap, C), 7.0, device=cuda)
            peak = torch.zeros((), device=cuda)
            kern.dma_farrow_contract_bm(buf, base, a_blk, bb, out, peak, n_out=n_out, band=band)
            out_p = torch.full_like(out, 7.0)
            peak_p = torch.zeros((), device=cuda)
            kern.dma_farrow_contract_bm_reference(buf, base, a_blk, bb, out_p, peak_p, n_out=n_out)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all()
            assert (got - ref).abs().max().item() <= KERNEL_ATOL
            assert (got - full).abs().max().item() <= KERNEL_ATOL
            tm = got.reshape(K * q, R)[:out_cap].clone()
            tm[n_out:] = 0.0
            want = tm.reshape(out_cap, R // C, C).permute(1, 0, 2).contiguous()
            assert torch.equal(out.view(torch.int32), want.view(torch.int32))
            assert torch.equal(peak.view(torch.int32), want.abs().amax().view(torch.int32))
            assert (out - out_p).abs().max().item() <= KERNEL_ATOL
            assert abs(peak.item() - peak_p.item()) <= KERNEL_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("R,C", [(512, 2), (262, 2), (131, 1)], ids=["vec", "ragged", "mono"])
def test_banded_b2_reads_nothing_outside_the_band_on_card(cuda, R, C):
    """B2 never reads what lies outside every tile's band: on a plan whose
    offsets give each 32-row tile a band far narrower than the blocks'
    width (``j_loc = l // 8``, 64 taps, ``w`` 192), with blocks ``w + 5``
    rows apart, the ring rows outside every band and the weight columns
    outside each tile's band are NaN, and both forms give finite outputs,
    within the tolerance of the plain version on the same inputs with the
    NaN weights zeroed and the NaN rows read as zero."""
    K, q, w, taps = 5, 64, 192, 64
    j_loc = np.tile(np.arange(q) // 8, (K, 1)).astype(np.int32)
    band = kern.FarrowBandPlan(j_loc, taps, w)
    assert band.tiles[0].tolist() == [[0, 68], [4, 72]]
    bb = np.arange(K, dtype=np.int64) * (w + 5)
    base = 3
    rng = np.random.default_rng(29)
    ring = base + int(bb[-1]) + w + 4
    buf = torch.from_numpy(rng.standard_normal((ring, R), dtype=np.float32))
    a_blk = torch.from_numpy(rng.standard_normal((K, q, w), dtype=np.float32) / 8)
    read = torch.zeros(ring, dtype=torch.bool)
    cols = torch.arange(w)
    for k in range(K):
        for t, (lo, hi) in enumerate(band.tiles[k].tolist()):
            read[base + bb[k] + lo : base + bb[k] + hi] = True
            a_blk[k, t * 32 : (t + 1) * 32, (cols < lo) | (cols >= hi)] = float("nan")
    assert 0 < int(read.sum()) < ring // 2
    clean_buf, clean_a = buf.clone(), torch.nan_to_num(a_blk, nan=0.0)
    clean_buf[~read] = 0.0
    buf[~read] = float("nan")
    ref = kern.dma_farrow_contract_reference(clean_buf, base, clean_a, bb)
    buf, a_blk = buf.to(cuda), a_blk.to(cuda)
    got = kern.dma_farrow_contract(buf, base, a_blk, bb, band=band)
    out_cap = K * q - 7
    out = torch.empty((R // C, out_cap, C), device=cuda)
    peak = torch.zeros((), device=cuda)
    kern.dma_farrow_contract_bm(buf, base, a_blk, bb, out, peak, n_out=out_cap - 40, band=band)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.isfinite(out).all() and torch.isfinite(peak)
    assert (got.cpu() - ref).abs().max().item() <= KERNEL_ATOL
    want = ref.reshape(K * q, R)[:out_cap].clone()
    want[out_cap - 40 :] = 0.0
    want = want.reshape(out_cap, R // C, C).permute(1, 0, 2)
    assert (out.cpu() - want).abs().max().item() <= KERNEL_ATOL


#: ``fir.banded_steps / fir.farrow_steps`` of the coprime tm fleet on the
#: card: 1 where B2 contracts (farrow, lerp, wide; fused or time-major
#: outputs), 0 where B3 does
BANDED_SHARES = {"farrow": ((44100, 44101), "auto", "bm", 1),
                 "lerp-tm": ((44100, 44101), "lerp", "tm", 1),
                 "wide": ((600011, 600013), "auto", "bm", 1),
                 "packed": ((48000, 1601), "auto", "bm", 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("fleet", sorted(BANDED_SHARES))
def test_banded_steps_share_on_card(cuda, fleet):
    (in_hz, out_hz), path, layout, share = BANDED_SHARES[fleet]
    L, M = rt.types.reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=2, taps=128, ratio_num=L, ratio_den=M)
    coeffs = tfir.fir_coefficients(
        128, rt.Attenuation.Db90, tfir.fir_cutoff(128, rt.Attenuation.Db90, in_hz / out_hz)
    )
    B, n, steps = 4, 512, 5
    step = fir_fleets.make_fir_fleet_step_sync_tm(cfg, coeffs, B, max_chunk=n, path=path,
                                                  out_layout=layout, device=cuda)
    state = fir_fleets.fir_fleet_init_sync_tm(cfg, B, max_chunk=n, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(31)
    tracing.reset_counters()
    for _ in range(steps):
        state, _, _, produced = step(state, torch.randn((n, 2 * B), generator=gen, device=cuda), n)
        assert produced > 0
    c = tracing.counters()
    assert c["fir.farrow_steps"] == steps and c["fir.banded_steps"] == share * steps


U32 = (1 << 32) - 1


def _weights_words(fp, M: int, wide: bool) -> list[int]:
    """Residue words: 0, 1, 43 (outputs past branch 1023), M - 1, each word
    at which some split wraps and the word below it, 200 seeded random
    words; when wide, each ``pos_lo`` at which some split's u32 sum wraps
    past 2^32 and the word below it."""
    s = np.unique(fp["s_pad"])
    s = s[s > 0].astype(np.int64)
    words = {0, 1, 43, M - 1, *(M - s).tolist(), *(M - s - 1).tolist()}
    words |= set(np.random.default_rng(22).integers(0, M, 200).tolist())
    if wide:
        words |= {*(U32 + 1 - s).tolist(), *(U32 - s).tolist(), *range(64), *range(M - 64, M)}
    return sorted(words)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "in_hz,out_hz,basis",
    [(44100, 44101, "cheb"), (44100, 44101, "lerp"), (48000, 1601, "cheb"),
     (600011, 600013, "cheb"), (48000000, 48000066, "cheb")],
    ids=["farrow", "lerp", "packed", "wide", "bridge"],
)
def test_farrow_weights_kernel_matches_plain_on_card(cuda, in_hz, out_hz, basis):
    """The weights kernel against ``farrow_weights`` on the card at every
    residue word of ``_weights_words``:

    - the offsets ``jl = j_loc + wrap`` agree exactly: on an indicator
      basis (1 in its row 0, 0 elsewhere) the kernel gives each row's band;
    - every column outside the plain version's band is exactly 0;
    - at every tenth word the kernel's coefficients are ``combine_basis``'
      bit for bit (a basis that is 1 in its row ``d`` alone gives
      ``coef_d``);
    - in the band the kernel lies within ``8 * 2^-24 * sum_d |coef_d *
      A[d, s - jl]|`` (an 8-term f32 sum's worst case) of the f64 sum of
      the same f32 products, and within twice that of the plain version,
      whose GEMM adds them in another order (measured: 5.5 and 7.1 of
      those units; each side alone reaches 5.5)."""
    L, M = rt.types.reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=2, taps=128, ratio_num=L, ratio_den=M)
    coeffs = tfir.fir_coefficients(128, rt.Attenuation.Db90,
                                   tfir.fir_cutoff(128, rt.Attenuation.Db90, in_hz / out_hz))
    fp = _farrow_tm_plan(cfg, coeffs, basis=basis)
    K, q, w, d1, n_jl, taps = fp["K"], fp["q"], fp["w_blk"], fp["d1"], fp["n_jl"], cfg.taps
    s_pad, j_loc, A, U = fir_fleets.farrow_weight_tables(fp, cuda)
    kernel = kern.FarrowWeightsKernel(s_pad, j_loc, A, U, M=M, w=w)
    # a basis that is 1 in its row d alone (and, lerp, a factor that is 1 in
    # its column 0 alone: coef_0 = 1 exactly)
    units = [torch.zeros_like(A) for _ in range(d1)]
    for d, e in enumerate(units):
        e[d] = 1.0
    u_ind = None if U is None else torch.zeros_like(U)
    if u_ind is not None:
        u_ind[:, 0] = 1.0
    shown = kern.FarrowWeightsKernel(s_pad, j_loc, units[0], u_ind, M=M, w=w)
    coef_of = [kern.FarrowWeightsKernel(s_pad, j_loc, e, U, M=M, w=w) for e in units]
    ashift2 = torch.from_numpy(fp["ashift2"]).to(cuda)
    a64 = ashift2.double()
    band_shift = torch.zeros((n_jl, w), device=cuda)
    for j in range(n_jl):
        band_shift[j, j : j + taps] = 1.0
    cols = torch.arange(n_jl, device=cuda)
    bad_band = torch.zeros((), dtype=torch.int64, device=cuda)
    bad_zero = torch.zeros((), dtype=torch.int64, device=cuda)
    bad_coef = torch.zeros((), dtype=torch.int64, device=cuda)
    worst = torch.zeros((2,), dtype=torch.float64, device=cuda)  # in units of 2^-24 sum|t|
    before = kern.LAUNCHES["farrow_weights"]
    words = _weights_words(fp, M, cfg.wide)
    for i, word in enumerate(words):
        pos = (3, word) if cfg.wide else 7 * M + word
        got = kernel(word)
        plain = fir_fleets.farrow_weights(fp, M, pos, ashift2)
        wrap, rem = tfir.lane_residues(fp["s_pad"], M, pos)
        coef = tfir.combine_basis(rem, M, fp["U"])
        jl = torch.from_numpy(fp["j_loc"] + wrap).to(cuda)
        onehot = (jl[..., None] == cols).to(torch.float32).reshape(K * q, 1, n_jl)
        band = (onehot[:, 0] @ band_shift).reshape(K, q, w)
        c64 = torch.from_numpy(coef.astype(np.float64)).to(cuda).reshape(K * q, d1, 1)
        exact = ((c64 * onehot).reshape(K * q, -1) @ a64).reshape(K, q, w)
        unit = 2.0**-24 * ((c64.abs() * onehot).reshape(K * q, -1) @ a64.abs()).reshape(K, q, w)
        bad_band += (shown(word) != band).sum()
        bad_zero += ((band == 0) & (got != 0)).sum()
        inside = unit > 0
        for k, other in enumerate((exact, plain.double())):
            worst[k] = torch.maximum(worst[k], ((got - other).abs()[inside] / unit[inside]).max())
        if i % 10 == 0:
            for d in range(d1):
                want = torch.from_numpy(coef[..., d]).to(cuda)[..., None]
                bad_coef += ((band != 0) & (coef_of[d](word) != want)).sum()
    torch.cuda.synchronize()
    n_coef = len(range(0, len(words), 10))
    assert kern.LAUNCHES["farrow_weights"] == before + 2 * len(words) + d1 * n_coef
    assert int(bad_band) == 0 and int(bad_zero) == 0 and int(bad_coef) == 0
    assert worst[0] <= 8 and worst[1] <= 16, worst.tolist()


#: the ``fir.wide`` cell's pair (a bridge's rates in millihertz, L/M
#: 8000000 / 8000011) and its limit (``perfbench/limits/fir.wide.json``)
BRIDGE = (48000000, 48000066)
BRIDGE_LIMIT = 1e-4


@pytest.mark.cuda
def test_wide_bridge_step_matches_interpret_on_card(cuda):
    """The ``fir.wide`` cell's step at its width (1024 stereo streams,
    4096-frame chunks) on the card: the fused step (the weights kernel on
    ``pos_lo``, B2 storing ``[B, out_cap, C]``) against
    ``contraction="dma_interpret"`` (``farrow_weights`` and B2's plain
    version on the card's tensors) over 185 steps, across the ``pos_lo``
    wrap at step 183: the same counts and state words every step, outputs
    within the cell's limit, rows past ``n_out`` zero; one launch of the
    weights kernel and of B2 a step, every step on the wide schedule."""
    B, C, n, steps = 1024, 2, 4096, 185
    L, M = rt.types.reduce_ratio(*BRIDGE)
    cfg = tfir.FirConfig(channels=C, taps=128, ratio_num=L, ratio_den=M)
    assert cfg.wide and (L, M) == (8000000, 8000011)
    coeffs = tfir.fir_coefficients(
        128, rt.Attenuation.Db90, tfir.fir_cutoff(128, rt.Attenuation.Db90, BRIDGE[0] / BRIDGE[1])
    )
    kw = dict(max_chunk=n, horizon=16, device=cuda)
    fused = fir_fleets.make_fir_fleet_step_sync_tm(cfg, coeffs, B, **kw)
    plain = fir_fleets.make_fir_fleet_step_sync_tm(cfg, coeffs, B, contraction="dma_interpret", **kw)
    s_f = fir_fleets.fir_fleet_init_sync_tm(cfg, B, **kw)
    s_p = fir_fleets.fir_fleet_init_sync_tm(cfg, B, **kw)
    gen = torch.Generator(device=cuda).manual_seed(28)
    tracing.reset_counters()
    worst = torch.zeros((), dtype=torch.float32, device=cuda)
    past = torch.zeros((), dtype=torch.float32, device=cuda)
    words = []
    for _ in range(steps):
        chunk = torch.rand((n, B * C), generator=gen, device=cuda).mul_(2.0).sub_(1.0)
        words.append(s_f["pos_lo"])
        s_f, out, c_f, p_f = fused(s_f, chunk, n)
        s_p, want, c_p, p_p = plain(s_p, chunk, n)
        assert (c_f, p_f) == (c_p, p_p) and p_f in (3969, 3970)
        assert all(s_f[key] == s_p[key] for key in s_p if key != "buffer")
        worst = torch.maximum(worst, (out[:, :p_f] - want[:, :p_f]).abs().max())
        past = torch.maximum(past, out[:, p_f:].abs().max())
    torch.cuda.synchronize()
    # pos_lo falls 43,659 a step and wraps after step 183
    assert words[183] < 11 * 3970 < words[182] < words[184]
    assert float(worst) <= BRIDGE_LIMIT, float(worst)
    assert float(past) == 0.0
    counts = tracing.counters()
    assert counts["fir.wide_steps"] == 2 * steps and counts["fir.fused_epilogue"] == steps
    assert counts["launches.farrow_weights"] == counts["launches.dma_farrow_contract"] == steps
    print(f"bridge step: worst |fused - interpret| {float(worst):.3e} over {steps} steps")


def _launches_by_stage(fleet, x, steps: int) -> tuple[dict, list]:
    """``steps`` traced steps of ``fleet`` on ``x`` after a warm one:
    ``({stage: [device event names]}, every device event name)``, each
    event given to the innermost span around the launch that made it
    (``perfbench/spans.py``); the counters reset before the traced steps."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import spans, trace

    fleet.resample(x)
    torch.cuda.synchronize()
    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            with record_function(trace.STEP_LABEL):
                fleet.resample(x)
                torch.cuda.synchronize()
    tr = trace.from_profiler(prof, steps)
    launches = sorted((s, k) for name, s, _ in tr.host if (k := spans.launch_kind(name)))
    work = sorted((s, name, spans.device_kind(name)) for name, s, _ in tr.device)
    assert [k for _, k in launches] == [k for _, _, k in work]
    every = spans.spans(tr)
    assert "fir.check" in {sp[0] for sp in every}
    by_stage = {}
    for (ls, _), (_, name, _) in zip(launches, work):
        by_stage.setdefault(spans.innermost(every, ls), []).append(name)
    return by_stage, [name for name, _, _ in tr.device]


@pytest.mark.cuda
def test_farrow_contract_span_launches_b2_alone(cuda):
    """The farrow tm step under the profiler on the card: the device work
    launched in ``fir.contract`` outside ``fir.weights`` and ``fir.check``
    is kernel B2 (``tiled_contract_kernel``), once a step; ``fir.weights``
    launches the weights kernel (``farrow_weights_kernel``) alone, once a
    step; ``fir.check`` launches nothing; no B1, B3 or B6 runs, and none
    of the ATen epilogue's ``abs`` or ``amax`` (B2 stores the output and
    meters the peak); ``launches.farrow_weights``, ``fir.farrow_steps``,
    ``fir.fused_epilogue`` and ``fir.steps`` each count every step."""
    B, C, n, steps = 8, 2, 4096, 4
    fleet = rt.BatchedResamplerFir(B, C, 44100, 44101, rt.Latency.Sample64, rt.Attenuation.Db90,
                                   synchronized=True, max_chunk=n, device=cuda)
    x = torch.rand((B, n, C), device=cuda) * 2 - 1
    by_stage, device = _launches_by_stage(fleet, x, steps)
    assert "fir.check" not in by_stage
    assert len(by_stage["fir.contract"]) == steps
    assert all("tiled_contract_kernel" in name for name in by_stage["fir.contract"])
    assert len(by_stage["fir.weights"]) == steps
    assert all("farrow_weights_kernel" in name for name in by_stage["fir.weights"])
    others = ("band_contract_kernel", "farrow_packed_kernel", "combine_kernel", "AbsFunctor",
              "reduce_kernel")
    assert not any(o in name for name in device for o in others)
    c = tracing.counters()
    assert c["launches.farrow_weights"] == c["fir.farrow_steps"] == c["fir.steps"] == steps
    assert c["fir.fused_epilogue"] == steps


@pytest.mark.cuda
def test_lockstep_contract_span_launches_b1_alone(cuda):
    """The periodic tm step (``fir.lockstep``'s) under the profiler on the
    card: ``fir.contract`` launches kernel B1 (``band_contract_kernel``)
    alone, once a step, ``fir.check`` launches nothing, and no
    ``fir.weights`` opens; ``fir.host_ns`` grew over the traced steps."""
    B, C, n, steps = 8, 2, 4096, 4
    fleet = rt.BatchedResamplerFir(B, C, 44100, 48000, rt.Latency.Sample64, rt.Attenuation.Db90,
                                   synchronized=True, max_chunk=n, device=cuda)
    x = torch.rand((B, n, C), device=cuda) * 2 - 1
    by_stage, device = _launches_by_stage(fleet, x, steps)
    assert "fir.check" not in by_stage and "fir.weights" not in by_stage
    assert len(by_stage["fir.contract"]) == steps
    assert all("band_contract_kernel" in name for name in by_stage["fir.contract"])
    assert not any(o in name for name in device for o in ("tiled_contract_kernel", "AbsFunctor"))
    c = tracing.counters()
    assert c["fir.fused_epilogue"] == c["fir.steps"] == steps and c["fir.host_ns"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_in,n_out,R",
    [(1176, 1280, 256), (588, 1280, 64), (1280, 1176, 37), (1176, 1280, 2), (1280, 3528, 131),
     (2560, 2352, 67), (3528, 1280, 5)],
    ids=["bench-pair", "stopband-pair", "ragged-cols-R37", "stereo-R2", "cols882-R131", "s8-R67",
         "rows4410-R5"],
)
def test_magsplit_kernels_match_plain_on_card(cuda, n_in, n_out, R):
    """B4 and, on a P = 4 pool, B5 against the plain version; a NaN row
    stays in its row; an Inf just past group 0's band (in its last tile's
    tail) and a NaN just before group 1's band leave those groups finite."""
    plan = mag.plan_magsplit(n_in, n_out)
    wh, wcorr = mag.magsplit_weights(plan, cuda)
    rng = np.random.default_rng(5)
    pool = torch.from_numpy(rng.standard_normal((4, R, n_in), dtype=np.float32)).to(cuda)
    before = dict(kern.LAUNCHES)
    got = mag.magsplit_projector(pool[0], pool[1], wh, wcorr, plan=plan)
    ref = mag.magsplit_projector_reference(pool[0], pool[1], wh, wcorr, plan=plan)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= KERNEL_ATOL
    for i, j in ((3, 0), (1, 2)):
        got = mag.magsplit_projector_pool(pool, i, j, wh, wcorr, plan=plan)
        ref = mag.magsplit_projector_reference(pool[i], pool[j], wh, wcorr, plan=plan)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() <= KERNEL_ATOL
    assert kern.LAUNCHES["magsplit_projector"] == before["magsplit_projector"] + 1
    assert kern.LAUNCHES["magsplit_projector_pool"] == before["magsplit_projector_pool"] + 2
    bad = pool[2].clone()
    bad[R // 2, 5] = float("nan")
    got = mag.magsplit_projector(pool[1], bad, wh, wcorr, plan=plan)
    ref = mag.magsplit_projector_reference(pool[1], bad, wh, wcorr, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(torch.isfinite(got), torch.isfinite(ref))
    assert not torch.isfinite(got[R // 2]).all()
    fin = torch.isfinite(ref)
    assert (got[fin] - ref[fin]).abs().max().item() <= KERNEL_ATOL
    x2 = torch.cat([pool[0], pool[1]], dim=1)
    x2[0, plan.rows + 2] = float("inf")
    x2[-1, plan.bps * plan.lp - 1] = float("nan")
    prev, cur = x2[:, :n_in].contiguous(), x2[:, n_in:].contiguous()
    got = mag.magsplit_projector(prev, cur, wh, wcorr, plan=plan)
    ref = mag.magsplit_projector_reference(prev, cur, wh, wcorr, plan=plan)
    torch.cuda.synchronize()
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(got), fin)
    c = plan.cols
    assert torch.isfinite(got[0, :c]).all() and torch.isfinite(got[-1, c : 2 * c]).all()
    assert not fin[0].all() and not fin[-1, :c].all()
    assert (got[fin] - ref[fin]).abs().max().item() <= KERNEL_ATOL


@pytest.mark.cuda
def test_magsplit_kernel_refuses_what_tma_cannot_read(cuda):
    """On the card B4 raises ValueError, launching nothing and running no
    plain version, for N not a multiple of 4 (TMA's 16-byte row stride:
    390 -> 384) and for a ``wcorr`` whose t2h half is not ``wh``'s slice;
    the CPU's plain version takes both."""
    before = dict(kern.LAUNCHES)
    plan = mag.plan_magsplit(390, 384)
    x = torch.ones((8, 390), device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        mag.magsplit_projector(x, x, *mag.magsplit_weights(plan, cuda), plan=plan)
    cpu = mag.magsplit_projector(x.cpu(), x.cpu(), *mag.magsplit_weights(plan, "cpu"), plan=plan)
    assert cpu.shape == (8, 384)
    plan = mag.plan_magsplit(1176, 1280)
    wh, wcorr = mag.magsplit_weights(plan, cuda)
    bad = wcorr.clone()
    bad[0, plan.wc, 0] = 0.5
    x = torch.ones((8, 1176), device=cuda)
    with pytest.raises(ValueError, match="t2h"):
        mag.magsplit_projector(x, x, wh, bad, plan=plan)
    assert mag.magsplit_projector(x.cpu(), x.cpu(), wh.cpu(), bad.cpu(), plan=plan).shape == (8, 1280)
    assert kern.LAUNCHES == before


@pytest.mark.cuda
def test_fft_fleet_on_card_matches_cpu(cuda):
    """``auto`` is magsplit on the card: one B4 launch per fleet step, one
    B4 and T-1 B5 launches per ``resample_many``, outputs within the
    device gate of the CPU fleet (plain version)."""
    B, C = 3, 2
    dev = rt.BatchedResamplerFft(B, C, 44100, 48000, device=cuda)
    cpu = rt.BatchedResamplerFft(B, C, 44100, 48000, backend="magsplit", device="cpu")
    rng = np.random.default_rng(6)
    for name in kern.LAUNCHES:
        kern.LAUNCHES[name] = 0
    for _ in range(3):
        x = rng.standard_normal((B, C, 1176), dtype=np.float32)
        assert (dev.resample(x).cpu() - cpu.resample(x)).abs().max().item() <= DEVICE_ATOL
    x4 = rng.standard_normal((4, B, C, 1176), dtype=np.float32)
    got = dev.resample_many(torch.from_numpy(x4).to(cuda))
    assert (got.cpu() - cpu.resample_many(x4)).abs().max().item() <= DEVICE_ATOL
    assert kern.LAUNCHES == dict(kern.LAUNCHES, magsplit_projector=4, magsplit_projector_pool=3)
    assert sum(kern.LAUNCHES.values()) == 7


def b7_fft_plain(backend, chunks, n_in, n_out):
    """The card's ``matmul`` or ``conv`` FFT step (B7, three passes) on
    per-stream chunks ``[T, C, N]``, through B7's plain version on the CPU:
    ``[T, C, M]``."""
    if backend == "matmul":
        t_hi, t_lo = m3.split_weight(torch.from_numpy(tfft.get_projection_matrix(n_in, n_out)))
    else:
        w = tfft.input_domain_conv_operator(n_in, n_out)
        g, lp, mp = w.shape[0] - 1, w.shape[1], w.shape[2]
        t_hi, t_lo = m3.split_weight(torch.from_numpy(w.reshape((g + 1) * lp, mp)))
    prev, overlap, outs = torch.zeros_like(chunks[0]), 0.0, []
    for x in chunks:
        if backend == "matmul":
            full = m3.matmul3_reference(x, t_hi, t_lo, passes=3)
            outs.append(full[:, :n_out] + overlap)
            overlap = full[:, n_out:]
        else:
            x2 = torch.cat([prev, x], dim=1)
            win = x2.as_strided((x.shape[0], g, (g + 1) * lp), (2 * n_in, lp, 1))
            outs.append(m3.matmul3_reference(win, t_hi, t_lo, passes=3).reshape(x.shape[0], n_out))
            prev = x
    return torch.stack(outs)


@pytest.mark.cuda
def test_fft_pool_step_at_the_transcoders_width_on_card(cuda):
    """The batch transcoder's call (the ``fft.pool`` cell's shapes): 8192
    stereo streams at 48000 -> 44100 Hz (cols 294: the last of a group's
    two 160-column tiles is ragged), T 8, two calls chained through the
    carry.  ``auto`` is magsplit; ``resample_many`` runs chunk 0 on B4
    and chunks 1-7 on B5, B4's kernel on two slots of the stack, so it
    equals eight ``resample`` calls bit for bit.  B5's output rows near
    both ends match the plain version."""
    B, C, T, n_in = 8192, 2, 8, 1280
    many = rt.BatchedResamplerFft(B, C, 48000, 44100, device=cuda)
    one = rt.BatchedResamplerFft(B, C, 48000, 44100, device=cuda)
    assert many._resolved_backend == "magsplit"
    g = torch.Generator(device=cuda)
    g.manual_seed(2**31 + 23)
    tracing.reset_counters()
    for call in range(2):
        x = torch.rand((T, B, C, n_in), generator=g, device=cuda).mul_(2.0).sub_(1.0)
        got = many.resample_many(x)
        for t in range(T):
            assert torch.equal(got[t], one.resample(x[t])), (call, t)
        c = tracing.counters()
        assert (c["fft.pool_steps"], c["fft.chunks"]) == (7 * (call + 1), 16 * (call + 1))
        assert c["launches.magsplit_projector_pool"] == 7 * (call + 1)
        assert c["launches.magsplit_projector"] == 9 * (call + 1)
    plan = mag.plan_magsplit(n_in, 1176)
    assert (plan.rows, plan.wc, plan.cols, plan.s) == (1600, 960, 294, 4)
    wh, wcorr = mag.magsplit_weights(plan, cuda)
    R = B * C
    for rows in (slice(0, 1000), slice(R - 1000, R)):
        ref = mag.magsplit_projector_reference(
            x[0].reshape(R, n_in)[rows].contiguous(), x[1].reshape(R, n_in)[rows].contiguous(),
            wh, wcorr, plan=plan)
        assert (got[1].reshape(R, -1)[rows] - ref).abs().max().item() <= KERNEL_ATOL


@pytest.mark.cuda
def test_resample_many_stores_each_chunk_into_its_slot_on_card(cuda):
    """The transcoder's call (8192 stereo streams, 48000 -> 44100 Hz, T 8)
    after a warm one, under the profiler: one B4 and seven B5 launches,
    each storing its chunk straight into its slot of the call's result
    (``fft.in_place`` 8 of ``fft.chunks`` 8), bit for bit eight ``resample``
    calls.  ``fft.contract`` launches ``magsplit_kernel`` once and
    ``fft.pool`` seven times, ``fft.stack`` (the result's allocation)
    launches nothing, and no ATen cat or stack runs in ``fft.step``.  An
    ``out`` off 8 bytes is refused before the launch."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import spans, trace

    B, C, T, n_in = 8192, 2, 8, 1280
    many = rt.BatchedResamplerFft(B, C, 48000, 44100, device=cuda)
    one = rt.BatchedResamplerFft(B, C, 48000, 44100, device=cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(2**31 + 27)
    xs = [torch.rand((T, B, C, n_in), generator=g, device=cuda).mul_(2.0).sub_(1.0)
          for _ in range(2)]
    many.resample_many(xs[0])
    for t in range(T):
        one.resample(xs[0][t])
    torch.cuda.synchronize()
    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.STEP_LABEL):
            got = many.resample_many(xs[1])
            torch.cuda.synchronize()
    c = tracing.counters()
    assert (c["launches.magsplit_projector"], c["launches.magsplit_projector_pool"]) == (1, 7)
    assert (c["fft.in_place"], c["fft.chunks"], c["fft.pool_steps"]) == (8, 8, 7)
    assert got.shape == (T, B, C, 1176) and got.is_contiguous()
    for t in range(T):
        assert torch.equal(got[t], one.resample(xs[1][t])), t

    # launches by the innermost span around them, from the host side (a
    # later profiler session in one process may lose device events)
    tr = trace.from_profiler(prof, 1)
    every = spans.spans(tr)
    by_stage = {}
    for name, start, _ in tr.host:
        if kind := spans.launch_kind(name):
            by_stage.setdefault(spans.innermost(every, start), []).append(kind)
    assert "fft.stack" in {sp[0] for sp in every} and "fft.stack" not in by_stage
    assert by_stage["fft.contract"] == ["kernel"] and by_stage["fft.pool"] == ["kernel"] * 7
    kernels = [name for name, _, _ in tr.device if spans.device_kind(name) == "kernel"]
    assert any("magsplit_kernel" in name for name in kernels)
    assert not any("CatArray" in name for name in kernels)
    assert not any(ev.name in ("aten::cat", "aten::stack") for ev in prof.events())

    # cols 294 and M 1176 are even: B4 stores column pairs as 8-byte words
    plan = mag.plan_magsplit(n_in, 1176)
    wh, wcorr = mag.magsplit_weights(plan, cuda)
    R = B * C
    odd = torch.empty(R * 1176 + 1, device=cuda)[1:].view(R, 1176)
    with pytest.raises(ValueError, match="8 bytes"):
        mag.magsplit_projector(xs[1][0].reshape(R, n_in), xs[1][1].reshape(R, n_in), wh, wcorr,
                               plan=plan, out=odd)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["magsplit", "matmul", "conv", "fft", "rfft"])
def test_fft_backends_on_card_match_cpu(cuda, backend):
    """Every FFT backend on the card against the same backend on the CPU
    (conv is a strided view and a product, not cuDNN, so no TF32).  The
    card's matmul and conv run B7 in three bf16 passes (JAX's
    ``Precision.HIGH`` on such a device) where the CPU runs f32, so they
    are held against B7's plain version on the same chunks instead, with
    one B7 launch per chunk."""
    dev = rt.ResamplerFft(2, 22050, 48000, backend=backend, device=cuda)
    cpu = rt.ResamplerFft(2, 22050, 48000, backend=backend, device="cpu")
    rng = np.random.default_rng(7)
    od = np.zeros(dev.chunk_size_output(), np.float32)
    oc = np.zeros_like(od)
    xs, outs = [], []
    before = kern.LAUNCHES["matmul3"]
    for _ in range(4):
        x = rng.standard_normal(dev.chunk_size_input()).astype(np.float32)
        dev.resample(x, od)
        if backend in ("matmul", "conv"):
            xs.append(torch.from_numpy(x.reshape(-1, 2).T.copy()))
            outs.append(od.reshape(-1, 2).T.copy())
        else:
            cpu.resample(x, oc)
            assert np.abs(od - oc).max() <= DEVICE_ATOL
    if backend in ("matmul", "conv"):
        ref = b7_fft_plain(backend, torch.stack(xs), dev.fft_size_input, dev.fft_size_output)
        assert np.abs(np.stack(outs) - ref.numpy()).max() <= KERNEL_ATOL
    assert kern.LAUNCHES["matmul3"] - before == (4 if backend in ("matmul", "conv") else 0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "in_hz,out_hz,taps,R,skew,starved,poison",
    [(44100, 44101, 128, 256, 1, False, False), (22050, 96000, 64, 128, 2, False, False),
     (48000, 44101, 128, 6, 1, False, False), (4_000_000_000, 4_000_000_001, 128, 128, 1, False, False),
     (44100, 44101, 128, 64, 1, True, False), (367500, 1601, 128, 128, 1, False, False),
     (44100, 44101, 16, 96, 1, False, False), (44100, 44101, 128, 64, 1, False, True)],
    ids=["near-unity", "upsample-skew2", "down-ragged-R6", "wide", "starved", "heavy-down-e", "taps16",
         "nan-inf-in-one-lane"],
)
def test_async_kernel_matches_plain_on_card(cuda, in_hz, out_hz, taps, R, skew, starved, poison):
    """B6 in both forms (the one L/M picks and the other) against its
    plain version on random residues and skews (past ``skew_periods`` when
    starved), at every ``n_out`` bound.  Poisoned: a NaN in one lane's
    ring and an Inf in another's make non-finite exactly the outputs whose
    window holds them; the rest agree with the plain version wherever it
    is finite (its banded einsum spreads them over their band: 0 x NaN)."""
    L, M = rt.types.reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=1, taps=taps, ratio_num=L, ratio_den=M)
    coeffs = tfir.fir_coefficients(
        taps, rt.Attenuation.Db90, tfir.fir_cutoff(taps, rt.Attenuation.Db90, in_hz / out_hz)
    )
    out_cap = min(cfg.out_capacity, 512 * M // L + 64)
    plan = b6.async_combine_plan(
        A=tfir.farrow_matrix(coeffs)[0], L=L, M=M, out_cap=out_cap, skew_periods=skew,
        clamp_j=cfg.input_capacity + 2 if cfg.wide else None,
    )
    rng = np.random.default_rng(8)
    host = rng.standard_normal((plan.reach + 9, R), dtype=np.float32)
    if poison:
        host[200, 5] = np.nan
        host[77, 9] = np.inf
    buf = torch.from_numpy(host).to(cuda)
    res = rng.integers(0, M, R)
    base_rel = rng.integers(0, skew + 1 + (5 if starved else 0), R)
    lanes = torch.from_numpy(np.stack([res, base_rel])).to(cuda)
    picked = plan.f32_tiles().form
    assert picked == ("outputs" if in_hz == 367500 else "positions")
    before = dict(kern.LAUNCHES)
    calls = 0
    for base0, n_out in ((0, out_cap), (9, out_cap // 2), (3, 1), (5, 0)):
        ref = b6.async_combine_reference(buf, base0, n_out, lanes, plan)
        for form in ("positions", "outputs"):
            got = b6.async_combine(buf, base0, n_out, lanes, plan, _form=form)
            calls += 1
            torch.cuda.synchronize()
            assert torch.all(got[n_out:] == 0)
            if not poison:
                assert (got - ref).abs().max().item() <= KERNEL_ATOL
                continue
            off = np.where((base_rel >= 1) & (base_rel <= skew), base_rel, 0)
            t = (res[None, :] + plan.s[:n_out, None]) & 0xFFFFFFFF
            first = base0 + plan.j[:n_out, None] + off[None, :] + ((t < res[None, :]) | (t >= M))
            bad = ~np.isfinite(host)
            holds = np.zeros((out_cap, R), bool)
            holds[:n_out] = bad[first[..., None] + np.arange(taps), np.arange(R)[None, :, None]].any(-1)
            g, r = got.cpu().numpy(), ref.cpu().numpy()
            assert np.array_equal(~np.isfinite(g), holds)
            fin = np.isfinite(r)
            assert n_out < 2 or (holds[:, 5].any() and holds[:, 9].any() and fin.any())
            assert np.abs(g[fin] - r[fin]).max() <= KERNEL_ATOL
    assert kern.LAUNCHES == dict(before, async_combine=before["async_combine"] + calls)
    with pytest.raises(IndexError):
        b6.async_combine(buf, 10, out_cap, lanes, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("in_hz,out_hz", [(44100, 44101), (600011, 600013)], ids=["narrow", "wide"])
def test_async_fleet_on_card_matches_cpu(cuda, in_hz, out_hz):
    """Card vs CPU on ragged feeds with NaN junk and a per-stream slew:
    ints, positions and ring exact, samples within the device gate,
    exactly one B6 launch per step and no other kernel."""
    M = rt.types.reduce_ratio(in_hz, out_hz)[1]
    kw = dict(synchronized=True, sync_variant="async_tm", max_chunk=512, horizon=2,
              initial_positions=[0, M // 3, M - 1])
    args = (3, 2, in_hz, out_hz, rt.Latency.Sample64, rt.Attenuation.Db90)
    dev = rt.BatchedResamplerFir(*args, device=cuda, **kw)
    cpu = rt.BatchedResamplerFir(*args, device="cpu", **kw)
    rng = np.random.default_rng(4)
    for name in kern.LAUNCHES:
        kern.LAUNCHES[name] = 0
    n_steps = 24
    for i in range(n_steps):
        nv = 512 if i % 2 else int(rng.integers(0, 513))
        chunks = rng.standard_normal((3, 512, 2), dtype=np.float32)
        chunks[:, nv:] = np.nan
        od, cd, pd, _ = dev.resample(chunks, np.full((3,), nv))
        oc, cc, pc, _ = cpu.resample(chunks, np.full((3,), nv))
        assert np.array_equal(cd, cc) and np.array_equal(pd, pc)
        assert (od.cpu() - oc).abs().max().item() <= DEVICE_ATOL
        if i == 9:
            assert np.array_equal(dev.slew([0.25, 0.0, -0.125]), cpu.slew([0.25, 0.0, -0.125]))
        for k, v in cpu.state.items():
            if k != "buffer":
                assert np.array_equal(dev.state[k], v), k
        assert torch.equal(dev.state["buffer"].cpu(), cpu.state["buffer"])
    assert kern.LAUNCHES == dict({k: 0 for k in kern.LAUNCHES}, async_combine=n_steps)


@pytest.mark.cuda
def test_async_streaming_fleet_on_card_matches_cpu(cuda):
    kw = dict(chunk_frames=256, synchronized="async", initial_positions=[0, 9999, 30000])
    args = (3, 2, 44100, 44101, rt.Latency.Sample32, rt.Attenuation.Db90)
    dev, cpu = rt.StreamingFleet(*args, device=cuda, **kw), rt.StreamingFleet(*args, device="cpu", **kw)
    rng = np.random.default_rng(5)
    for _ in range(6):
        for b in range(3):
            x = rng.standard_normal(2 * int(rng.integers(0, 512))).astype(np.float32)
            dev.push(b, x)
            cpu.push(b, x)
        for yd, yc in zip(dev.step(), cpu.step()):
            assert yd.shape == yc.shape and np.isfinite(yd).all()
            assert np.abs(yd - yc).max(initial=0.0) <= DEVICE_ATOL


def _step_case(in_hz, out_hz, taps, C):
    L, M = rt.types.reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    coeffs = tfir.fir_coefficients(
        taps, rt.Attenuation.Db90, tfir.fir_cutoff(taps, rt.Attenuation.Db90, in_hz / out_hz)
    )
    return cfg, b9.FleetStepPlan(cfg, coeffs)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "in_hz,out_hz,taps,B,C,form",
    [(44100, 48000, 128, 64, 2, None), (48000, 44100, 64, 5, 2, None),
     (48000, 96000, 64, 8, 2, None), (44100, 48000, 32, 3, 3, None),
     (44100, 48000, 32, 2, 8, None), (47952, 48000, 128, 40, 2, None),
     (44100, 48000, 128, 64, 2, "thread")],
    ids=["44k1-48k", "48k-44k1", "M2", "C3", "C8", "47952-48k", "44k1-48k-thread-form"],
)
def test_fleet_step_kernels_match_plain_on_card(cuda, in_hz, out_hz, taps, B, C, form):
    """B9 (per-stream schedules: ragged valid counts, 0 among them, NaN
    junk past them, diverged positions) and B8 (one shared schedule,
    channel-major and frames-major) against their plain version: counts
    exact, buffers bit-equal, outputs within 1e-5; one launch each.  Every
    case takes the band form; the last forces the per-output form."""
    cfg, plan = _step_case(in_hz, out_hz, taps, C)
    assert plan.form == "band"
    if form is not None:
        plan.form = form
    rng = np.random.default_rng(9)
    n = 1024
    buf = torch.from_numpy(rng.standard_normal((B, C, cfg.buffer_alloc), dtype=np.float32))
    buf[:, :, cfg.input_capacity:] = 0.0  # the zero slack of every state
    buf = buf.to(cuda)
    avail = rng.integers(2 * taps, cfg.input_capacity - n, B)
    pos = rng.integers(0, 3 * cfg.ratio_den, B)
    nv = rng.integers(0, n + 1, B)
    avail[0], nv[0], nv[-1] = 0, 0, n  # stream 0 emits nothing
    chunks = rng.standard_normal((B, n, C), dtype=np.float32)
    shared = chunks.copy()  # B8's feed: junk past the shared count nv[1]
    shared[:, nv[1]:] = np.nan
    chunks[np.arange(n)[None, :] >= nv[:, None]] = np.nan
    chunks, shared = torch.from_numpy(chunks).to(cuda), torch.from_numpy(shared).to(cuda)
    budget = np.full(B, cfg.out_capacity)
    before = dict(kern.LAUNCHES)
    got = b9.fir_fleet_step(plan, buf, chunks, avail, pos, nv, budget,
                            out_buffers=torch.zeros_like(buf))
    ref = b9.fir_fleet_step_reference(plan, buf, chunks, avail, pos, nv, budget)
    for cm in (False, True):
        feed = shared.transpose(1, 2).contiguous() if cm else shared
        got_s = b8.fir_fleet_step_sync(plan, buf, feed, int(avail[1]), int(pos[1]), int(nv[1]),
                                       channel_major=cm)
        ref_s = b8.fir_fleet_step_sync_reference(plan, buf, feed, int(avail[1]), int(pos[1]),
                                                 int(nv[1]), channel_major=cm)
        torch.cuda.synchronize()
        assert got_s[2:] == ref_s[2:] and got_s[5] > 0
        assert torch.equal(got_s[0], ref_s[0])
        assert (got_s[1] - ref_s[1]).abs().max().item() <= KERNEL_ATOL
    torch.cuda.synchronize()
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(g, r)
    assert torch.equal(got[0], ref[0]) and torch.isfinite(got[1]).all()
    assert (got[1] - ref[1]).abs().max().item() <= KERNEL_ATOL
    assert (got[5] == 0).any() and (got[5] > 0).any()
    assert kern.LAUNCHES == dict(before, fir_fleet_step=before["fir_fleet_step"] + 1,
                                 fir_fleet_step_sync=before["fir_fleet_step_sync"] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "in_hz,out_hz,kwargs",
    [(44100, 48000, {}), (44100, 44101, {}), (600011, 600013, {}),
     (44100, 48000, dict(synchronized=True, sync_variant="slide"))],
    ids=["vmapped-periodic", "vmapped-farrow", "vmapped-wide", "slide"],
)
def test_end_aligned_fleets_on_card_match_cpu(cuda, in_hz, out_hz, kwargs):
    """Card vs CPU on ragged feeds with NaN junk: ints and states equal,
    buffers bit-equal, samples within the device gate; one B9 (vmapped,
    periodic) or B8 (slide) launch per step, no kernel on coprime pairs."""
    args = (3, 2, in_hz, out_hz, rt.Latency.Sample64, rt.Attenuation.Db90)
    dev = rt.BatchedResamplerFir(*args, device=cuda, **kwargs)
    cpu = rt.BatchedResamplerFir(*args, device="cpu", **kwargs)
    rng = np.random.default_rng(10)
    for name in kern.LAUNCHES:
        kern.LAUNCHES[name] = 0
    n_steps = 16
    for i in range(n_steps):
        nv = rng.integers(0, 1025, 3)
        nv[i % 3] = 1024
        chunks = rng.standard_normal((3, 1024, 2), dtype=np.float32)
        chunks[np.arange(1024)[None, :] >= nv[:, None]] = np.nan
        od, cd, pd, _ = dev.resample(chunks, nv)
        oc, cc, pc, _ = cpu.resample(chunks, nv)
        assert np.array_equal(cd, cc) and np.array_equal(pd, pc)
        assert (od.cpu() - oc).abs().max().item() <= DEVICE_ATOL
        if i == 7:
            s = 0.25 if kwargs else [0.25, -0.5, 1.0]
            assert np.array_equal(dev.slew(s), cpu.slew(s))
        for k, v in cpu.state.items():
            if k != "buffer":
                assert np.array_equal(dev.state[k], v), k
        assert torch.equal(dev.state["buffer"].cpu(), cpu.state["buffer"])
    want = dict({k: 0 for k in kern.LAUNCHES})
    if kwargs:
        want["fir_fleet_step_sync"] = n_steps
    elif in_hz == 44100 and out_hz == 48000:
        want["fir_fleet_step"] = n_steps
    assert kern.LAUNCHES == want


@pytest.mark.cuda
def test_vmapped_streaming_fleet_on_card_matches_cpu(cuda):
    args = (4, 2, 44100, 48000, rt.Latency.Sample32, rt.Attenuation.Db90)
    dev = rt.StreamingFleet(*args, chunk_frames=512, device=cuda)
    cpu = rt.StreamingFleet(*args, chunk_frames=512, device="cpu")
    rng = np.random.default_rng(11)
    for _ in range(6):
        for b in range(4):
            x = rng.standard_normal(2 * int(rng.integers(0, 1024))).astype(np.float32)
            dev.push(b, x)
            cpu.push(b, x)
        for yd, yc in zip(dev.step(), cpu.step()):
            assert yd.shape == yc.shape and np.isfinite(yd).all()
            assert np.abs(yd - yc).max(initial=0.0) <= DEVICE_ATOL


def _fetch_pageable(out):
    """``StreamingFleet``'s fetch into a fresh pageable host array."""
    return torch.as_tensor(out).cpu().numpy()


@pytest.mark.cuda
def test_streaming_fleet_fetches_into_one_pinned_buffer_on_card(cuda):
    """The vmapped ``StreamingFleet`` on the card fetches every step's
    output into one pinned host buffer: its outputs are bit for bit those
    of the pageable fetch and within ``DEVICE_ATOL`` of the CPU fleet's,
    and the next step's fetch leaves the arrays of earlier steps as they
    were."""
    args = (4, 2, 44100, 48000, rt.Latency.Sample32, rt.Attenuation.Db90)
    dev = rt.StreamingFleet(*args, chunk_frames=512, device=cuda)
    plain = rt.StreamingFleet(*args, chunk_frames=512, device=cuda)
    plain._fetch = _fetch_pageable
    cpu = rt.StreamingFleet(*args, chunk_frames=512, device="cpu")
    rng = np.random.default_rng(13)
    reuses = tracing.counters()["runtime.fetch_reuses"]
    n_steps, buffers, held = 6, set(), []
    for _ in range(n_steps):
        for b in range(4):
            x = rng.standard_normal(2 * int(rng.integers(0, 1024))).astype(np.float32)
            for fleet in (dev, plain, cpu):
                fleet.push(b, x)
        outs = dev.step()
        for yd, yp, yc in zip(outs, plain.step(), cpu.step()):
            assert yd.shape == yp.shape == yc.shape
            np.testing.assert_array_equal(yd.view(np.uint32), yp.view(np.uint32))
            assert np.abs(yd - yc).max(initial=0.0) <= DEVICE_ATOL
        buffers.add(id(dev._fetch_buffer))
        fetched = dev._fetch_buffer.numpy()
        assert not any(np.shares_memory(o, fetched) for o in outs)
        for prev, kept in held:
            for p, k in zip(prev, kept):
                np.testing.assert_array_equal(p.view(np.uint32), k.view(np.uint32))
        held.append((outs, [o.copy() for o in outs]))
    assert sum(o.size for outs, _ in held for o in outs) > 0
    assert dev._fetch_buffer.is_pinned() and len(buffers) == 1
    assert tracing.counters()["runtime.fetch_reuses"] - reuses == n_steps - len(buffers)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["projector", "tm-window", "tm-atlas-77", "tm-atlas-159", "conv", "ragged"])
def test_matmul3_matches_plain_on_card(cuda, case):
    """B7 against its plain version: the FFT projector (three passes), the
    tm fleet's overlapping ring window with a time-major output view (four
    passes; a contiguous weight, and windows of the fleet's padded split
    atlas at columns 77 and M-1, whose bases are not 16-byte aligned), the
    conv backend's windows at a 147-float offset with the ``[R, g, M']``
    output as ``[g, R, M']``, and a ragged strided shape with NaN and Inf
    rows (a weight of 194-byte rows, which the wrapper copies)."""
    rng = np.random.default_rng(9)
    t_hi = t_lo = None
    if case == "projector":
        T = tfft.get_projection_matrix(1176, 1280)
        x = torch.from_numpy(rng.standard_normal((2, 333, 1176), dtype=np.float32)).to(cuda)
        passes, out = 3, None
    elif case.startswith("tm-"):
        L, M, taps, R = 147, 160, 128, 256
        span, K = L + taps + 1, 28
        ring = torch.from_numpy(rng.standard_normal((K * L + span + 5, R), dtype=np.float32)).to(cuda)
        x = ring[3:].as_strided((K, R, span), (L * R, 1, R))
        passes = 4
        out = torch.empty((K, M, R), device=cuda).permute(0, 2, 1)
        if case == "tm-window":
            T = 0.1 * rng.standard_normal((span, M)).astype(np.float32)
        else:
            cfg = tfir.FirConfig(channels=1, taps=taps, ratio_num=L, ratio_den=M)
            coeffs = tfir.fir_coefficients(
                taps, rt.Attenuation.Db90, tfir.fir_cutoff(taps, rt.Attenuation.Db90, L / M))
            a_hi, a_lo = fir_fleets._split_atlas_t(_sync_atlas(cfg, coeffs), cuda)
            i0 = int(case.rsplit("-", 1)[1])
            c0 = (i0 * L) // M
            t_hi, t_lo = (fir_fleets._atlas_window(a, c0, i0, span, M) for a in (a_hi, a_lo))
    elif case == "conv":
        g, lp, mp, R = 8, 147, 160, 300
        x2 = torch.from_numpy(rng.standard_normal((R, 2 * 1176), dtype=np.float32)).to(cuda)
        x = x2.as_strided((g, R, (g + 1) * lp), (lp, 2 * 1176, 1))
        T = np.ascontiguousarray(tfft.input_domain_conv_operator(1176, 1280).reshape((g + 1) * lp, mp))
        passes = 3
        out = torch.empty((R, g, mp), device=cuda).permute(1, 0, 2)
    else:
        big = torch.from_numpy(rng.standard_normal((3, 77, 301), dtype=np.float32)).to(cuda)
        x = big[:, 5:, 7:300]  # [3, 72, 293], rows and columns off any tile size
        x[1, 9, 4] = float("nan")
        x[2, 70, 0] = float("inf")
        T = rng.standard_normal((293, 97)).astype(np.float32) / 17
        passes, out = 3, None
    if t_hi is None:
        t_hi, t_lo = (h.to(cuda) for h in m3.split_weight(torch.from_numpy(T)))
    before = kern.LAUNCHES["matmul3"]
    got = m3.matmul3(x, t_hi, t_lo, passes=passes, out=out)
    ref = m3.matmul3_reference(x, t_hi, t_lo, passes=passes)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["matmul3"] == before + 1
    assert out is None or got is out
    assert torch.equal(torch.isfinite(got), torch.isfinite(ref))
    fin = torch.isfinite(ref)
    assert (got[fin] - ref[fin]).abs().max().item() <= KERNEL_ATOL
    if case == "ragged":
        assert not fin[1, 9].any() and not fin[2, 70].any() and fin.sum() == fin.numel() - 2 * 97
    else:
        assert bool(fin.all())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "in_hz,out_hz,R,skew,starved",
    [(44100, 44101, 256, 1, False), (4_000_000_000, 4_000_000_001, 128, 1, False), (48000, 44101, 6, 1, False),
     (367500, 1601, 128, 1, False), (22050, 96000, 128, 2, False), (44100, 44101, 128, 1, True)],
    ids=["a", "d-wide", "c-ragged-R6", "e-disjoint-windows", "b-skew2", "g-starved"],
)
def test_async_bf16x4_kernel_matches_plain_on_card(cuda, in_hz, out_hz, R, skew, starved):
    """B6b against its plain version at every ``n_out`` bound; a starved
    state's frame skew past ``skew_periods`` reads offset 0."""
    L, M = rt.types.reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=1, taps=128, ratio_num=L, ratio_den=M)
    coeffs = tfir.fir_coefficients(
        128, rt.Attenuation.Db90, tfir.fir_cutoff(128, rt.Attenuation.Db90, in_hz / out_hz)
    )
    out_cap = min(cfg.out_capacity, 512 * M // L + 64)
    plan = b6.async_combine_plan(
        A=tfir.farrow_matrix(coeffs)[0], L=L, M=M, out_cap=out_cap, skew_periods=skew,
        clamp_j=cfg.input_capacity + 2 if cfg.wide else None, precision="bf16x4",
    )
    rng = np.random.default_rng(10)
    buf = torch.from_numpy(rng.standard_normal((plan.reach + 9, R), dtype=np.float32)).to(cuda)
    base_rel = rng.integers(0, skew + 1 + (6 if starved else 0), R)
    assert (base_rel.max() > skew) == starved
    lanes = torch.from_numpy(np.stack([rng.integers(0, M, R), base_rel])).to(cuda)
    before = dict(kern.LAUNCHES)
    for base0, n_out in ((0, out_cap), (9, out_cap // 2), (3, 1), (5, 0)):
        got = b6.async_combine(buf, base0, n_out, lanes, plan)
        ref = b6.async_combine_reference(buf, base0, n_out, lanes, plan)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() <= KERNEL_ATOL
        assert torch.all(got[n_out:] == 0)
    assert kern.LAUNCHES == dict(before, async_combine_bf16x4=before["async_combine_bf16x4"] + 4)


@pytest.mark.cuda
def test_bf16x4_tm_fleet_on_card(cuda):
    """The bf16x4 tm fleet on the card: one B7 launch per emitting step and
    no B1, ints and ring equal to the CPU's bf16x4 fleet (B7's plain
    version) and the outputs within the kernel tolerance of it, and within
    ``BF16X4_VS_F32_ATOL`` of the card's f32 fleet on the same feed."""
    L, M = rt.types.reduce_ratio(44100, 48000)
    cfg = tfir.FirConfig(channels=2, taps=128, ratio_num=L, ratio_den=M)
    coeffs = tfir.fir_coefficients(
        128, rt.Attenuation.Db90, tfir.fir_cutoff(128, rt.Attenuation.Db90, 44100 / 48000)
    )
    kw = dict(max_chunk=512, horizon=2, out_layout="tm")
    B = 8
    fleets = {
        name: (
            fir_fleets.make_fir_fleet_step_sync_tm(cfg, coeffs, B, precision=p, device=d, **kw),
            fir_fleets.fir_fleet_init_sync_tm(cfg, B, max_chunk=512, horizon=2, device=d),
        )
        for name, p, d in (("bf16x4", "bf16x4", cuda), ("cpu", "bf16x4", "cpu"), ("f32", "highest", cuda))
    }
    rng = np.random.default_rng(11)
    for name in kern.LAUNCHES:
        kern.LAUNCHES[name] = 0
    err_cpu = err_f32 = 0.0
    emitting = 0
    for i in range(24):
        nv = 512 if i % 3 else int(rng.integers(0, 513))
        chunk = rng.standard_normal((512, B * 2), dtype=np.float32)
        chunk[nv:] = np.nan
        outs = {}
        for name, (step, state) in fleets.items():
            dev = torch.device("cpu") if name == "cpu" else cuda
            state, out, c, p = step(state, torch.from_numpy(chunk).to(dev), nv)
            fleets[name] = (step, state)
            outs[name] = (out.cpu(), c, p)
        assert outs["bf16x4"][1:] == outs["cpu"][1:] == outs["f32"][1:]
        emitting += outs["bf16x4"][2] > 0
        err_cpu = max(err_cpu, (outs["bf16x4"][0] - outs["cpu"][0]).abs().max().item())
        err_f32 = max(err_f32, (outs["bf16x4"][0] - outs["f32"][0]).abs().max().item())
        sd, sc = fleets["bf16x4"][1], fleets["cpu"][1]
        assert torch.equal(sd["buffer"].cpu(), sc["buffer"])
        assert all(sd[k] == sc[k] for k in sc if k != "buffer")
    assert err_cpu <= KERNEL_ATOL and 0 < err_f32 <= BF16X4_VS_F32_ATOL
    assert kern.LAUNCHES == dict(kern.LAUNCHES, matmul3=emitting, dma_banded_contract=emitting)


@pytest.mark.cuda
def test_fft_matmul_fleet_on_card_through_b7(cuda):
    """``BatchedResamplerFft(backend="matmul")`` on the card: one B7 launch
    per ``resample`` and per chunk of ``resample_many``, outputs within the
    kernel tolerance of B7's plain version on the same chunks."""
    B, C = 3, 2
    dev = rt.BatchedResamplerFft(B, C, 44100, 48000, backend="matmul", device=cuda)
    n_in, n_out = dev.config.fft_size_input, dev.config.fft_size_output
    rng = np.random.default_rng(12)
    xs = rng.standard_normal((7, B, C, n_in), dtype=np.float32)
    for name in kern.LAUNCHES:
        kern.LAUNCHES[name] = 0
    got = [dev.resample(xs[t]).cpu() for t in range(3)]
    got = torch.cat([torch.stack(got), dev.resample_many(torch.from_numpy(xs[3:]).to(cuda)).cpu()])
    assert kern.LAUNCHES == dict({k: 0 for k in kern.LAUNCHES}, matmul3=7)
    ref = b7_fft_plain("matmul", torch.from_numpy(xs).reshape(7, B * C, n_in), n_in, n_out)
    assert (got.reshape(7, B * C, n_out) - ref).abs().max().item() <= KERNEL_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("in_hz,out_hz,kname", [(44100, 48000, "dma_banded_contract"),
                                                (44100, 44101, "dma_farrow_contract")])
def test_tm_contraction_keyword_on_card(cuda, in_hz, out_hz, kname):
    """The tm step's ``contraction=`` on the card: ``"dma"`` launches the f32
    kernel (B1, B2 with the weights kernel before it) whatever the
    precision, ``"xla"`` and ``"dma_interpret"`` run the plain versions on
    the card's tensors (no launch); the same ints, and samples within the
    kernel tolerance of ``"dma"``."""
    L, M = rt.types.reduce_ratio(in_hz, out_hz)
    cfg = tfir.FirConfig(channels=2, taps=64, ratio_num=L, ratio_den=M)
    coeffs = tfir.fir_coefficients(64, rt.Attenuation.Db90, tfir.fir_cutoff(64, rt.Attenuation.Db90, in_hz / out_hz))
    kw = dict(max_chunk=512, horizon=3, out_layout="tm", device=cuda)
    B = 4
    fleets = {
        name: (fir_fleets.make_fir_fleet_step_sync_tm(cfg, coeffs, B, precision="bf16x4", contraction=name, **kw),
               fir_fleets.fir_fleet_init_sync_tm(cfg, B, max_chunk=512, horizon=3, device=cuda))
        for name in ("dma", "xla", "dma_interpret")
    }
    rng = np.random.default_rng(13)
    launched = 0
    kinds = {kname, "farrow_weights"} if kname == "dma_farrow_contract" else {kname}
    for _ in range(6):
        chunk = torch.from_numpy(rng.standard_normal((512, B * 2), dtype=np.float32)).to(cuda)
        outs = {}
        for name, (step, state) in fleets.items():
            before = dict(kern.LAUNCHES)
            state, out, c, p = step(state, chunk, 512)
            fleets[name] = (step, state)
            outs[name] = (out, c, p)
            grew = {k for k in kern.LAUNCHES if kern.LAUNCHES[k] != before[k]}
            assert grew == (kinds if name == "dma" and p else set())
            launched += name == "dma" and p > 0
        torch.cuda.synchronize()
        assert outs["dma"][1:] == outs["xla"][1:] == outs["dma_interpret"][1:]
        p = outs["dma"][2]
        for name in ("xla", "dma_interpret"):
            assert (outs[name][0][:p] - outs["dma"][0][:p]).abs().max().item() <= (
                BF16X4_VS_F32_ATOL if name == "xla" and kname == "dma_banded_contract" else KERNEL_ATOL)
    assert launched >= 4
