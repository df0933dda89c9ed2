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


#: ``fir.fused_epilogue / fir.steps`` by fleet on the card: the tm fleet
#: alone fuses (on the CPU every fleet reads 0)
SHARES = {"tm": 1, "tm-layout-tm": 0, "coprime": 0, "async": 0, "vmapped": 0}


@pytest.mark.parametrize(
    "dev,fleet",
    [("cpu", name) for name in SHARES]
    + [pytest.param("cuda", name, marks=pytest.mark.cuda) for name in SHARES],
)
def test_fused_epilogue_share(request, dev, fleet):
    """The share of steps the fused epilogue served: 1 on the tm periodic
    fleet with ``"bm"`` outputs on the card, 0 for ``out_layout="tm"``, the
    coprime tm fleet, the async fleet and the vmapped fleet, and 0 for
    every fleet on the CPU."""
    device = torch.device("cpu") if dev == "cpu" else request.getfixturevalue("cuda")
    B, C, n, steps = 4, 2, 512, 5
    out_hz = 44101 if fleet == "coprime" else 48000
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
              "async": dict(synchronized=True, sync_variant="async_tm"), "vmapped": {}}[fleet]
        f = rt.BatchedResamplerFir(B, C, 44100, out_hz, rt.Latency.Sample64, rt.Attenuation.Db90,
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


@pytest.mark.cuda
def test_farrow_contract_span_launches_b2_alone(cuda):
    """The farrow tm step under the profiler on the card: the device work
    launched in ``fir.contract`` outside ``fir.weights`` is kernel B2
    (``tiled_contract_kernel``), once a step; ``fir.weights`` launches the
    weights' work; no B1, B3 or B6 runs; ``fir.farrow_steps / fir.steps``
    is 1."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import spans, trace

    B, C, n, steps = 8, 2, 4096, 4
    fleet = rt.BatchedResamplerFir(B, C, 44100, 44101, rt.Latency.Sample64, rt.Attenuation.Db90,
                                   synchronized=True, max_chunk=n, device=cuda)
    x = torch.rand((B, n, C), device=cuda) * 2 - 1
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
    by_stage = {}
    for (ls, _), (_, name, _) in zip(launches, work):
        by_stage.setdefault(spans.innermost(every, ls), []).append(name)
    assert len(by_stage["fir.contract"]) == steps
    assert all("tiled_contract_kernel" in name for name in by_stage["fir.contract"])
    assert len(by_stage["fir.weights"]) >= steps
    others = ("band_contract_kernel", "farrow_packed_kernel", "combine_kernel")
    assert not any(o in name for name, _, _ in tr.device for o in others)
    c = tracing.counters()
    assert c["fir.farrow_steps"] == c["fir.steps"] == steps


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
    kernel (B1, B2) whatever the precision, ``"xla"`` and ``"dma_interpret"``
    run the plain versions on the card's tensors (no launch); the same ints,
    and samples within the kernel tolerance of ``"dma"``."""
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
    for _ in range(6):
        chunk = torch.from_numpy(rng.standard_normal((512, B * 2), dtype=np.float32)).to(cuda)
        outs = {}
        for name, (step, state) in fleets.items():
            before = dict(kern.LAUNCHES)
            state, out, c, p = step(state, chunk, 512)
            fleets[name] = (step, state)
            outs[name] = (out, c, p)
            grew = {k for k in kern.LAUNCHES if kern.LAUNCHES[k] != before[k]}
            assert grew == ({kname} if name == "dma" and p else set())
            launched += name == "dma" and p > 0
        torch.cuda.synchronize()
        assert outs["dma"][1:] == outs["xla"][1:] == outs["dma_interpret"][1:]
        p = outs["dma"][2]
        for name in ("xla", "dma_interpret"):
            assert (outs[name][0][:p] - outs["dma"][0][:p]).abs().max().item() <= (
                BF16X4_VS_F32_ATOL if name == "xla" and kname == "dma_banded_contract" else KERNEL_ATOL)
    assert launched >= 4
