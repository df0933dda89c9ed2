"""Tests that need an NVIDIA card: kernels B1-B3 and the fleet (periodic
and coprime) on the card against the port's plain PyTorch versions and
the CPU on the same inputs.  They skip
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
from resampler_tpu_torch.engine import fir as tfir
from resampler_tpu_torch.engine.fir_fleets import _farrow_tm_plan, _sync_atlas
from resampler_tpu_torch.ops import fir_dma_kernel as kern

KERNEL_ATOL = 1e-5  # f32 sums in another order
DEVICE_ATOL = 5e-5  # bench.py's device-vs-CPU gate


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
