"""Tests that need an NVIDIA card: kernel B1 and the fleet on the card
against the port's plain PyTorch versions on the same inputs.  They skip
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
from resampler_tpu_torch.engine.fir_fleets import _sync_atlas
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
    before = kern.LAUNCHES
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
    assert kern.LAUNCHES == before + n
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
    before = kern.LAUNCHES
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
    assert kern.LAUNCHES == before + produced_steps
