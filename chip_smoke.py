#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``resampler_tpu_torch``).

Drives the port's FIR serving path on one NVIDIA card and holds it
against the port's plain PyTorch versions.  Run from the repository root
on a machine with one CUDA GPU, nvcc and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device and precision: a CUDA card, both TF32 flags off, the card's
   name and power limit from nvidia-smi;
2. build kernel B1 (csrc/fir_banded_contract.cu) with nvcc for sm_90a;
3. kernel B1 against its plain version on the card at the main path's
   shapes (plus a grouped small-M shape and a ragged fleet), timed with
   CUDA events;
4. the main path at full width: 1024 stereo streams, 44.1 -> 48 kHz,
   Latency.Sample64 / Attenuation.Db90, max_chunk 4096, horizon 16:
   40 ``resample`` calls and one ``resample_many`` of T = 8; every step
   must launch the kernel, the schedule must be exact, and streams 0-3
   must match a CPU fleet;
5. card against CPU: a 3-stream stereo fleet, 36 steps, ragged feeds
   with NaN junk past the valid frames: ints equal, ring bit-equal,
   samples within 5e-5;
6. alias rejection through the kernel (48 -> 44.1 kHz, 23 kHz tone)
   >= 100 dB;
7. the per-stream ``ResamplerFir.process`` on the card against the CPU.

It prints the kernels' JSON line, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from resampler_tpu_torch import Attenuation, BatchedResamplerFir, Latency, ResamplerFir
from resampler_tpu_torch.engine import fir_fleets
from resampler_tpu_torch.engine.fir import (
    FirConfig,
    _periodic_group_factor,
    fir_coefficients,
    fir_cutoff,
)
from resampler_tpu_torch.ops import fir_dma_kernel as kern
from resampler_tpu_torch.types import reduce_ratio

#: kernel vs plain: f32 sums in another order (the JAX suite's own
#: dma-vs-xla tolerance, tests/test_pallas.py)
KERNEL_ATOL = 1e-5
#: card vs CPU on fleet outputs: bench.py's device-vs-CPU quality gate
DEVICE_ATOL = 5e-5
#: f32 CUDA-core peak of an H100 SXM (data sheet), for the roofline share
F32_PEAK_TFLOPS = 67.0


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {what}")


def elapsed_ms(fn, reps: int, device: torch.device) -> float:
    """Mean milliseconds per call of ``fn(i)`` over ``reps`` calls: CUDA
    events on the card, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for i in range(reps):
            fn(i)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    return (time.perf_counter() - t0) * 1e3 / reps


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


# --------------------------------------------------------------------------
# phases 1-2: device, precision, build
# --------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(
        not torch.backends.cuda.matmul.allow_tf32
        and not torch.backends.cudnn.allow_tf32,
        "TF32 flags off",
    )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} visible device(s); TF32 off")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    kern.build()
    print(f"[2] built kernel B1 with nvcc (sm_90a) in {time.perf_counter() - t0:.2f} s")
    for line in kern.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")


# --------------------------------------------------------------------------
# phase 3: kernel vs plain version at the main path's shapes
# --------------------------------------------------------------------------


def kernel_case(in_hz, out_hz, taps, lanes, max_chunk, horizon, device, seed):
    """The ring, atlas window and geometry ``make_fir_fleet_step_sync_tm``
    hands the kernel for one fleet configuration."""
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = FirConfig(channels=1, taps=taps, ratio_num=L, ratio_den=M)
    g = _periodic_group_factor(L, M)
    Lg, Mg = L * g, M * g
    span = Lg + taps + 1
    K = -(-cfg.out_capacity // Mg)
    ring = fir_fleets._ring_rows(cfg, max_chunk, horizon)
    coeffs = fir_coefficients(taps, Attenuation.Db90, fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz))
    a2 = fir_fleets._sync_atlas(
        dataclasses.replace(cfg, ratio_num=Lg, ratio_den=Mg) if g > 1 else cfg, coeffs
    )
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(
        rng.standard_normal((ring, lanes), dtype=np.float32)
    ).to(device)
    atlases = []
    for i0 in (0, int(rng.integers(1, M)) if M > 1 else 0, M - 1):
        c0 = (i0 * L) // M
        atlases.append(torch.from_numpy(np.ascontiguousarray(a2[i0 : i0 + Mg, c0 : c0 + span])).to(device))
    top = ring - ((K - 1) * Lg + span)
    # odd bases, one in the ring's middle, and the top bound
    bases = [1, 3, 4097, 2 * (ring // 4) + 1, top]
    geo = dict(L=Lg, M=Mg, span=span, K=K)
    return buf, atlases, bases, geo


def phase_kernel(device, cases, reps=20):
    """Max |kernel - plain| over every case, atlas window and base, and
    each case's time per call (kernel and plain, in turns); returns the
    worst error and the first (main-path) case's times."""
    worst = 0.0
    timing = None
    for n, (name, args) in enumerate(cases):
        buf, atlases, bases, geo = kernel_case(*args, device=device, seed=n)
        err = 0.0
        for a in atlases:
            for base in bases:
                got = kern.dma_banded_contract(buf, base, a, **geo)
                ref = kern.dma_banded_contract_reference(buf, base, a, **geo)
                err = max(err, float((got - ref).abs().max()))
        sync(device)
        check(err <= KERNEL_ATOL, f"kernel vs plain {name}: {err:.3e} > {KERNEL_ATOL}")
        worst = max(worst, err)
        ring, R = buf.shape
        print(f"[3] {name}: ring [{ring}, {R}] {geo}: max |kernel - plain| = {err:.3e} "
              f"over {len(atlases) * len(bases)} calls")
        a = atlases[1]
        # rotate bases over the ring so successive calls do not find their
        # rows in L2 (the 50 MB L2 would hold one full-width window)
        rot = np.linspace(0, bases[-1], 8).astype(int).tolist()

        def k(i):
            kern.dma_banded_contract(buf, rot[i % 8], a, **geo)

        def p(i):
            kern.dma_banded_contract_reference(buf, rot[i % 8], a, **geo)

        for fn in (k, p):
            fn(0)
        # plain, kernel, kernel, plain
        t = [elapsed_ms(fn, reps, device) for fn in (p, k, k, p)]
        ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        flop = 2 * geo["K"] * geo["M"] * geo["span"] * R
        if timing is None:
            timing = dict(ms=ms, plain_ms=plain_ms)
        print(f"    timing: kernel {t[1]:.4f} / {t[2]:.4f} ms, plain {t[0]:.4f} / {t[3]:.4f} ms "
              f"per call; kernel {flop / ms / 1e9:.2f} TFLOP/s "
              f"({100 * flop / ms / 1e9 / F32_PEAK_TFLOPS:.1f}% of the f32 peak), "
              f"plain {flop / plain_ms / 1e9:.2f} TFLOP/s")
        del buf, atlases
    return worst, timing


# --------------------------------------------------------------------------
# phase 4: the main path at full width
# --------------------------------------------------------------------------


def expected_schedule(cfg: FirConfig, n_valids):
    """The exact shared schedule, as plain integer arithmetic:
    ``(to_copy, n_out)`` per step."""
    L, M, cap, taps, out_cap = (
        cfg.ratio_num, cfg.ratio_den, cfg.input_capacity, cfg.taps, cfg.out_capacity
    )
    avail = pos = 0
    for nv in n_valids:
        to_copy = min(nv, cap - avail)
        avail += to_copy
        limit = (avail - taps + 1) * M - pos
        n_out = min(-(-limit // L) if limit > 0 else 0, out_cap)
        pos += n_out * L
        consumed = min(pos // M, avail)
        avail -= consumed
        pos -= consumed * M
        yield to_copy, n_out


def phase_main_path(device, smi, B=1024, C=2, max_chunk=4096, horizon=16,
                    n_steps=40, T=8, nbuf=8, mirror=4, warm=8, latency=Latency.Sample64):
    kw = dict(synchronized=True, max_chunk=max_chunk, horizon=horizon)
    fleet = BatchedResamplerFir(B, C, 44100, 48000, latency, Attenuation.Db90, device=device, **kw)
    rng = np.random.default_rng(7)
    chunks_np = [rng.standard_normal((B, max_chunk, C), dtype=np.float32) for _ in range(nbuf)]
    chunks = [torch.from_numpy(c).to(device) for c in chunks_np]
    many = torch.stack([chunks[(n_steps + t) % nbuf] for t in range(T)])
    sync(device)

    kern.LAUNCHES = 0  # count only the main path's own launches
    small, steps, fills, peaks = [], [], [], []
    t0 = time.perf_counter()
    for i in range(n_steps):
        if i == warm:
            sync(device)  # the first steps grow the device allocator
            t_warm = time.perf_counter()
        out, c, p, peak = fleet.resample(chunks[i % nbuf])
        small.append(out[:mirror].clone())
        steps.append((int(c[0]), int(p[0])))
        fills.append(fleet.state["fill"])
        peaks.append(peak)
    sync(device)
    t_end = time.perf_counter()
    dt, dt_warm = t_end - t0, t_end - t_warm
    t1 = time.perf_counter()
    outs, cs, ps, peak_many = fleet.resample_many(many)
    sync(device)
    dt_many = time.perf_counter() - t1
    launches = kern.LAUNCHES

    steps += list(zip(cs.tolist(), ps.tolist()))
    total = n_steps + T
    want = list(expected_schedule(fleet.config, [max_chunk] * total))
    check(steps == want, "consumed/produced follow the exact schedule")
    check(all(p > 0 for _, p in steps), "every step emits")
    check(launches == total, f"kernel launches {launches} == steps {total}")
    compactions = sum(b < a for a, b in zip(fills, fills[1:]))
    check(compactions >= 2, f"{compactions} compactions >= 2")
    out_cap = fleet.config.out_capacity
    check(tuple(out.shape) == (B, out_cap, C) and tuple(outs.shape) == (T, B, out_cap, C), "output shapes")
    check(bool(torch.isfinite(torch.stack(peaks)).all()) and bool(torch.isfinite(outs).all()), "finite outputs")
    check(float(peak_many) > 0, "nonzero output")

    # streams are independent: streams 0..mirror-1 equal a CPU fleet of
    # just those streams, fed the same frames
    cpu = BatchedResamplerFir(mirror, C, 44100, 48000, latency, Attenuation.Db90, device="cpu", **kw)
    err = 0.0
    for i in range(total):
        ref, c, p, _ = cpu.resample(chunks_np[i % nbuf][:mirror])
        check((int(c[0]), int(p[0])) == steps[i], f"CPU mirror schedule at step {i}")
        got = small[i] if i < n_steps else outs[i - n_steps, :mirror]
        err = max(err, float((got.cpu() - ref).abs().max()))
    check(err <= DEVICE_ATOL, f"main path vs CPU mirror: {err:.3e} > {DEVICE_ATOL}")

    def rate(step_slice, seconds):
        return sum(p for _, p in step_slice) * B / seconds / 1e6

    print(f"[4] main path: {B} streams x {C} ch, 44.1 -> 48 kHz taps {latency.taps}, "
          f"{total} steps ({compactions} compactions), {launches} kernel launches; "
          f"streams 0-{mirror - 1} vs CPU fleet max err {err:.3e}")
    print(f"    fleet: {rate(steps[warm:n_steps], dt_warm):.1f} Msamples/s over resample() calls "
          f"{warm + 1}-{n_steps} ({dt_warm * 1e3 / (n_steps - warm):.3f} ms/step); all {n_steps} "
          f"calls incl. allocator warm-up {rate(steps[:n_steps], dt):.1f} Msamples/s; first "
          f"resample_many(T={T}) {rate(steps[n_steps:], dt_many):.1f} Msamples/s "
          f"[output frames x streams per second; card: {smi}]")
    if device.type == "cuda":
        print(f"    peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


# --------------------------------------------------------------------------
# phase 5: card vs CPU differential
# --------------------------------------------------------------------------


def phase_differential(device, B=3, C=2, max_chunk=512, horizon=3, n_steps=36):
    kw = dict(synchronized=True, max_chunk=max_chunk, horizon=horizon)
    dev = BatchedResamplerFir(B, C, 44100, 48000, Latency.Sample64, Attenuation.Db90, device=device, **kw)
    cpu = BatchedResamplerFir(B, C, 44100, 48000, Latency.Sample64, Attenuation.Db90, device="cpu", **kw)
    rng = np.random.default_rng(11)
    err = 0.0
    fills = []
    for i in range(n_steps):
        nv = max_chunk if i % 3 == 0 else int(rng.integers(0, max_chunk + 1))
        chunks = rng.standard_normal((B, max_chunk, C), dtype=np.float32)
        chunks[:, nv:] = np.nan  # the NaN fence keeps junk out of the ring
        od, cd, pd, kd = dev.resample(chunks, np.full((B,), nv))
        oc, cc, pc, kc = cpu.resample(chunks, np.full((B,), nv))
        check(np.array_equal(cd, cc) and np.array_equal(pd, pc), f"ints at step {i}")
        err = max(err, float((od.cpu() - oc).abs().max()), abs(float(kd) - float(kc)))
        if i == 10:
            check(dev.slew(0.3) == cpu.slew(0.3), "slew")
        sd, sc = dev.state, cpu.state
        check(all(sd[k] == sc[k] for k in ("start", "fill", "pos_num")), f"state ints at step {i}")
        check(torch.equal(sd["buffer"].cpu(), sc["buffer"]), f"ring bit-equal at step {i}")
        fills.append(sd["fill"])
    check(err <= DEVICE_ATOL, f"card vs CPU: {err:.3e} > {DEVICE_ATOL}")
    compactions = sum(b < a for a, b in zip(fills, fills[1:]))
    check(compactions >= 2, "differential crosses >= 2 compactions")
    print(f"[5] card vs CPU: {B}-stream stereo fleet, {n_steps} steps, {compactions} compactions: "
          f"ints equal, ring bit-equal, max |card - CPU| = {err:.3e}")
    return err


# --------------------------------------------------------------------------
# phases 6-7: quality through the kernel, per-stream entry point
# --------------------------------------------------------------------------


def phase_alias(device, B=2, C=2, max_chunk=4096):
    fleet = BatchedResamplerFir(
        B, C, 48000, 44100, Latency.Sample64, Attenuation.Db90,
        synchronized=True, max_chunk=max_chunk, device=device,
    )
    t = np.arange(48000) / 48000
    tone = (0.5 * np.sin(2 * np.pi * 23000 * t)).astype(np.float32)
    before = kern.LAUNCHES
    pieces, offset = [], 0
    while offset < tone.size:
        n = min(max_chunk, tone.size - offset)
        chunk = np.zeros((B, max_chunk, C), np.float32)
        chunk[:, :n] = tone[offset : offset + n, None]
        out, c, p, _ = fleet.resample(chunk, np.full((B,), n))
        check(int(c[0]) > 0 or int(p[0]) > 0, "the tone feed makes progress")
        pieces.append(out[0, : int(p[0]), 0].cpu().numpy())
        offset += int(c[0])
    seg = np.concatenate(pieces)[2000:-2000]
    alias_db = float(-20 * np.log10(np.abs(seg).max() / 0.5 + 1e-12))
    check(alias_db >= 100.0, f"alias rejection {alias_db:.1f} dB >= 100")
    print(f"[6] alias rejection through the kernel (48 -> 44.1 kHz, 23 kHz tone): "
          f"{alias_db:.1f} dB over {seg.size} frames, {kern.LAUNCHES - before} launches")
    return alias_db


def phase_per_stream(device):
    t = np.arange(44100) / 44100
    x = np.stack(
        [0.5 * np.sin(2 * np.pi * 440 * t), 0.25 * np.sin(2 * np.pi * 1000 * t)], axis=1
    ).astype(np.float32).reshape(-1)
    args = (2, 44100, 48000, Latency.Sample64, Attenuation.Db90)
    y_dev = ResamplerFir(*args, device=device).process(x)
    y_cpu = ResamplerFir(*args, device="cpu").process(x)
    check(y_dev.shape == y_cpu.shape and y_dev.size > 0, "per-stream output length")
    err = float(np.abs(y_dev - y_cpu).max())
    check(err <= DEVICE_ATOL, f"per-stream card vs CPU: {err:.3e} > {DEVICE_ATOL}")
    print(f"[7] ResamplerFir.process(1 s stereo) on the card vs CPU: {y_dev.size} values, "
          f"max err {err:.3e}")


def main() -> None:
    smi = phase_device()
    device = torch.device("cuda")
    phase_build()
    cases = [
        ("main path 44.1->48k taps 128, 1024x2", (44100, 48000, 128, 2048, 4096, 16)),
        ("44.1->48k taps 64, 1024x2", (44100, 48000, 64, 2048, 4096, 16)),
        ("grouped 48->96k taps 64 (g 64), 128x2", (48000, 96000, 64, 256, 512, 3)),
        ("ragged 44.1->48k taps 128, R 6", (44100, 48000, 128, 6, 512, 3)),
    ]
    err, timing = phase_kernel(device, cases)
    launches = phase_main_path(device, smi)
    phase_differential(device)
    phase_alias(device)
    phase_per_stream(device)
    print(json.dumps({"kernels": [{
        "name": "dma_banded_contract",
        "route": "cuda",
        "source": "resampler_tpu_torch/csrc/fir_banded_contract.cu",
        "replaces": "resampler_tpu/ops/fir_dma_kernel.py:277",
        "launches": launches,
        "max_abs_err": err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
