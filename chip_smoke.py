#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``resampler_tpu_torch``).

Drives the port's FIR serving paths and its FFT engine on one NVIDIA
card and holds them against the port's plain PyTorch versions and the
CPU.  Run from the repository root on a machine with one CUDA GPU, nvcc
and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device and precision: a CUDA card, both TF32 flags off, the card's
   name and power limit from nvidia-smi;
2. build kernels B1 (csrc/fir_banded_contract.cu), B2/B3
   (csrc/fir_farrow_contract.cu), B4/B5 (csrc/fft_magsplit.cu), B6/B6b
   (csrc/fir_async_combine.cu), B8/B9 (csrc/fir_fleet_step.cu) and B7
   (csrc/matmul3.cu) with nvcc for sm_90a, one nvcc per source (six),
   started together;
3. each kernel against its plain version on the card at the main paths'
   shapes (plus a grouped small-M shape and ragged fleets), odd bases and
   the top bound, timed with CUDA events against its bound.  B1 as the
   fleet calls it (its band plan, the transposed atlas's window read in
   place) at three start phases per case, 44.1 -> 48 kHz at 128 and 64
   taps, grouped 48 -> 96 kHz, a ragged R of 6 and 48 -> 44.1 kHz, and its
   full span (``band=None``) on the same inputs, timed in turns; ptxas's
   registers and spills (none) and ``cp.async`` (LDGSTS) in its SASS; one
   fleet call runs the band kernel alone; the bound is the taps-wide work;
   one PyTorch ``matmul`` over the overlapping window view beside it.  B4
   and B5 at 8192 stereo streams (R 16384) of 1176 -> 1280 and 588 ->
   1280, the ragged 1280 -> 1176 (cols 294) at R 2 and 37, 1280 -> 3528
   (cols 882) at R 4099, 2560 -> 2352 (s 8) at R 1027 and 3528 -> 1280
   (rows 4410) at R 130, B5 over a P = 8 pool; a NaN row confined to its
   row, an Inf and a NaN just outside a group's band leaving that group
   finite, the noise floor against the f64 operator; ptxas's registers
   and spills (none), wgmma (HGMMA) and TMA (UTMALDG) in the SASS; the
   refusals (N % 4 != 0, a foreign t2h half); at the bench pair the
   work the kernel issues and the bytes it stages from L2, B7 (three
   passes) at the same projector in turns with B4, and one f32
   ``torch.matmul`` by the dense T2 as the library yardstick;
4. full width, 1024 stereo streams, Latency.Sample64 / Attenuation.Db90,
   max_chunk 4096, horizon 16, 40 ``resample`` calls and one
   ``resample_many`` of T = 8 per path: 44.1 -> 48 kHz (periodic, B1),
   44.1 -> 44.101 kHz farrow and lerp (B2), 600011 -> 600013 Hz wide u32
   (B2), 367500 -> 1601 Hz heavy downsampling (B3).  Each checks the
   exact schedule, one kernel launch per emitting step (counts set to 0
   just before the path, read just after), >= 2 compactions, and streams
   0-3 against a CPU fleet of those streams; then profiles 10 more steps;
5. card against CPU: small periodic, farrow and wide fleets, ragged feeds
   with NaN junk past the valid frames: ints equal, ring bit-equal,
   samples within 5e-5;
6. alias rejection of a 23 kHz tone through B1 (48 -> 44.1 kHz, >= 100
   dB) and through B2 (48000 -> 44101 Hz, equal to the CPU port's value
   within 0.5 dB, and >= 100 dB if that is);
7. the per-stream ``ResamplerFir.process`` on the card against the CPU,
   periodic and coprime;
8. the FFT engine at full width: ``BatchedResamplerFft(8192, 2, 44100,
   48000)``, ``backend="auto"`` (must be magsplit), 40 ``resample`` calls
   over 8 device-resident chunks and one ``resample_many(T=8)``: one B4
   launch per call, 1 B4 + 7 B5 for the batch, streams 0-3 against a CPU
   fleet, Msamples/s (and of a second, uncounted batch), then a profile
   of 10 steps;
9. the FFT quality gates through the kernel, by bench.py's procedures:
   ``fft_bench_pair_floor_db`` (1176 -> 1280, 8 streams, against f64)
   and ``fft_stopband_db`` (22.05 -> 48 kHz impulse), each >= 99 dB;
10. the per-stream ``ResamplerFft.process`` on the card: magsplit (auto)
   against the CPU, matmul (kernel B7, three bf16 passes) against B7's
   plain version on the same chunks;
11. kernel B6 (csrc/fir_async_combine.cu) against its plain version at the
   async fleet's shapes (R 2048 unless noted): (a) 44100 -> 44101, taps
   128, max_out 2176, skew 1; (b) 22050 -> 96000, skew 2; (c) 48000 ->
   44101; (d) the wide 4000000000 -> 4000000001; (e) 367500 -> 1601; (f)
   a ragged R of 6; (g) a starved state whose frame skew passes
   skew_periods; every case at several bases and n_out bounds in both
   forms (the one L/M picks: per position at (a)-(d), (f), (g), per
   output at (e); and the other), timed with CUDA events against its
   bound, the other form in turns with the picked one; ptxas's registers
   and spills of both forms (none); each case's form, tiles, shared
   memory and the work it issues (positions or outputs x 8 x taps) with
   its own bound beside the row's;
12. the async multi-tenant fleet at full width,
   ``BatchedResamplerFir(1024, 2, ..., sync_variant="async_tm",
   max_chunk=2048, horizon=16, max_out=2176, initial_positions=...)``, at
   44100 -> 44101 and 4000000000 -> 4000000001: 40 ``resample`` calls
   and one ``resample_many(T=8)``, a per-stream slew part-way; exactly one
   B6 launch per step and no other kernel, the schedule against a host
   recomputation, streams 0-3 against a CPU fleet that holds them and the
   streams that set the schedule, Msamples/s, then a profile of 10 steps;
13. card against CPU on small async fleets (narrow and wide, distinct
   phases, compactions, NaN junk past the valid frames);
14. alias rejection of a 23 kHz tone through B6 (48000 -> 44101 Hz,
   >= 100 dB and within 0.5 dB of the CPU port);
15. ``StreamingFleet(1024, 2, ..., synchronized="async")`` on the card
   with ragged pushes against the CPU ``StreamingFleet``, with the host
   pool's drain timed beside the step;
16. kernels B9 and B8 (csrc/fir_fleet_step.cu) against their plain
   version at the end-aligned fleets' shapes: (a) 44.1 -> 48 kHz, taps
   128, 1024 stereo streams, chunk 4096; (b) the same with ragged
   per-stream valid counts (0, 1, full), NaN junk past them and diverged
   positions; (c) 48 -> 44.1 kHz; (d) 48000 -> 96000 (M 2) at 128 x 2;
   (e) a ragged R of 6; (f) 47952 -> 48000 (L/M 999/1000) at 1024 x 2;
   each case in the band form (its tile and ptxas's registers, shared
   memory and spills printed), timed with CUDA events against their
   bounds, and one ``torch.matmul`` over the overlapping window view for
   the contraction alone as the library yardstick; at (a) also the
   per-output form, checked and timed in turns with the band form;
17. the vmapped fleet at full width, ``BatchedResamplerFir(1024, 2, 44100,
   48000, Latency.Sample64, Attenuation.Db90)``, chunk 4096, 40
   ``resample`` calls (every fifth with ragged per-stream valid counts)
   and one ``resample_many(T=8)``: one B9 launch per emitting step and no
   other kernel, every stream's schedule against a host recomputation,
   streams 0-3 against a CPU fleet, Msamples/s, then a profile of 10
   steps;
18. the vmapped farrow fleet (256 stereo streams, 44100 -> 44101, chunk
   2048; torch ops, no kernel) against a CPU fleet;
19. the slide fleet at full width (``synchronized=True,
   sync_variant="slide"``, 1024 x 2, 44.1 -> 48 kHz, chunk 4096): one B8
   launch per emitting step, outputs equal to the time-major fleet (B1)
   on the same feed, Msamples/s, then a profile of 10 steps;
20. card against CPU on small vmapped (periodic, farrow, wide) and slide
   fleets, ragged feeds with NaN junk past the valid frames;
21. alias rejection of a 23 kHz tone through B9 and through B8 (48 ->
   44.1 kHz, >= 100 dB);
22. ``StreamingFleet(64, 8, 44100, 48000)`` (BASELINE config 5, the
   vmapped fleet) with ragged pushes against the CPU ``StreamingFleet``,
   with the pool's drain timed beside the step;
23. kernel B7 (csrc/matmul3.cu) against its plain version: the FFT
   projector [16384, 1176] @ [1176, 2560] in three passes, the main path's
   tm window (K 28, R 2048, Mg 160, span 276; the overlapping ring view
   over the fleet's padded split atlas at columns 0, 77 and M-1, a
   time-major output view) in four, the conv backend's windows, a ragged
   strided shape with NaN and Inf rows; the floor against f64; times
   against the bound and one f32 ``torch.matmul`` of the same product; the
   split pass (bit for bit its plain version) and the GEMM timed apart,
   the GEMM in both accumulation forms; ptxas's
   registers and spills, and wgmma (HGMMA) and TMA (UTMALDG) in the SASS;
24. kernel B6b (the bf16x4 tensor-core kernel of csrc/fir_async_combine.cu,
   ``mma.sync``) against its plain version at B6's cases (a)-(g), timed
   against its bound and the bound on the work it issues; ptxas's
   registers and spills (none) and ``HMMA`` in its SASS, each case's tiles
   and shared memory;
25. the bf16x4 tm fleet at full width (``make_fir_fleet_step_sync_tm(...,
   precision="bf16x4")``, 1024 stereo streams, 44.1 -> 48 kHz, taps 128,
   max_chunk 4096, horizon 16, 40 steps): one B7 launch per emitting step
   and no B1, the exact schedule, every output against the f32 tm fleet
   on the same feed, streams 0-3 against a CPU fleet, Msamples/s and a
   profile of 10 steps; alias rejection through B7 (48 -> 44.1 kHz, 23 kHz
   tone, >= 100 dB);
26. the async fleet with ``kernel="pallas"`` (B6b) at full width, 1024 x
   2, 44100 -> 44101 and 4000000000 -> 4000000001, max_out 2176: one B6b
   launch per step, the schedule against a host recomputation, every
   output against the f32 async fleet (B6) on the same feed, Msamples/s;
   alias rejection through B6b (48000 -> 44101 Hz, >= 100 dB);
27. ``BatchedResamplerFft(8192, 2, 44100, 48000, backend="matmul")`` on
   the card (B7, three passes): one B7 launch per call, streams 0-3
   against B7's plain version, Msamples/s and a profile; the conv backend
   at 1024 streams the same way; ``fft_bench_pair_floor_db`` and
   ``fft_stopband_db`` through B7 on both backends, each >= 99 dB.

It prints the kernels' JSON line, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from resampler_tpu_torch import (
    Attenuation,
    BatchedResamplerFft,
    BatchedResamplerFir,
    Latency,
    ResamplerFft,
    ResamplerFir,
    StreamingFleet,
)
from resampler_tpu_torch.engine import fft as fft_engine
from resampler_tpu_torch.engine import fir_fleets
from resampler_tpu_torch.engine.fir import (
    FirConfig,
    _periodic_group_factor,
    farrow_matrix,
    fir_coefficients,
    fir_cutoff,
)
from resampler_tpu_torch.ops import _build
from resampler_tpu_torch.ops import fft_magsplit_kernel as mag
from resampler_tpu_torch.ops import fir_async_kernel as b6
from resampler_tpu_torch.ops import fir_dma_kernel as kern
from resampler_tpu_torch.ops import fir_kernel as b9
from resampler_tpu_torch.ops import fir_sync_kernel as b8
from resampler_tpu_torch.ops import matmul3 as m3
from resampler_tpu_torch.ops.matmul3 import split_hi_lo
from resampler_tpu_torch.types import reduce_ratio

#: kernel vs plain: f32 sums in another order (the JAX suite's own
#: dma-vs-xla tolerance, tests/test_pallas.py)
KERNEL_ATOL = 1e-5
#: card vs CPU on fleet outputs: bench.py's device-vs-CPU quality gate
DEVICE_ATOL = 5e-5
#: the slide fleet against the time-major fleet at 128 taps (phase 19)
SLIDE_TM_ATOL = 4e-6
#: the bf16x4 tm fleet against the f32 one: four passes keep ~16 bits of
#: each operand (3.3e-5 measured on the CPU port at outputs up to 4.3)
BF16X4_VS_F32_ATOL = 1e-4
#: the bf16x4 async fleet (B6b) against the f32 one (B6): the JAX suite's
#: bf16x4-vs-XLA bound (tests/test_async_kernel.py)
ASYNC_BF16X4_ATOL = 8e-5
#: H100 SXM data sheet: f32 CUDA-core and dense bf16 tensor-core peaks and
#: the HBM3 rate, for the bounds
F32_PEAK_TFLOPS = 67.0
BF16_PEAK_TFLOPS = 989.0
HBM_TBPS = 3.35

SOURCES = {
    "dma_banded_contract": ("resampler_tpu_torch/csrc/fir_banded_contract.cu",
                            "resampler_tpu/ops/fir_dma_kernel.py:277"),
    "dma_farrow_contract": ("resampler_tpu_torch/csrc/fir_farrow_contract.cu",
                            "resampler_tpu/ops/fir_dma_kernel.py:225"),
    "dma_farrow_contract_packed": ("resampler_tpu_torch/csrc/fir_farrow_contract.cu",
                                   "resampler_tpu/ops/fir_dma_kernel.py:170"),
    "magsplit_projector": ("resampler_tpu_torch/csrc/fft_magsplit.cu",
                           "resampler_tpu/ops/fft_magsplit_kernel.py:288"),
    "magsplit_projector_pool": ("resampler_tpu_torch/csrc/fft_magsplit.cu",
                                "resampler_tpu/ops/fft_magsplit_kernel.py:332"),
    "async_combine": ("resampler_tpu_torch/csrc/fir_async_combine.cu",
                      "resampler_tpu/ops/fir_async_kernel.py:294"),
    "fir_fleet_step_sync": ("resampler_tpu_torch/csrc/fir_fleet_step.cu",
                            "resampler_tpu/ops/fir_sync_kernel.py:52"),
    "fir_fleet_step": ("resampler_tpu_torch/csrc/fir_fleet_step.cu",
                       "resampler_tpu/ops/fir_kernel.py:116"),
    "async_combine_bf16x4": ("resampler_tpu_torch/csrc/fir_async_combine.cu",
                             "resampler_tpu/ops/fir_async_kernel.py:294"),
    "matmul3": ("resampler_tpu_torch/csrc/matmul3.cu", "resampler_tpu/ops/matmul3.py:78"),
}


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {what}")


def elapsed_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn(i)`` over ``reps`` calls, with
    CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flop: float, nbytes: float, peak_tflops: float = F32_PEAK_TFLOPS) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over the peak of their type (f32 by default) and the compulsory bytes
    over the memory rate."""
    t_op = flop / (peak_tflops * 1e9)
    t_by = nbytes / (HBM_TBPS * 1e9)
    return (t_op, "operations") if t_op >= t_by else (t_by, "bytes")


def zero_launches() -> None:
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0


def coeffs_for(in_hz, out_hz, taps):
    return fir_coefficients(taps, Attenuation.Db90, fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz))


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
    libs = _build.build()
    print(f"[2] built {sorted(libs)} with nvcc (sm_90a) in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log().splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line or "Compiling" in line:
            print(f"    {line.strip()}")


# --------------------------------------------------------------------------
# phase 3: kernels vs plain versions at the main paths' shapes
# --------------------------------------------------------------------------


def timed_pair(kernel, plain, reps=20, plain_reps=None):
    """Kernel and plain ms per call, in turns plain, kernel, kernel,
    plain (``fn(i)`` rotates its bases over the ring so successive calls
    do not find their rows in the 50 MB L2)."""
    for fn in (kernel, plain):
        fn(0)
    n = (plain_reps or reps, reps, reps, plain_reps or reps)
    t = [elapsed_ms(fn, k) for fn, k in zip((plain, kernel, kernel, plain), n)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t


def banded_case(in_hz, out_hz, taps, lanes, max_chunk, horizon, device, seed):
    """The ring, band plan, atlas windows and geometry
    ``make_fir_fleet_step_sync_tm`` hands B1 for one fleet configuration:
    each window a view of the transposed atlas at its start phase, read in
    place."""
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = FirConfig(channels=1, taps=taps, ratio_num=L, ratio_den=M)
    g = _periodic_group_factor(L, M)
    Lg, Mg = L * g, M * g
    span = Lg + taps + 1
    K = -(-cfg.out_capacity // Mg)
    ring = fir_fleets._ring_rows(cfg, max_chunk, horizon)
    a2 = fir_fleets._sync_atlas(
        dataclasses.replace(cfg, ratio_num=Lg, ratio_den=Mg) if g > 1 else cfg,
        coeffs_for(in_hz, out_hz, taps),
    )
    a2_t = torch.from_numpy(np.ascontiguousarray(a2.T)).to(device)
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.standard_normal((ring, lanes), dtype=np.float32)).to(device)
    windows = []
    for i0 in (0, int(rng.integers(1, M)) if M > 1 else 0, M - 1):
        c0 = (i0 * L) // M
        windows.append((i0, a2_t[c0 : c0 + span, i0 : i0 + Mg].T))
    top = ring - ((K - 1) * Lg + span)
    # odd bases, one in the ring's middle, and the top bound
    bases = [1, 3, 4097, 2 * (ring // 4) + 1, top]
    return buf, kern.BandPlan(Lg, Mg, taps), windows, bases, dict(L=Lg, M=Mg, span=span, K=K)


def sass_counts(lib_path: str, ops, source: str, source_ops):
    """Counts of ``ops`` in the SASS of ``lib_path`` (cuobjdump), or, where
    no disassembler exists, of ``source_ops`` in ``source``; and where they
    were counted."""
    tools = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        tools.append(os.path.join(os.path.dirname(spec.origin), "backends", "nvidia", "bin", "cuobjdump"))
    tool = next((t for t in tools if t and os.path.exists(t)), None)
    if tool is not None:
        sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, check=True,
                              timeout=300).stdout
        return {op: sass.count(op) for op in ops}, f"the SASS of {os.path.basename(lib_path)} ({tool})"
    src = open(source).read()
    return {op: src.count(op) for op in source_ops}, f"the source {source} (no cuobjdump found)"


def b1_build_report() -> None:
    """B1's kernels as built: ptxas's registers, shared memory and spills
    of each instantiation (``band_contract_kernel<TY>``: 8 TY rows per
    tile), none spilling, and ``cp.async`` (``LDGSTS``) in the SASS."""
    log = _build.build_log()
    section = log[log.find("== fir_banded_contract.cu"):].split("\n== ")[0]
    ty = None
    for line in section.splitlines():
        if "Compiling entry" in line:
            ty = int(line.split("band_contract_kernelILi")[1].split("E")[0]) if "band_contract" in line else None
        elif ty is not None and ("registers" in line or "spill" in line):
            print(f"[3] B1 ptxas band_contract_kernel<{ty}> ({8 * ty} rows): {line.strip()}")
            check("spill" not in line or " 0 bytes spill stores, 0 bytes spill loads" in line,
                  f"B1 band_contract_kernel<{ty}> spills: {line.strip()}")
    if "band_contract" not in section:
        print("[3] B1 ptxas: not in the build log (cached build)")
    counts, where = sass_counts(_build.build()["fir_banded_contract"]._name, ("LDGSTS",),
                                SOURCES["dma_banded_contract"][0], ("cp.async.cg",))
    check(all(counts.values()), f"B1's cp.async in {where}: {counts}")
    print(f"[3] B1 in {where}: {counts}")


def device_kernels(fn) -> list[str]:
    """The device kernels one call of ``fn`` runs (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]


def phase_banded_kernel(device, cases):
    """B1: the band form (the fleet's call) and the full span
    (``band=None``) against the plain version over every case, start
    phase and base; each case's band form timed against the plain version
    and, in turns, against the full span; for the main case also the
    bound (taps-wide work, the span-wide beside it), the kernels one
    fleet call runs, and one ``torch.matmul`` over the overlapping window
    view (the library yardstick, never called by the port)."""
    b1_build_report()
    worst, entry = 0.0, None
    for n, (name, args) in enumerate(cases):
        buf, plan, windows, bases, geo = banded_case(*args, device=device, seed=n)
        err = err_full = 0.0
        for i0, a in windows:
            for base in bases:
                ref = kern.dma_banded_contract_reference(buf, base, a, **geo)
                got = kern.dma_banded_contract(buf, base, a, band=(plan, i0), **geo)
                full = kern.dma_banded_contract(buf, base, a, **geo)
                check(bool(torch.isfinite(got).all()), f"B1 {name}: finite outputs")
                err = max(err, float((got - ref).abs().max()))
                err_full = max(err_full, float((full - ref).abs().max()))
        torch.cuda.synchronize()
        check(max(err, err_full) <= KERNEL_ATOL,
              f"B1 vs plain {name}: band {err:.3e}, full span {err_full:.3e} > {KERNEL_ATOL}")
        worst = max(worst, err)
        ring, R = buf.shape
        L, M, span, K = geo["L"], geo["M"], geo["span"], geo["K"]
        print(f"[3] B1 {name}: ring [{ring}, {R}] {geo}, {plan.rows}-row tiles ({plan.n_tiles}), "
              f"{plan.smem_bytes} B shared: max |kernel - plain| band {err:.3e}, full span "
              f"{err_full:.3e} over {len(windows) * len(bases)} calls each (start phases "
              f"{[i0 for i0, _ in windows]})")
        i0, a = windows[1]
        rot = np.linspace(0, bases[-1], 8).astype(int).tolist()

        def band(i):
            return kern.dma_banded_contract(buf, rot[i % 8], a, band=(plan, i0), **geo)

        ms, plain_ms, t = timed_pair(
            band, lambda i: kern.dma_banded_contract_reference(buf, rot[i % 8], a, **geo))
        _, full_ms, tf = timed_pair(band, lambda i: kern.dma_banded_contract(buf, rot[i % 8], a, **geo))
        taps = span - L - 1
        flop = 2 * K * M * taps * R  # the work the band needs
        issued = 2 * K * plan.issued(i0) * R
        nbytes = 4 * (((K - 1) * L + span) * R + M * taps + K * M * R)
        b_ms, b_by = bound_ms(flop, nbytes)
        span_ms = bound_ms(2 * K * M * span * R, nbytes)[0]
        print(f"    band {t[1]:.4f} / {t[2]:.4f} ms, plain {t[0]:.4f} / {t[3]:.4f} ms per call; in turns "
              f"full span {tf[0]:.4f} / {tf[3]:.4f}, band {tf[1]:.4f} / {tf[2]:.4f} ms "
              f"({full_ms / ms:.2f}x); band {issued / ms / 1e9:.2f} TFLOP/s issued "
              f"({issued / 1e9:.3f} GFLOP, {100 * issued / ms / 1e9 / F32_PEAK_TFLOPS:.1f}% of the "
              f"f32 peak); bound {b_ms:.4f} ms ({b_by}: {flop / 1e9:.3f} GFLOP taps-wide, "
              f"{nbytes / 1e6:.1f} MB; {100 * b_ms / ms:.1f}% of it reached), span-wide "
              f"{span_ms:.4f} ms")
        if entry is None:
            names = device_kernels(lambda: band(3))
            check(len(names) == 1 and "band_contract" in names[0],
                  f"B1 {name}: the fleet's call runs the band kernel alone: {names}")
            print(f"    one fleet call runs {names} (the window is read in place, no copy)")
            ac = a.contiguous()

            def library(i):
                base = rot[i % 8]
                view = buf[base:].as_strided((K, span, R), (L * R, R, 1))
                return torch.matmul(ac, view)

            ref = kern.dma_banded_contract_reference(buf, rot[3], a, **geo)
            library(0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            got = library(3)
            extra = torch.cuda.max_memory_allocated() - held - got.numel() * 4
            lib_err = float((got - ref).abs().max())
            del got, ref
            lib_ms = elapsed_ms(library, 20)
            copied = extra >= K * span * R * 4
            print(f"    library torch.matmul(a, as_strided window view): {lib_ms:.4f} ms "
                  f"(band {lib_ms / ms:.2f}x faster), max |library - plain| {lib_err:.3e}; "
                  f"{extra / 1e6:.1f} MB of scratch beyond the outputs: PyTorch "
                  f"{'COPIED' if copied else 'did not copy'} the overlapping view "
                  f"({K * span * R * 4 / 1e6:.1f} MB)")
            entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del buf, windows
    entry["max_abs_err"] = worst
    return entry


def farrow_case(in_hz, out_hz, taps, lanes, max_chunk, horizon, device, seed):
    """The ring, per-block weights (the fleet's own positioning matmul at
    three positions) and block table the fleet hands B2 / B3."""
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = FirConfig(channels=1, taps=taps, ratio_num=L, ratio_den=M)
    fp = fir_fleets._farrow_tm_plan(cfg, coeffs_for(in_hz, out_hz, taps))
    ashift2 = torch.from_numpy(fp["ashift2"]).to(device)
    ring = fir_fleets._ring_rows(cfg, max_chunk, horizon)
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.standard_normal((ring, lanes), dtype=np.float32)).to(device)
    if cfg.wide:
        positions = [(0, 0), (3, int(rng.integers(1, M))), (1, M - 1)]
    else:
        positions = [0, int(rng.integers(1, M)), M - 1]
    weights = [fir_fleets.farrow_weights(fp, M, pos, ashift2) for pos in positions]
    top = ring - (int(fp["block_base"].max()) + fp["w_blk"])
    bases = [1, 3, 4097, 2 * (ring // 4) + 1, top]
    return buf, weights, bases, fp


def phase_farrow_kernels(device, cases):
    """B2 and B3 against their plain version over every case, weight set
    and base; times and bounds at each kernel's main case (the first of
    its cases).  No single PyTorch call computes them (``block_base`` is
    no uniform stride), so they have no library time."""
    entries = {}
    for n, (name, args) in enumerate(cases):
        buf, weights, bases, fp = farrow_case(*args, device=device, seed=10 + n)
        K, q, w = fp["K"], fp["q"], fp["w_blk"]
        bb = fp["block_base"]
        kname = "dma_farrow_contract" if q >= 8 else "dma_farrow_contract_packed"
        fn = getattr(kern, kname)
        err = 0.0
        for a_blk in weights:
            for base in bases:
                got = fn(buf, base, a_blk, bb)
                ref = kern.dma_farrow_contract_reference(buf, base, a_blk, bb)
                err = max(err, float((got - ref).abs().max()))
        torch.cuda.synchronize()
        check(err <= KERNEL_ATOL, f"{kname} vs plain {name}: {err:.3e} > {KERNEL_ATOL}")
        ring, R = buf.shape
        print(f"[3] {'B2' if q >= 8 else 'B3'} {name}: ring [{ring}, {R}] K {K} q {q} w {w}: "
              f"max |kernel - plain| = {err:.3e} over {len(weights) * len(bases)} calls")
        a_blk = weights[1]
        rot = np.linspace(0, bases[-1], 8).astype(int).tolist()
        ms, plain_ms, t = timed_pair(
            lambda i: fn(buf, rot[i % 8], a_blk, bb),
            lambda i: kern.dma_farrow_contract_reference(buf, rot[i % 8], a_blk, bb),
        )
        covered = np.zeros(int(bb.max()) + w, bool)
        for b in bb:
            covered[b : b + w] = True
        flop = 2 * K * q * w * R
        nbytes = 4 * (int(covered.sum()) * R + K * q * w + K * q * R) + 8 * K
        b_ms, b_by = bound_ms(flop, nbytes)
        print(f"    kernel {t[1]:.4f} / {t[2]:.4f} ms, plain {t[0]:.4f} / {t[3]:.4f} ms per call; "
              f"kernel {flop / ms / 1e9:.3f} TFLOP/s, {nbytes / ms / 1e9:.3f} TB/s; bound "
              f"{b_ms:.4f} ms ({b_by}: {flop / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB; "
              f"{100 * b_ms / ms:.1f}% of it reached)")
        entry = entries.setdefault(kname, dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, max_abs_err=0.0,
        ))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        del buf, weights
    return entries


# --------------------------------------------------------------------------
# phase 4: the serving paths at full width
# --------------------------------------------------------------------------


def expected_schedule(cfg: FirConfig, n_valids):
    """The exact shared schedule, as plain integer arithmetic on one
    unbounded position: ``(to_copy, n_out)`` per step.  (The wide u32
    schedule equals it away from its saturation corner.)"""
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


def profile_steps(fleet, chunks, n=10):
    """Device time per step by kernel over ``n`` warm steps
    (torch.profiler, kernel events only), the device's busy share of the
    wall time, and the host ops that take the most host time.  Returns
    the device us/step of each kernel by name ({} if none was recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fleet.resample(chunks[i % len(chunks)])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / n
    events = prof.key_averages()
    kernels = sorted(
        ((getattr(ev, "self_device_time_total", 0) / n, ev.key) for ev in events
         if ev.device_type == DeviceType.CUDA),
        reverse=True,
    )
    dev_us = sum(us for us, _ in kernels)
    if dev_us <= 0:
        print("    profile: no device time recorded (not measured)")
        return {}
    print(f"    profile over {n} warm steps: device {dev_us:.1f} us/step of {wall_us:.1f} us/step "
          f"wall under the profiler (busy {100 * dev_us / wall_us:.1f}%); kernels, us/step:")
    for us, key in kernels[:7]:
        print(f"      {us:9.1f}  {100 * us / dev_us:5.1f}%  {key[:90]}")
    host = sorted(
        ((ev.self_cpu_time_total / n, ev.count // n, ev.key) for ev in events
         if ev.device_type == DeviceType.CPU),
        reverse=True,
    )
    print(f"    host: {sum(us for us, _, _ in host):.1f} us/step in {sum(c for _, c, _ in host)} "
          "profiled ops; top by self time, us/step (calls/step):")
    for us, count, key in host[:6]:
        print(f"      {us:9.1f}  ({count})  {key[:60]}")
    return {key: us for us, key in kernels}


def phase_fleet(device, smi, label, in_hz, out_hz, kernel_name, path="auto", B=1024, C=2,
                max_chunk=4096, horizon=16, n_steps=40, T=8, nbuf=8, mirror=4, warm=8,
                latency=Latency.Sample64):
    kw = dict(synchronized=True, max_chunk=max_chunk, horizon=horizon, path=path)
    torch.cuda.reset_peak_memory_stats()
    fleet = BatchedResamplerFir(B, C, in_hz, out_hz, latency, Attenuation.Db90, device=device, **kw)
    rng = np.random.default_rng(7)
    chunks_np = [rng.standard_normal((B, max_chunk, C), dtype=np.float32) for _ in range(nbuf)]
    chunks = [torch.from_numpy(c).to(device) for c in chunks_np]
    many = torch.stack([chunks[(n_steps + t) % nbuf] for t in range(T)])
    torch.cuda.synchronize()

    zero_launches()  # count only this path's own launches
    small, steps, fills, peaks = [], [], [], []
    t0 = time.perf_counter()
    for i in range(n_steps):
        if i == warm:
            torch.cuda.synchronize()  # the first steps grow the device allocator
            t_warm = time.perf_counter()
        out, c, p, peak = fleet.resample(chunks[i % nbuf])
        small.append(out[:mirror].clone())
        steps.append((int(c[0]), int(p[0])))
        fills.append(fleet.state["fill"])
        peaks.append(peak)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    dt, dt_warm = t_end - t0, t_end - t_warm
    t1 = time.perf_counter()
    outs, cs, ps, peak_many = fleet.resample_many(many)
    torch.cuda.synchronize()
    dt_many = time.perf_counter() - t1
    launches = dict(_build.LAUNCHES)

    steps += list(zip(cs.tolist(), ps.tolist()))
    total = n_steps + T
    want = list(expected_schedule(fleet.config, [max_chunk] * total))
    check(steps == want, f"{label}: consumed/produced follow the exact schedule")
    emitting = sum(p > 0 for _, p in steps)
    check(emitting > 0, f"{label}: steps emit")
    check(launches[kernel_name] == emitting,
          f"{label}: {kernel_name} launches {launches[kernel_name]} == emitting steps {emitting}")
    check(sum(launches.values()) == emitting, f"{label}: no other kernel launched {launches}")
    compactions = sum(b < a for a, b in zip(fills, fills[1:]))
    check(compactions >= 2, f"{label}: {compactions} compactions >= 2")
    out_cap = fleet.config.out_capacity
    check(tuple(out.shape) == (B, out_cap, C) and tuple(outs.shape) == (T, B, out_cap, C),
          f"{label}: output shapes")
    check(bool(torch.isfinite(torch.stack(peaks)).all()) and bool(torch.isfinite(outs).all()),
          f"{label}: finite outputs")
    check(float(peak_many) > 0, f"{label}: nonzero output")

    # streams are independent: streams 0..mirror-1 equal a CPU fleet of
    # just those streams, fed the same frames
    cpu = BatchedResamplerFir(mirror, C, in_hz, out_hz, latency, Attenuation.Db90, device="cpu", **kw)
    err = 0.0
    for i in range(total):
        ref, c, p, _ = cpu.resample(chunks_np[i % nbuf][:mirror])
        check((int(c[0]), int(p[0])) == steps[i], f"{label}: CPU mirror schedule at step {i}")
        got = small[i] if i < n_steps else outs[i - n_steps, :mirror]
        err = max(err, float((got.cpu() - ref).abs().max()))
    check(err <= DEVICE_ATOL, f"{label}: vs CPU mirror {err:.3e} > {DEVICE_ATOL}")

    def rate(step_slice, seconds, side=1):
        return sum(s[side] for s in step_slice) * B / seconds / 1e6

    print(f"[4] {label}: {B} streams x {C} ch, {in_hz} -> {out_hz} Hz taps {latency.taps}, "
          f"{total} steps ({emitting} emitting, {compactions} compactions), "
          f"{launches[kernel_name]} {kernel_name} launches; streams 0-{mirror - 1} vs CPU fleet "
          f"max err {err:.3e}")
    print(f"    fleet: {rate(steps[warm:n_steps], dt_warm):.1f} Msamples/s over resample() calls "
          f"{warm + 1}-{n_steps} ({dt_warm * 1e3 / (n_steps - warm):.3f} ms/step); all {n_steps} "
          f"calls incl. allocator warm-up {rate(steps[:n_steps], dt):.1f} Msamples/s; first "
          f"resample_many(T={T}) {rate(steps[n_steps:], dt_many):.1f} Msamples/s "
          f"[output frames x streams per second; card: {smi}]")
    if in_hz > 4 * out_hz:
        print(f"    input side: {rate(steps[warm:n_steps], dt_warm, side=0):.1f} Minput-frames/s "
              f"x streams over calls {warm + 1}-{n_steps} (output samples are scarce at this ratio)")
    print(f"    peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_steps(fleet, chunks)
    del fleet, chunks, many, outs, small
    torch.cuda.empty_cache()
    return launches[kernel_name]


# --------------------------------------------------------------------------
# phase 5: card vs CPU differential
# --------------------------------------------------------------------------


def phase_differential(device, in_hz, out_hz, path="auto", B=3, C=2, max_chunk=512,
                       horizon=3, n_steps=36, **fleet_kw):
    """Card against CPU; ``fleet_kw`` selects the async fleet
    (``sync_variant``, ``initial_positions``), whose positions are ``[B]``
    arrays and whose every step launches B6 once."""
    kw = dict(synchronized=True, max_chunk=max_chunk, horizon=horizon, path=path, **fleet_kw)
    args = (B, C, in_hz, out_hz, Latency.Sample64, Attenuation.Db90)
    dev = BatchedResamplerFir(*args, device=device, **kw)
    cpu = BatchedResamplerFir(*args, device="cpu", **kw)
    rng = np.random.default_rng(11)
    err = 0.0
    fills = []
    b6_before = _build.LAUNCHES["async_combine"]
    for i in range(n_steps):
        nv = max_chunk if i % 3 == 0 else int(rng.integers(0, max_chunk + 1))
        chunks = rng.standard_normal((B, max_chunk, C), dtype=np.float32)
        chunks[:, nv:] = np.nan  # the NaN fence keeps junk out of the ring
        od, cd, pd, kd = dev.resample(chunks, np.full((B,), nv))
        oc, cc, pc, kc = cpu.resample(chunks, np.full((B,), nv))
        check(np.array_equal(cd, cc) and np.array_equal(pd, pc), f"ints at step {i}")
        err = max(err, float((od.cpu() - oc).abs().max()), abs(float(kd) - float(kc)))
        if i == 10:
            check(np.array_equal(dev.slew(0.3), cpu.slew(0.3)), "slew")
        sd, sc = dev.state, cpu.state
        check(all(np.array_equal(sd[k], sc[k]) for k in sc if k != "buffer"), f"state ints at step {i}")
        check(torch.equal(sd["buffer"].cpu(), sc["buffer"]), f"ring bit-equal at step {i}")
        fills.append(sd["fill"])
    check(err <= DEVICE_ATOL, f"card vs CPU {in_hz}->{out_hz}: {err:.3e} > {DEVICE_ATOL}")
    compactions = sum(b < a for a, b in zip(fills, fills[1:]))
    check(compactions >= 2, "differential crosses >= 2 compactions")
    b6_launches = _build.LAUNCHES["async_combine"] - b6_before
    variant = fleet_kw.get("sync_variant", "tm")
    check(b6_launches == (n_steps if variant == "async_tm" else 0),
          f"{variant}: {b6_launches} B6 launches in {n_steps} steps")
    print(f"[{13 if variant == 'async_tm' else 5}] card vs CPU, {in_hz} -> {out_hz} Hz ({variant}, {path}): "
          f"{B}-stream stereo fleet, {n_steps} steps, {compactions} compactions, {b6_launches} B6 launches: "
          f"ints equal, ring bit-equal, max |card - CPU| = {err:.3e}")
    return err


# --------------------------------------------------------------------------
# phases 6-7: quality through the kernels, per-stream entry point
# --------------------------------------------------------------------------


def alias_db(device, in_hz, out_hz, B=2, C=2, max_chunk=4096, fleet=None, **fleet_kw):
    """Alias rejection of a 23 kHz tone through a fleet (a
    ``BatchedResamplerFir`` made from ``fleet_kw`` unless ``fleet`` is
    given: any object with its ``resample(chunks, n_valid)``)."""
    if fleet is None:
        fleet = BatchedResamplerFir(
            B, C, in_hz, out_hz, Latency.Sample64, Attenuation.Db90,
            max_chunk=max_chunk, device=device, **{"synchronized": True, **fleet_kw},
        )
    t = np.arange(in_hz) / in_hz
    tone = (0.5 * np.sin(2 * np.pi * 23000 * t)).astype(np.float32)
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
    return float(-20 * np.log10(np.abs(seg).max() / 0.5 + 1e-12)), seg.size


def phase_alias(device):
    before = kern.LAUNCHES["dma_banded_contract"]
    db, n = alias_db(device, 48000, 44100)
    check(db >= 100.0, f"alias rejection {db:.1f} dB >= 100")
    print(f"[6] alias rejection through B1 (48 -> 44.1 kHz, 23 kHz tone): {db:.1f} dB over {n} "
          f"frames, {kern.LAUNCHES['dma_banded_contract'] - before} launches")
    before = kern.LAUNCHES["dma_farrow_contract"]
    db, n = alias_db(device, 48000, 44101)
    launches = kern.LAUNCHES["dma_farrow_contract"] - before
    db_cpu, _ = alias_db("cpu", 48000, 44101)
    check(launches > 0, "the coprime tone ran through B2")
    check(abs(db - db_cpu) <= 0.5, f"B2 alias {db:.2f} dB vs CPU port {db_cpu:.2f} dB")
    check(db >= 100.0 or db_cpu < 100.0, f"B2 alias rejection {db:.1f} dB >= 100")
    print(f"    alias rejection through B2 (48000 -> 44101 Hz, 23 kHz tone): {db:.2f} dB over {n} "
          f"frames, {launches} launches; CPU port {db_cpu:.2f} dB")
    return db


def phase_per_stream(device, in_hz, out_hz):
    t = np.arange(in_hz) / in_hz
    x = np.stack(
        [0.5 * np.sin(2 * np.pi * 440 * t), 0.25 * np.sin(2 * np.pi * 1000 * t)], axis=1
    ).astype(np.float32).reshape(-1)
    args = (2, in_hz, out_hz, Latency.Sample64, Attenuation.Db90)
    y_dev = ResamplerFir(*args, device=device).process(x)
    y_cpu = ResamplerFir(*args, device="cpu").process(x)
    check(y_dev.shape == y_cpu.shape and y_dev.size > 0, "per-stream output length")
    err = float(np.abs(y_dev - y_cpu).max())
    check(err <= DEVICE_ATOL, f"per-stream card vs CPU: {err:.3e} > {DEVICE_ATOL}")
    print(f"[7] ResamplerFir.process(1 s stereo, {in_hz} -> {out_hz} Hz) on the card vs CPU: "
          f"{y_dev.size} values, max err {err:.3e}")


# --------------------------------------------------------------------------
# phases 3 (B4, B5) and 8-10: the FFT engine
# --------------------------------------------------------------------------


def floor_db(out, prev, cur, n_in, n_out, rows=64) -> float:
    """Noise floor of ``out`` against the f64 ``[prev | cur] @ T2`` on the
    first ``rows`` rows: -20 log10(rms error / rms signal)."""
    x2 = torch.cat([prev[:rows], cur[:rows]], dim=1).cpu().double()
    ref = x2 @ torch.from_numpy(mag._t2_f64(n_in, n_out))
    err = out[:rows].cpu().double() - ref
    return float(-20 * torch.log10(err.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()))


def magsplit_case(device, n_in, n_out, R, P, seed):
    plan = mag.plan_magsplit(n_in, n_out)
    check(plan is not None, f"{n_in}->{n_out} has a band plan")
    wh, wcorr = mag.magsplit_weights(plan, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pool = torch.randn((P, R, n_in), generator=gen, device=device)
    return plan, wh, wcorr, pool


def sums_in_f32(prev, cur, wh, wcorr, plan):
    """The plain version's products summed in f32 by cuBLAS, to show why
    the plain version sums in f64."""
    hi, lo = split_hi_lo(torch.cat([prev, cur], dim=1))
    outs = []
    for q in range(plan.s):
        r0 = q * plan.bps * plan.lp
        rb = r0 + plan.b0 * plan.lp
        hl = torch.cat([hi[:, rb : rb + plan.wc], lo[:, rb : rb + plan.wc]], dim=1)
        outs.append(hi[:, r0 : r0 + plan.rows] @ wh[q].float() + hl @ wcorr[q].float())
    return torch.cat(outs, dim=1)


def b4_build_report() -> None:
    """B4/B5's kernel as built: ptxas's registers, shared memory and spills
    (none), the dynamic shared memory, and ``wgmma`` (``HGMMA``) and TMA
    (``UTMALDG``) in the library's SASS."""
    log = _build.build_log()
    section = log[log.find("== fft_magsplit.cu"):].split("\n== ")[0]
    for line in section.splitlines():
        if "Used" in line or "spill" in line:
            print(f"[3] B4 ptxas magsplit_kernel: {line.strip()}")
            check("spill" not in line or " 0 bytes spill stores, 0 bytes spill loads" in line,
                  f"B4's kernel spills: {line.strip()}")
    if "magsplit_kernel" not in section:
        print("[3] B4 ptxas: not in the build log (cached build)")
    else:
        print(f"[3] B4 ptxas: {section.count('warpgroup.arrive is injected')} wgmma fences injected by ptxas "
              f"for the register A operands (C7519)")
    libs = _build.build()
    print(f"[3] B4/B5: {libs['fft_magsplit_smem'].fft_magsplit_smem()} bytes of dynamic shared memory per "
          f"block; ptxas's count is the 384-thread launch bound's, setmaxnreg then gives the consumer "
          f"warpgroups 232 registers and the producer 40")
    counts, where = sass_counts(libs["fft_magsplit_projector"]._name, ("HGMMA", "UTMALDG"),
                                SOURCES["magsplit_projector"][0], ("wgmma.mma_async", "cp.async.bulk.tensor"))
    check(all(counts.values()), f"B4's wgmma and TMA instructions in {where}: {counts}")
    print(f"[3] B4 in {where}: {counts}")


def magsplit_refusals(device) -> None:
    """The card's B4 refuses what its TMA maps and packed weights cannot
    take, with ValueError, and never runs the plain version instead: N not
    a multiple of 4 (390 -> 384), and a ``wcorr`` whose t2h half is not
    ``wh``'s slice."""
    before = dict(_build.LAUNCHES)
    plan = mag.plan_magsplit(390, 384)
    x = torch.randn((16, 390), device=device)
    cases = [("N = 390", x, *mag.magsplit_weights(plan, device), plan, "multiple of 4")]
    plan = mag.plan_magsplit(1176, 1280)
    wh, wcorr = mag.magsplit_weights(plan, device)
    bad = wcorr.clone()
    bad[1, plan.wc + 3, 7] = 1.0
    cases.append(("a foreign t2h half", torch.randn((16, 1176), device=device), wh, bad, plan, "t2h"))
    for what, x, wh, wcorr, plan, rule in cases:
        try:
            mag.magsplit_projector(x, x, wh, wcorr, plan=plan)
        except ValueError as e:
            check(rule in str(e), f"B4 refuses {what}: {e}")
        else:
            raise RuntimeError(f"FAILED: B4 took {what}")
    check(_build.LAUNCHES == before, "a refused call launches nothing")
    print("[3] B4 refuses N % 4 != 0 (390 -> 384) and a foreign t2h half with ValueError; nothing launched")


def out_of_band(pool_prev, pool_cur, plan):
    """``prev``, ``cur`` with an Inf in row 0 just past group 0's band (x2
    column rows + 2: the tail of group 0's last tile) and a NaN in the last
    row just before group 1's band (x2 column bps * lp - 1: the head of
    group 1's first tile where that is not on 4 columns)."""
    x2 = torch.cat([pool_prev, pool_cur], dim=1)
    x2[0, plan.rows + 2] = float("inf")
    x2[-1, plan.bps * plan.lp - 1] = float("nan")
    n = plan.n_in
    return x2[:, :n].contiguous(), x2[:, n:].contiguous()


def phase_magsplit_kernels(device, cases, timed):
    """B4 and B5 against their plain version, NaN confinement, an
    out-of-band Inf and NaN, and the noise floor at every ``(n_in, n_out,
    R)`` case; at the ``timed`` case the times, the bound, the work the
    kernel issues and the bytes it stages, B7 (three passes) at the same
    projector and the library yardstick, the calls rotating over a P = 8
    pool so that at full width each finds its 154 MB of input outside the
    50 MB L2."""
    b4_build_report()
    magsplit_refusals(device)
    entries = {}
    for n_in, n_out, R in cases:
        plan, wh, wcorr, pool = magsplit_case(device, n_in, n_out, R, 8, seed=R + n_in)
        pairs = ((7, 0), (0, 1), (3, 5))
        err = err_pool = 0.0
        got = mag.magsplit_projector(pool[0], pool[1], wh, wcorr, plan=plan)
        ref = mag.magsplit_projector_reference(pool[0], pool[1], wh, wcorr, plan=plan)
        err = float((got - ref).abs().max())
        fl_kernel = floor_db(got, pool[0], pool[1], n_in, n_out)
        fl_plain = floor_db(ref, pool[0], pool[1], n_in, n_out)
        for i, j in pairs:
            got_p = mag.magsplit_projector_pool(pool, i, j, wh, wcorr, plan=plan)
            ref_p = mag.magsplit_projector_reference(pool[i], pool[j], wh, wcorr, plan=plan)
            err_pool = max(err_pool, float((got_p - ref_p).abs().max()))
        # one NaN and one Inf input: those rows go non-finite, the rest stay
        bad = pool[2].clone()
        r_nan, r_inf = R // 2, R - 1
        bad[r_nan, 3] = float("nan")
        bad[r_inf, n_in - 1] = float("inf")
        got_b = mag.magsplit_projector(pool[1], bad, wh, wcorr, plan=plan)
        ref_b = mag.magsplit_projector_reference(pool[1], bad, wh, wcorr, plan=plan)
        torch.cuda.synchronize()
        finite = torch.isfinite(ref_b)
        check(torch.equal(torch.isfinite(got_b), finite), f"B4 {n_in}->{n_out} R {R}: non-finite pattern")
        check(not finite[r_nan].all() and not finite[r_inf].all(), "bad rows go non-finite")
        others = torch.ones(R, dtype=torch.bool, device=device)
        others[[r_nan, r_inf]] = False
        check(bool(finite[others].all()), "other rows stay finite")
        err_bad = float((got_b[finite] - ref_b[finite]).abs().max()) if finite.any() else 0.0
        # out of band: the groups whose band misses the value stay finite
        o_prev, o_cur = out_of_band(pool[3], pool[4], plan)
        got_o = mag.magsplit_projector(o_prev, o_cur, wh, wcorr, plan=plan)
        ref_o = mag.magsplit_projector_reference(o_prev, o_cur, wh, wcorr, plan=plan)
        torch.cuda.synchronize()
        fin_o = torch.isfinite(ref_o)
        c = plan.cols
        check(torch.equal(torch.isfinite(got_o), fin_o), f"B4 {n_in}->{n_out} R {R}: out-of-band pattern")
        check(bool(torch.isfinite(got_o[0, :c]).all()) and bool(torch.isfinite(got_o[-1, c : 2 * c]).all()),
              f"B4 {n_in}->{n_out} R {R}: a group whose band misses a non-finite input stays finite")
        check(not fin_o[0].all() and not fin_o[-1, :c].all() and bool(fin_o[1:-1].all()),
              "the groups whose band holds it go non-finite")
        err_bad = max(err_bad, float((got_o[fin_o] - ref_o[fin_o]).abs().max()))
        del got_o, ref_o, o_prev, o_cur
        worst = max(err, err_pool, err_bad)
        check(worst <= KERNEL_ATOL, f"B4/B5 vs plain {n_in}->{n_out} R {R}: {worst:.3e} > {KERNEL_ATOL}")
        check(fl_kernel >= plan.floor_db - 2.0,
              f"B4 floor {fl_kernel:.2f} dB >= plan {plan.floor_db} - 2 at {n_in}->{n_out}")
        print(f"[3] B4/B5 {n_in}->{n_out} R {R} (s {plan.s}, rows {plan.rows}, wc {plan.wc}, cols "
              f"{plan.cols}): max |kernel - plain| B4 {err:.3e}, B5 {err_pool:.3e} over slot pairs "
              f"{pairs}, NaN/Inf rows and out-of-band Inf/NaN {err_bad:.3e}; floor vs f64 (64 rows) kernel "
              f"{fl_kernel:.2f} dB, plain {fl_plain:.2f} dB, plan {plan.floor_db} dB")
        for name, e in (("magsplit_projector", max(err, err_bad)), ("magsplit_projector_pool", err_pool)):
            entry = entries.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], e)
        if (n_in, n_out, R) != timed:
            del pool, bad
            continue
        P = pool.shape[0]
        ms4, plain4, t4 = timed_pair(
            lambda i: mag.magsplit_projector(pool[i % P], pool[(i + 1) % P], wh, wcorr, plan=plan),
            lambda i: mag.magsplit_projector_reference(pool[i % P], pool[(i + 1) % P], wh, wcorr, plan=plan),
        )
        ms5, plain5, t5 = timed_pair(
            lambda i: mag.magsplit_projector_pool(pool, i % P, (i + 1) % P, wh, wcorr, plan=plan),
            lambda i: mag.magsplit_projector_reference(pool[i % P], pool[(i + 1) % P], wh, wcorr, plan=plan),
        )
        # B7 at the same projector, as the FFT matmul backend calls it
        # (x_t [R, N] @ T [N, 2M], three passes), in turns with B4
        t_hi, t_lo = (h.to(device) for h in m3.split_weight(
            torch.from_numpy(fft_engine.get_projection_matrix(n_in, n_out))))
        ms7_b4, ms7, t7 = timed_pair(
            lambda i: mag.magsplit_projector(pool[i % P], pool[(i + 1) % P], wh, wcorr, plan=plan),
            lambda i: m3.matmul3(pool[i % P], t_hi, t_lo, passes=3),
        )
        del t_hi, t_lo
        t2 = torch.from_numpy(mag._t2_f64(n_in, n_out).astype(np.float32)).to(device)

        def library(i):
            return torch.matmul(torch.cat([pool[i % P], pool[(i + 1) % P]], dim=1), t2)

        ref = mag.magsplit_projector_reference(pool[0], pool[1], wh, wcorr, plan=plan)
        lib = library(0)
        torch.cuda.synchronize()
        lib_err = float((lib - ref).abs().max())
        f32_err = float((sums_in_f32(pool[0], pool[1], wh, wcorr, plan) - ref).abs().max())
        del lib
        lib_ms = elapsed_ms(library, 20)
        flop = 2 * R * (plan.rows + 2 * plan.wc) * plan.cols * plan.s
        nbytes = 4 * (2 * R * n_in + R * n_out) + 2 * plan.s * (plan.rows + 2 * plan.wc) * plan.cols
        b_ms, b_by = bound_ms(flop, nbytes, BF16_PEAK_TFLOPS)
        tp = mag.tile_plan(plan)
        issued, staged = tp.issued_flop(R), tp.staged_bytes(R)
        lib_flop = 2 * R * 2 * n_in * n_out
        for name, ms, plain_ms, t in (("magsplit_projector", ms4, plain4, t4),
                                      ("magsplit_projector_pool", ms5, plain5, t5)):
            print(f"    {name}: kernel {t[1]:.4f} / {t[2]:.4f} ms, plain {t[0]:.4f} / {t[3]:.4f} ms per "
                  f"call; kernel {flop / ms / 1e9:.1f} TFLOP/s ({100 * b_ms / ms:.1f}% of the bound "
                  f"{b_ms:.4f} ms, {b_by}: {flop / 1e9:.1f} GFLOP at {BF16_PEAK_TFLOPS:.0f} TFLOP/s "
                  f"bf16, {nbytes / 1e6:.1f} MB at {HBM_TBPS} TB/s)")
            entries[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        print(f"    issued: {issued / 1e9:.1f} GFLOP bf16 on the tensor cores ({tp.issued_k()} k per output "
              f"column over the groups against the bound's {plan.s * (plan.rows + 2 * plan.wc)}; "
              f"{issued / ms4 / 1e9:.1f} TFLOP/s, {100 * issued / (BF16_PEAK_TFLOPS * 1e9) / ms4:.1f}% of "
              f"the peak); staged from L2: {staged / 1e9:.3f} GB per call ({staged / ms4 / 1e9:.2f} TB/s)")
        print(f"    B7 (csrc/matmul3.cu, three passes) at the same projector, [{R}, {n_in}] @ [{n_in}, "
              f"{2 * n_out}] as the matmul backend calls it, in turns with B4: B7 {t7[0]:.4f} / {t7[3]:.4f} ms, "
              f"B4 {t7[1]:.4f} / {t7[2]:.4f} ms; B4 {ms7 / ms7_b4:.2f}x faster")
        print(f"    library: torch.matmul(cat(prev, cur), T2) in f32, TF32 off: {lib_ms:.4f} ms "
              f"({lib_flop / 1e9:.1f} GFLOP dense, {lib_flop / lib_ms / 1e9:.1f} TFLOP/s); max |library "
              f"- plain| {lib_err:.3e}")
        print(f"    the plain version's sums in f32 (cuBLAS) instead of f64: max |f32 sums - plain| "
              f"{f32_err:.3e} (kernel: {err:.3e})")
        del pool, bad, t2
    torch.cuda.empty_cache()
    return entries


def phase_fft_fleet(device, smi, B=8192, C=2, n_steps=40, T=8, nbuf=8, mirror=4, warm=8):
    """The FFT serving path at bench.py's full width (bench_fft,
    bench_fft_pool): 8192 stereo streams, 44.1 -> 48 kHz, on the card's
    production backend."""
    torch.cuda.reset_peak_memory_stats()
    fleet = BatchedResamplerFft(B, C, 44100, 48000, device=device)
    check(fleet._resolved_backend == "magsplit", f"auto -> {fleet._resolved_backend} (want magsplit)")
    n_in, n_out = fleet.config.fft_size_input, fleet.config.fft_size_output
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    chunks = [torch.randn((B, C, n_in), generator=gen, device=device) for _ in range(nbuf)]
    many = torch.stack([chunks[(n_steps + t) % nbuf] for t in range(T)])
    torch.cuda.synchronize()

    zero_launches()
    small = []
    t0 = time.perf_counter()
    for i in range(n_steps):
        if i == warm:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
        out = fleet.resample(chunks[i % nbuf])
        small.append(out[:mirror].clone())
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    t1 = time.perf_counter()
    outs = fleet.resample_many(many)
    torch.cuda.synchronize()
    dt_many = time.perf_counter() - t1
    launches = dict(_build.LAUNCHES)
    want = dict({name: 0 for name in launches}, magsplit_projector=n_steps + 1,
                magsplit_projector_pool=T - 1)
    check(launches == want, f"FFT fleet launches {launches} == {want}")
    check(tuple(out.shape) == (B, C, n_out) and tuple(outs.shape) == (T, B, C, n_out), "FFT output shapes")
    check(bool(torch.isfinite(outs).all()) and bool(torch.isfinite(out).all()), "FFT finite outputs")
    check(float(outs.abs().max()) > 0, "FFT nonzero output")

    cpu = BatchedResamplerFft(mirror, C, 44100, 48000, backend="magsplit", device="cpu")
    err = 0.0
    for i in range(n_steps):
        err = max(err, float((small[i].cpu() - cpu.resample(chunks[i % nbuf][:mirror].cpu())).abs().max()))
    ref_many = cpu.resample_many(many[:, :mirror].cpu())
    err = max(err, float((outs[:, :mirror].cpu() - ref_many).abs().max()))
    check(err <= DEVICE_ATOL, f"FFT fleet vs CPU mirror {err:.3e} > {DEVICE_ATOL}")

    # a second batch, after the counted run: the first one also pays the
    # allocator's growth for its [T, B, C, M] output
    t2 = time.perf_counter()
    fleet.resample_many(many)
    torch.cuda.synchronize()
    dt_many2 = time.perf_counter() - t2

    per_step = B * C * n_out  # output samples per step, all streams and channels
    dt_warm, dt = t_end - t_warm, t_end - t0
    print(f"[8] FFT fleet: {B} streams x {C} ch, 44100 -> 48000 Hz (N {n_in}, M {n_out}), backend "
          f"{fleet._resolved_backend}: {n_steps} resample() + resample_many(T={T}); launches {launches}; "
          f"streams 0-{mirror - 1} vs CPU fleet max err {err:.3e}")
    print(f"    fleet: {per_step * (n_steps - warm) / dt_warm / 1e6:.1f} Msamples/s over resample() calls "
          f"{warm + 1}-{n_steps} ({dt_warm * 1e3 / (n_steps - warm):.3f} ms/step); all {n_steps} calls "
          f"{per_step * n_steps / dt / 1e6:.1f} Msamples/s; first resample_many(T={T}) "
          f"{per_step * T / dt_many / 1e6:.1f} Msamples/s ({dt_many * 1e3 / T:.3f} ms/chunk), second "
          f"{per_step * T / dt_many2 / 1e6:.1f} Msamples/s ({dt_many2 * 1e3 / T:.3f} ms/chunk) "
          f"[B x C x M = {per_step} output samples per step, bench.py:394's count; card: {smi}]")
    print(f"    peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_steps(fleet, chunks)
    del fleet, chunks, many, outs, small
    torch.cuda.empty_cache()
    return launches


def fft_stopband_db(device, backend="auto") -> float:
    """bench.py:709-725: the impulse response of ResamplerFft(2, 22050,
    48000) on channel 0, passband peak minus stopband peak."""
    C = 2
    rf = ResamplerFft(C, 22050, 48000, backend=backend, device=device)
    x = np.zeros(10 * rf.chunk_size_input(), np.float32)
    x[len(x) // 2 - (len(x) // 2) % C] = 1.0
    y = rf.process(x)[0::C]
    peak = int(np.argmax(np.abs(y)))
    w = int(48000 * 0.1)
    s = max(peak - w // 2, 0)
    spec = np.fft.rfft(y[s : s + w], 1 << 17)
    mag_db = 20 * np.log10(np.maximum(np.abs(spec), 1e-12))

    def b(f):
        return round(f / 48000 * (1 << 17))

    nyq = 22050 / 2
    return float(mag_db[b(20.0) : b(nyq * 0.9) + 1].max() - mag_db[b(nyq * 1.1) : b(48000 / 2 * 0.95) + 1].max())


def fft_bench_pair_floor_db(device, backend="auto") -> float:
    """bench.py:454-490: the bench pair's production step (1176 -> 1280,
    8 stereo streams, two chunks) against the f64 projector."""
    cfg = fft_engine.FftConfig(channels=2, fft_size_input=1176, fft_size_output=1280)
    B = 8
    step = fft_engine.make_fft_fleet_step(cfg, B, backend=backend, device=device)
    state = fft_engine.fft_fleet_init(cfg, B, backend=backend, device=device)
    rng = np.random.default_rng(11)
    proj = fft_engine.get_projection_matrix(1176, 1280).astype(np.float64)
    overlap = np.zeros((B, 2, 1280))
    floor = 1e9
    for _ in range(2):
        ch = rng.standard_normal((B, 2, 1176)).astype(np.float32)
        state, out = step(state, torch.from_numpy(ch).to(device))
        full = ch.astype(np.float64) @ proj
        ref = full[:, :, :1280] + overlap
        overlap = full[:, :, 1280:]
        err = out.cpu().numpy().astype(np.float64) - ref
        floor = min(floor, float(-20 * np.log10(np.sqrt((err**2).mean() / (ref**2).mean() + 1e-300))))
    return floor


def phase_fft_quality(device):
    zero_launches()
    pair_db = fft_bench_pair_floor_db(device)
    n_pair = _build.LAUNCHES["magsplit_projector"]
    stop_db = fft_stopband_db(device)
    n_stop = _build.LAUNCHES["magsplit_projector"] - n_pair
    check(n_pair == 2 and n_stop > 0, f"quality gates ran through B4 ({n_pair}, {n_stop} launches)")
    check(pair_db >= 99.0, f"fft_bench_pair_floor_db {pair_db:.2f} >= 99")
    check(stop_db >= 99.0, f"fft_stopband_db {stop_db:.2f} >= 99")
    print(f"[9] FFT quality through B4: fft_bench_pair_floor_db {pair_db:.2f} dB ({n_pair} launches), "
          f"fft_stopband_db {stop_db:.2f} dB ({n_stop} launches); gates >= 99 dB")


def fft_b7_plain(backend, chunks, n_in, n_out):
    """The card's ``matmul`` or ``conv`` FFT step (B7, three passes) on
    consecutive chunks ``[T, R, N]``, through B7's plain version on the
    chunks' device: ``[T, R, M]``."""
    if backend == "matmul":
        weight = fft_engine.get_projection_matrix(n_in, n_out)
    else:
        w = fft_engine.input_domain_conv_operator(n_in, n_out)
        g, lp, mp = w.shape[0] - 1, w.shape[1], w.shape[2]
        weight = w.reshape((g + 1) * lp, mp)
    t_hi, t_lo = (h.to(chunks.device) for h in m3.split_weight(torch.from_numpy(weight)))
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


def phase_fft_per_stream(device):
    """magsplit (auto) against the CPU port; matmul, which runs B7 in three
    bf16 passes on the card where the CPU runs f32, against B7's plain
    version on the same chunks."""
    t = np.arange(44100) / 44100
    x = np.stack(
        [0.5 * np.sin(2 * np.pi * 440 * t), 0.25 * np.sin(2 * np.pi * 1000 * t)], axis=1
    ).astype(np.float32).reshape(-1)
    for backend in ("auto", "matmul"):
        before = dict(_build.LAUNCHES)
        r = ResamplerFft(2, 44100, 48000, backend=backend, device=device)
        y_dev = r.process(x)
        launched = {k: _build.LAUNCHES[k] - before[k] for k in ("magsplit_projector", "matmul3")}
        if backend == "auto":
            y_ref = ResamplerFft(2, 44100, 48000, backend="magsplit", device="cpu").process(x)
            tol, against = DEVICE_ATOL, "the CPU (magsplit)"
        else:
            ci, co = r.chunk_size_input(), r.chunk_size_output()
            n = -(-x.size // ci)
            padded = np.zeros(n * ci, np.float32)
            padded[: x.size] = x
            chunks = torch.from_numpy(padded.reshape(n, -1, 2).transpose(0, 2, 1).copy()).to(device)
            ref = fft_b7_plain("matmul", chunks, r.fft_size_input, r.fft_size_output)
            y_ref = ref.permute(0, 2, 1).reshape(-1).cpu().numpy()[: -(-x.size * co // ci)]
            tol, against = KERNEL_ATOL, "B7's plain version on the same chunks"
        check(y_dev.shape == y_ref.shape and y_dev.size > 0, "per-stream FFT output length")
        err = float(np.abs(y_dev - y_ref).max())
        check(err <= tol, f"per-stream FFT {backend} vs {against}: {err:.3e} > {tol}")
        want = {"magsplit_projector": backend == "auto", "matmul3": backend == "matmul"}
        check(all((launched[k] > 0) == v for k, v in want.items()), f"per-stream FFT {backend}: launches {launched}")
        print(f"[10] ResamplerFft.process(1 s stereo, 44100 -> 48000 Hz, backend {backend}) on the card "
              f"vs {against}: {y_dev.size} values, max err {err:.3e}, launches {launched}")

# --------------------------------------------------------------------------
# phases 11-15: the async multi-tenant fleet and kernel B6
# --------------------------------------------------------------------------


def async_max_out(in_hz, out_hz, chunk=2048):
    """The serving bound of bench.py's async rows: steady state + slack."""
    L, M = reduce_ratio(in_hz, out_hz)
    return (chunk * M) // L + 128


def async_plan(in_hz, out_hz, taps, skew, chunk=2048, precision="highest"):
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = FirConfig(channels=1, taps=taps, ratio_num=L, ratio_den=M)
    out_cap = min(cfg.out_capacity, async_max_out(in_hz, out_hz, chunk))
    plan = b6.async_combine_plan(
        A=farrow_matrix(coeffs_for(in_hz, out_hz, taps))[0], L=L, M=M, out_cap=out_cap,
        skew_periods=skew, clamp_j=cfg.input_capacity + 2 if cfg.wide else None, precision=precision,
    )
    return cfg, plan


def async_bound(plan, L, n_out, res, R, C):
    """B6's least time for one call: the basis responses each lane's
    emitted outputs need (8 x taps multiply-adds at each distinct row
    ``floor((res + n*L)/M)``, n < n_out) plus the 8-term combine of every
    emitted output, at the f32 peak; against the ring rows those outputs
    cover (read once), the output written once and the lane words.  For
    B6b the responses take ``8 + 3 (dc + 1)`` bf16 products per tap, all
    counted at the bf16 tensor-core peak (the least the card could take
    for bf16 products)."""
    M, d1, taps = plan.M, plan.d1, plan.taps
    split = plan.precision == "bf16x4"
    per_tap = d1 + 3 * (plan.dc + 1) if split else d1
    rows = 0
    n = np.arange(max(n_out, 1), dtype=np.int64)
    for lane_res in np.unique(res):
        f = (int(lane_res) + n[:n_out] * L) // M
        rows += (1 + int((np.diff(f) > 0).sum()) if n_out else 0) * int((res == lane_res).sum())
    flop = 2 * per_tap * taps * rows + 2 * d1 * n_out * R
    covered = np.zeros(plan.reach + 1, bool)
    for j in plan.j[:n_out]:
        covered[j : j + 2 + taps + plan.skew - 1] = True
    nbytes = 4 * (int(covered.sum()) * R + plan.out_cap * R) + 16 * R
    return bound_ms(flop, nbytes, BF16_PEAK_TFLOPS if split else F32_PEAK_TFLOPS) + (flop, nbytes)


def b6b_issued(plan, n_out, R):
    """The work B6b's tensor-core kernel issues for one call: four bf16
    passes of 8 degrees x taps products per output and lane of every
    32-lane tile (padded lanes included) plus the combine; the rows each
    emitting tile stages, read once per lane tile, the output and the
    lane words.  Returns ``(bound ms, by, flop, bytes)`` at the bf16
    peak."""
    tp = plan.tiles
    lanes = -(-R // 32) * 32
    flop = 2 * 4 * plan.d1 * plan.taps * n_out * lanes + 2 * plan.d1 * n_out * R
    staged = 0
    for t in range(tp.n_tiles):
        n_emit = min(tp.outputs, n_out - t * tp.outputs)
        if n_emit > 0:
            staged += 2 * ((int(tp.win[t * tp.outputs + n_emit - 1]) + tp.window + 1) // 2) + 1
    nbytes = 4 * (staged * R + plan.out_cap * R) + 16 * R
    return bound_ms(flop, nbytes, BF16_PEAK_TFLOPS) + (flop, nbytes)


def b6_issued(plan, n_out, R, form=None):
    """The work B6 issues for one call: in the positions form, 8 degrees x
    taps multiply-adds at every position of each computed tile's passes,
    for every lane of each 32-lane tile (padded lanes included); in the
    per-output form the same per emitted output; plus the combine.  The
    bytes: the rows each tile stages, read once per lane tile, the output
    and the lane words.  Returns ``(bound ms, by, flop, bytes, positions
    or outputs contracted per lane)``."""
    tp = plan.f32_tiles(form)
    lanes = -(-R // 32) * 32
    units = staged = 0
    for t in range(tp.emit[n_out]):
        lo, hi = (int(v) for v in tp.tiles[t])
        n_e = min(hi, n_out) - 1
        if tp.form == "positions":
            pos = -(-(int(plan.j[n_e]) + plan.skew + 2 - int(tp.rowmap[t, 0])) // b6.F32_PASS) * b6.F32_PASS
            units += pos
            staged += pos + plan.taps
        else:
            units += n_e + 1 - lo
            staged += int(tp.aux[n_e]) + tp.window
    flop = 2 * plan.d1 * plan.taps * units * lanes + 2 * plan.d1 * n_out * R
    nbytes = 4 * (staged * R + plan.out_cap * R) + 16 * R
    return bound_ms(flop, nbytes) + (flop, nbytes, units)


def other_form(plan) -> str:
    """The B6 form that ``L/M`` does not pick."""
    return "outputs" if plan.f32_tiles().form == "positions" else "positions"


def b6_build_report() -> None:
    """B6's kernel as built: ptxas's registers and spills of each form
    (``combine_kernel<true>``: positions, ``<false>``: per output), none
    spilling."""
    log = _build.build_log()
    section = log[log.find("== fir_async_combine.cu"):].split("\n== ")[0]
    form = None
    for line in section.splitlines():
        if "Compiling entry" in line:
            form = None
            if "combine_kernelILb" in line:
                form = "positions" if "combine_kernelILb1" in line else "outputs"
        elif form is not None and ("registers" in line or "spill" in line):
            print(f"[11] B6 ptxas combine_kernel ({form} form): {line.strip()}")
            check("spill" not in line or " 0 bytes spill stores, 0 bytes spill loads" in line,
                  f"B6 combine_kernel ({form}) spills: {line.strip()}")
    if "combine_kernelILb" not in section:
        print("[11] B6 ptxas: not in the build log (cached build)")


def b6b_build_report() -> None:
    """B6b's tensor-core kernel as built: ptxas's registers and spills of
    each instantiation (``tc_combine_kernel<KS>``: 16 KS taps), none
    spilling, and the tensor-core ``HMMA`` instructions in its SASS."""
    log = _build.build_log()
    section = log[log.find("== fir_async_combine.cu"):].split("\n== ")[0]
    ks = None
    for line in section.splitlines():
        if "Compiling entry" in line:
            ks = int(line.split("tc_combine_kernelILi")[1].split("E")[0]) if "tc_combine_kernel" in line else None
        elif ks is not None and ("registers" in line or "spill" in line):
            print(f"[24] B6b ptxas tc_combine_kernel<{ks}> ({16 * ks} taps): {line.strip()}")
            check("spill" not in line or " 0 bytes spill stores, 0 bytes spill loads" in line,
                  f"B6b tc_combine_kernel<{ks}> spills: {line.strip()}")
    if "tc_combine_kernel" not in section:
        print("[24] B6b ptxas: not in the build log (cached build)")
    counts, where = sass_counts(_build.build()["fir_async_combine_bf16x4"]._name, ("HMMA",),
                                SOURCES["async_combine_bf16x4"][0], ("mma.sync",))
    check(all(counts.values()), f"B6b's tensor-core instructions in {where}: {counts}")
    print(f"[24] B6b in {where}: {counts}")


def phase_async_kernel(device, cases, precision="highest"):
    """B6 (or B6b, ``precision="bf16x4"``) against its plain version at
    each case's bases and ``n_out`` bounds; each case's times (plain,
    kernel, kernel, plain) against its bound.  The main case (the first)
    gives the kernel's line.  No single PyTorch call computes B6 (per-lane
    row offsets and per-stream skews are no uniform stride), so it has no
    library time.  For B6b also its build report, each case's tiles and
    shared memory, and the bound on the work it issues beside the row's
    bound."""
    entry = None
    worst = 0.0
    kname, phase = ("B6b", 24) if precision == "bf16x4" else ("B6", 11)
    if precision == "bf16x4":
        b6b_build_report()
    else:
        b6_build_report()
    for n, (name, in_hz, out_hz, taps, R, skew, starved) in enumerate(cases):
        L, M = reduce_ratio(in_hz, out_hz)
        cfg, plan = async_plan(in_hz, out_hz, taps, skew, precision=precision)
        ring = fir_fleets._ring_rows(cfg, 2048, 16)
        rng = np.random.default_rng(20 + n)
        buf = torch.from_numpy(rng.standard_normal((ring, R), dtype=np.float32)).to(device)
        C = 2 if R % 2 == 0 else 1
        res = np.repeat(rng.integers(0, M, R // C), C)
        base_rel = np.repeat(rng.integers(0, skew + 1 + (6 if starved else 0), R // C), C)
        check(not starved or int(base_rel.max()) > skew, f"{name}: the skew passes skew_periods")
        lanes = torch.from_numpy(np.stack([res, base_rel])).to(device)
        top = ring - plan.reach
        n_main = min(plan.out_cap, (2048 * M) // L)  # a steady-state step's emitted outputs
        err = 0.0
        calls = 0
        # B6: both forms, the one L/M picks and the other
        forms = (None,) if precision == "bf16x4" else (None, other_form(plan))
        for base0 in (0, 1, 3, 2 * (ring // 4) + 1, top):
            for n_out in {n_main, plan.out_cap, 1, 0}:
                ref = b6.async_combine_reference(buf, base0, n_out, lanes, plan)
                for form in forms:
                    got = b6.async_combine(buf, base0, n_out, lanes, plan, _form=form)
                    err = max(err, float((got - ref).abs().max()))
                    check(bool((got[n_out:] == 0).all()), f"{kname} {name}: masked lanes are zero")
                    calls += 1
        torch.cuda.synchronize()
        check(err <= KERNEL_ATOL, f"{kname} vs plain {name}: {err:.3e} > {KERNEL_ATOL}")
        worst = max(worst, err)
        rot = np.linspace(0, top, 8).astype(int).tolist()
        ms, plain_ms, t = timed_pair(
            lambda i: b6.async_combine(buf, rot[i % 8], n_main, lanes, plan),
            lambda i: b6.async_combine_reference(buf, rot[i % 8], n_main, lanes, plan),
        )
        b_ms, b_by, flop, nbytes = async_bound(plan, L, n_main, res, R, C)
        print(f"[{phase}] {kname} {name}: ring [{ring}, {R}], L/M {L}/{M}, out_cap {plan.out_cap}, skew {skew}: "
              f"max |kernel - plain| = {err:.3e} over {calls} calls")
        print(f"    n_out {n_main}: kernel {t[1]:.4f} / {t[2]:.4f} ms, plain {t[0]:.4f} / {t[3]:.4f} ms per "
              f"call; kernel {flop / ms / 1e9:.2f} TFLOP/s; bound {b_ms:.4f} ms ({b_by}: "
              f"{flop / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB; {100 * b_ms / ms:.1f}% of it reached)")
        if precision == "bf16x4":
            tp = plan.tiles
            i_ms, i_by, i_flop, i_bytes = b6b_issued(plan, n_main, R)
            print(f"    tiles: {tp.outputs} outputs x 32 lanes, <= {tp.rows} staged rows, {tp.smem_bytes} B "
                  f"shared; issued {i_flop / 1e9:.3f} GFLOP, {i_bytes / 1e6:.1f} MB, bound {i_ms:.4f} ms "
                  f"({i_by}; {100 * i_ms / ms:.1f}% of it reached)")
        else:
            for form in (None, other_form(plan)):
                tp = plan.f32_tiles(form)
                if form is None:
                    f_ms, how = ms, "picked by L/M"
                else:  # the other form, in turns with the one L/M picks
                    forced = lambda i, f=form: b6.async_combine(buf, rot[i % 8], n_main, lanes, plan, _form=f)
                    f_ms, picked_ms, _ = timed_pair(forced, lambda i: b6.async_combine(
                        buf, rot[i % 8], n_main, lanes, plan))
                    how = f"forced; in turns, the picked form {picked_ms:.4f} ms"
                i_ms, i_by, i_flop, i_bytes, units = b6_issued(plan, n_main, R, form)
                tile = (f"{tp.passes} passes of 32 positions" if tp.form == "positions"
                        else f"<= {tp.rows_pad} staged rows")
                print(f"    {tp.form} form ({how}): {tp.n_tiles} tiles of <= {tp.out_max} outputs, {tile}, "
                      f"{tp.smem_bytes} B shared; {f_ms:.4f} ms; issued {units} {tp.form} per lane, "
                      f"{i_flop / 1e9:.3f} GFLOP, {i_bytes / 1e6:.1f} MB, bound {i_ms:.4f} ms ({i_by}; "
                      f"{100 * i_ms / f_ms:.1f}% of it reached)")
        if entry is None:
            entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del buf
    torch.cuda.empty_cache()
    entry["max_abs_err"] = worst
    return entry


def async_positions(state, M, wide):
    """Each stream's exact position, in 1/M input frames."""
    if wide:
        return [int(h) * M + int(lo) for h, lo in zip(state["pos_hi"], state["pos_lo"])]
    return [int(p) for p in state["pos_num"]]


def expected_async_schedule(cfg, out_cap, pos, n_valid):
    """One async step as plain integer arithmetic on exact positions:
    ``(to_copy, n_out, consumed, positions')``.  The laggard (max) bounds
    the emission, the leader (min) the consumption."""
    L, M, cap, taps = cfg.ratio_num, cfg.ratio_den, cfg.input_capacity, cfg.taps
    avail, pos = pos[0], pos[1]
    to_copy = min(n_valid, cap - avail)
    avail += to_copy
    limit = (avail - taps + 1) * M - max(pos)
    n_out = min(-(-limit // L) if limit > 0 else 0, out_cap)
    after = [p + n_out * L for p in pos]
    consumed = min(min(after) // M, avail)
    return to_copy, n_out, consumed, (avail - consumed, [p - consumed * M for p in after])


def phase_async_fleet(device, smi, label, in_hz, out_hz, B=1024, C=2, max_chunk=2048, horizon=16,
                      n_steps=40, T=8, nbuf=8, warm=8, slew_at=20):
    """The async multi-tenant fleet at full width: every stream joins at
    its own phase; four streams are slewed part-way (toward the middle of
    the fleet's spread, so the skew invariant holds)."""
    L, M = reduce_ratio(in_hz, out_hz)
    max_out = async_max_out(in_hz, out_hz, max_chunk)
    rng = np.random.default_rng(7)
    phases = rng.integers(0, M, B)
    kw = dict(synchronized=True, sync_variant="async_tm", max_chunk=max_chunk, horizon=horizon,
              max_out=max_out)
    torch.cuda.reset_peak_memory_stats()
    fleet = BatchedResamplerFir(B, C, in_hz, out_hz, Latency.Sample64, Attenuation.Db90, device=device,
                                initial_positions=phases, **kw)
    cfg, wide = fleet.config, fleet.config.wide
    out_cap = min(cfg.out_capacity, max_out)
    chunks_np = [rng.standard_normal((B, max_chunk, C), dtype=np.float32) for _ in range(nbuf)]
    chunks = [torch.from_numpy(c).to(device) for c in chunks_np]
    many = torch.stack([chunks[(n_steps + t) % nbuf] for t in range(T)])
    lo, hi = int(phases.argmin()), int(phases.argmax())
    order = np.argsort(phases)
    slewed = [int(b) for b in order[B // 4 : B // 4 + 2]] + [int(b) for b in order[-B // 4 - 2 : -B // 4]]
    mirror = sorted({0, 1, 2, 3, lo, hi, *slewed})
    mirror_idx = torch.tensor(mirror, device=device)
    torch.cuda.synchronize()

    zero_launches()  # count only this path's own launches
    small, steps, fills, peaks = [], [], [], []
    slew_vec = np.zeros(B)
    t0 = time.perf_counter()
    for i in range(n_steps):
        if i == warm:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
        if i == slew_at:
            pos = async_positions(fleet.state, M, wide)
            mid = (min(pos) + max(pos)) / 2
            slew_vec[slewed] = [0.5 * (mid - pos[b]) / M for b in slewed]
            applied = fleet.slew(slew_vec)
        out, c, p, peak = fleet.resample(chunks[i % nbuf])
        small.append(out.index_select(0, mirror_idx))
        steps.append((int(c[0]), int(p[0])))
        fills.append(fleet.state["fill"])
        peaks.append(peak)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    dt, dt_warm = t_end - t0, t_end - t_warm
    t1 = time.perf_counter()
    outs, cs, ps, peak_many = fleet.resample_many(many)
    torch.cuda.synchronize()
    dt_many = time.perf_counter() - t1
    launches = dict(_build.LAUNCHES)
    steps += list(zip(cs.tolist(), ps.tolist()))

    # the schedule, recomputed on the host from the exact positions (out of
    # the timed loop)
    check(np.count_nonzero(applied) == len(slewed), f"{label}: the slew moved {slewed}")
    moved = np.round(applied * M).astype(np.int64).tolist()
    sched = (0, [int(p) for p in phases])
    for i, step in enumerate(steps):
        if i == slew_at:
            sched = (sched[0], [p + d for p, d in zip(sched[1], moved)])
        to_copy, n_out, _, sched = expected_async_schedule(cfg, out_cap, sched, max_chunk)
        check((to_copy, n_out) == step, f"{label}: step {i} {step} == host schedule {(to_copy, n_out)}")
    check(async_positions(fleet.state, M, wide) == sched[1], f"{label}: positions == host schedule")
    check(fleet.state["fill"] - fleet.state["start"] == sched[0], f"{label}: buffered frames == host schedule")
    total = n_steps + T
    check(launches == dict({k: 0 for k in launches}, async_combine=total),
          f"{label}: exactly one B6 launch per step and nothing else: {launches}")
    compactions = sum(b < a for a, b in zip(fills, fills[1:]))
    check(compactions >= 2, f"{label}: {compactions} compactions >= 2")
    check(tuple(out.shape) == (B, out_cap, C) and tuple(outs.shape) == (T, B, out_cap, C), f"{label}: shapes")
    check(bool(torch.isfinite(torch.stack(peaks)).all()) and bool(torch.isfinite(outs).all()),
          f"{label}: finite outputs")
    check(float(peak_many) > 0 and all(p > 0 for _, p in steps[1:]), f"{label}: every step emits")

    # the streams that set the schedule (laggard, leader), the slewed ones
    # and streams 0-3 replay on a CPU fleet of just those streams
    cpu = BatchedResamplerFir(len(mirror), C, in_hz, out_hz, Latency.Sample64, Attenuation.Db90,
                              device="cpu", initial_positions=phases[mirror], **kw)
    err = 0.0
    for i in range(total):
        if i == slew_at:
            cpu.slew(slew_vec[mirror])
        ref, c, p, _ = cpu.resample(chunks_np[i % nbuf][mirror])
        check((int(c[0]), int(p[0])) == steps[i], f"{label}: CPU mirror schedule at step {i}")
        got = small[i] if i < n_steps else outs[i - n_steps, mirror]
        err = max(err, float((got.cpu() - ref).abs().max()))
    check(err <= DEVICE_ATOL, f"{label}: vs CPU mirror {err:.3e} > {DEVICE_ATOL}")

    def rate(step_slice, seconds):
        return sum(p for _, p in step_slice) * B * C / seconds / 1e6

    print(f"[12] {label}: {B} streams x {C} ch, {in_hz} -> {out_hz} Hz taps 128, max_out {max_out}, "
          f"phases uniform in [0, M); {total} steps ({compactions} compactions), slew of streams {slewed} "
          f"at step {slew_at}; launches {launches}; schedule == host recomputation; streams {mirror} vs "
          f"CPU fleet max err {err:.3e}")
    print(f"    fleet: {rate(steps[warm:n_steps], dt_warm):.1f} Msamples/s over resample() calls "
          f"{warm + 1}-{n_steps} ({dt_warm * 1e3 / (n_steps - warm):.3f} ms/step); all {n_steps} calls "
          f"{rate(steps[:n_steps], dt):.1f}; first resample_many(T={T}) {rate(steps[n_steps:], dt_many):.1f} "
          f"Msamples/s [output frames x streams x channels per second, bench.py's async count; card: {smi}]")
    print(f"    peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    per_kernel = profile_steps(fleet, chunks)
    b6_us = sum(us for key, us in per_kernel.items() if "f32::combine_kernel" in key)
    n_out = steps[n_steps - 1][1]
    _, plan = async_plan(in_hz, out_hz, 128, 1)
    b_ms, b_by, _, _ = async_bound(plan, L, n_out, np.repeat(phases % M, C), B * C, C)
    print(f"    B6 in the profile: {b6_us / 1e3:.4f} ms/step against its bound {b_ms:.4f} ms ({b_by}) "
          f"at n_out {n_out} ({100 * b_ms * 1e3 / b6_us if b6_us else 0:.1f}% of it reached)")
    del fleet, chunks, many, outs, small
    torch.cuda.empty_cache()
    return launches["async_combine"]


def phase_async_alias(device):
    before = _build.LAUNCHES["async_combine"]
    kw = dict(sync_variant="async_tm", initial_positions=[0, 44101 // 2])
    db, n = alias_db(device, 48000, 44101, **kw)
    launches = _build.LAUNCHES["async_combine"] - before
    db_cpu, _ = alias_db("cpu", 48000, 44101, **kw)
    check(launches > 0, "the coprime tone ran through B6")
    check(abs(db - db_cpu) <= 0.5, f"B6 alias {db:.2f} dB vs CPU port {db_cpu:.2f} dB")
    check(db >= 100.0, f"B6 alias rejection {db:.1f} dB >= 100")
    print(f"[14] alias rejection through B6 (async fleet, 48000 -> 44101 Hz, 23 kHz tone): {db:.2f} dB "
          f"over {n} frames, {launches} launches; CPU port {db_cpu:.2f} dB")


def phase_async_streaming(device, smi, B=1024, C=2, chunk=1024, n_steps=6):
    """The serving runtime on the async fleet: ragged pushes per stream,
    each stream at its own phase, against the CPU runtime fed the same."""
    M = reduce_ratio(44100, 44101)[1]
    rng = np.random.default_rng(3)
    kw = dict(chunk_frames=chunk, synchronized="async", initial_positions=rng.integers(0, M, B))
    args = (B, C, 44100, 44101, Latency.Sample64, Attenuation.Db90)
    dev = StreamingFleet(*args, device=device, **kw)
    cpu = StreamingFleet(*args, device="cpu", **kw)
    fill_s, engine_s = [], []

    def timed(fn, into):
        def call(*args):
            t = time.perf_counter()
            got = fn(*args)
            torch.cuda.synchronize()
            into.append(time.perf_counter() - t)
            return got
        return call

    dev.pool.fill = timed(dev.pool.fill, fill_s)
    dev.engine.resample = timed(dev.engine.resample, engine_s)
    launches0 = _build.LAUNCHES["async_combine"]
    err, produced, step_s = 0.0, 0, []
    for _ in range(n_steps):
        for b in range(B):
            x = rng.standard_normal(C * int(rng.integers(chunk // 2, 2 * chunk))).astype(np.float32)
            check(dev.push(b, x) == x.size and cpu.push(b, x) == x.size, "push accepted")
        t = time.perf_counter()
        ys = dev.step()
        step_s.append(time.perf_counter() - t)
        for y, yc in zip(ys, cpu.step()):
            check(y.shape == yc.shape and bool(np.isfinite(y).all()), "async StreamingFleet outputs")
            err = max(err, float(np.abs(y - yc).max(initial=0.0)))
        produced += ys[0].size // C
    launches = _build.LAUNCHES["async_combine"] - launches0
    check(err <= DEVICE_ATOL, f"async StreamingFleet card vs CPU {err:.3e} > {DEVICE_ATOL}")
    check(launches == n_steps and produced > 0, f"async StreamingFleet: {launches} B6 launches, {produced} frames")
    print(f"[15] StreamingFleet({B}, {C}, 44100 -> 44101, synchronized='async', chunk {chunk}) on the card: "
          f"{n_steps} steps of ragged pushes, {produced} frames per stream, {launches} B6 launches; every "
          f"stream vs the CPU runtime max err {err:.3e}; step {1e3 * np.mean(step_s[1:]):.1f} ms of which "
          f"the host pool's drain {1e3 * np.mean(fill_s[1:]):.1f} ms and the fleet step "
          f"{1e3 * np.mean(engine_s[1:]):.1f} ms (steps 2-{n_steps}, host clock; card: {smi})")



# --------------------------------------------------------------------------
# phases 16-22: the end-aligned fleets (vmapped, slide) and kernels B9, B8
# --------------------------------------------------------------------------


#: the CUDA kernels of B9 and B8: the band form's two, the per-output form's one
STEP_KERNELS = ("band_step_kernel", "copy_in_kernel", "fleet_step_kernel")


def step_bound(cfg, n_out, B):
    """B8/B9's least time for one step: each emitted output's taps-wide dot
    (2 x taps operations per channel) at the f32 peak, against the bytes
    the step must move: per stream and channel the old columns the slide
    keeps and the chunk frames it copies (valid_end together), the new
    valid columns and the output lanes written, and the schedule."""
    C = cfg.channels
    flop = 2 * cfg.taps * C * int(np.broadcast_to(n_out, (B,)).sum())
    nbytes = 4 * C * B * (2 * cfg.input_capacity + cfg.out_capacity) + 16 * B
    return bound_ms(flop, nbytes) + (flop, nbytes)


def step_case(device, in_hz, out_hz, taps, B, C, n, ragged, seed):
    """A fleet state and feed at the shapes the end-aligned fleets hand
    B9 and B8: a steady-state buffer (127 frames left after the last
    consume, 44.1 -> 48 kHz's), or ragged per-stream frames, positions and
    valid counts (0, 1 or full) with NaN junk past them."""
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    plan = b9.FleetStepPlan(cfg, coeffs_for(in_hz, out_hz, taps))
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((B, C, cfg.buffer_alloc), dtype=np.float32)
    buf[:, :, cfg.input_capacity:] = 0.0  # the zero slack of every state
    if ragged:
        avail = rng.integers(0, 600, B)
        pos = rng.integers(0, 3 * M, B)
        nv = rng.choice([0, 1, n], B)
    else:
        avail, pos, nv = np.full(B, taps - 1), np.full(B, M // 3), np.full(B, n)
    chunks = rng.standard_normal((B, n, C), dtype=np.float32)
    shared = chunks.copy()  # B8's feed: junk past the shared count
    shared[:, int(nv[-1]):] = np.nan
    chunks[np.arange(n)[None, :] >= nv[:, None]] = np.nan
    t = {k: torch.from_numpy(v).to(device) for k, v in (("buf", buf), ("chunks", chunks),
                                                          ("shared", shared))}
    return cfg, plan, t, avail, pos, nv, np.full(B, cfg.out_capacity)


def band_build_report() -> dict:
    """ptxas's registers, shared memory and spills of each instantiation
    of the band form's contraction (``band_step_kernel<R>``), by ``R``."""
    log = _build.build_log()
    section = log[log.find("== fir_fleet_step.cu"):].split("\n== ")[0]
    report, R = {}, None
    for line in section.splitlines():
        if "Compiling entry" in line or "Function properties" in line:
            R = None
            if "band_step_kernel" in line:
                R = int(line.split("band_step_kernelILi")[1].split("E")[0])
        elif R is not None and ("registers" in line or "spill" in line):
            report[R] = f"{report[R]}; {line.strip()}" if R in report else line.strip()
    return report


def phase_step_kernels(device, cases):
    """B9 and B8 against their plain version at each case, in the form
    each case's plan takes (every case here: the band form); times
    (plain, kernel, kernel, plain) against the bound.  The main case (the
    first) also checks and times the per-output form (old, band, band,
    old) and gives the kernels' line, with one ``torch.matmul`` of its
    shared atlas window over the ``as_strided`` window view of the new
    buffer (the contraction alone) as the library yardstick."""
    entries = {}
    ptxas = band_build_report()
    for n_case, (name, in_hz, out_hz, taps, B, C, n, ragged) in enumerate(cases):
        cfg, plan, t, avail, pos, nv, budget = step_case(device, in_hz, out_hz, taps, B, C, n,
                                                         ragged, 30 + n_case)
        buf, chunks, shared = t["buf"], t["chunks"], t["shared"]
        tile = plan.tile
        check(plan.form == "band", f"B9/B8 {name}: the band form ({plan.form})")
        print(f"[16] B9/B8 {name}: form {plan.form}, R {tile.R}, {tile.warps} warps x 32 rows, band "
              f"{tile.band_w} x {tile.Rp}, window {tile.win} (pitch {tile.pitch}), "
              f"{tile.smem_bytes} B shared, q tiles {tile.q_tiles(False)} / {tile.q_tiles(True)}; "
              f"ptxas band_step_kernel<{tile.R}>: {ptxas.get(tile.R, 'not in the build log (cached build)')}")
        spare = torch.zeros_like(buf)
        got = b9.fir_fleet_step(plan, buf, chunks, avail, pos, nv, budget, out_buffers=spare)
        ref = b9.fir_fleet_step_reference(plan, buf, chunks, avail, pos, nv, budget)
        torch.cuda.synchronize()
        check(all(np.array_equal(g, r) for g, r in zip(got[2:], ref[2:])), f"B9 {name}: ints")
        check(torch.equal(got[0], ref[0]), f"B9 {name}: buffers bit-equal")
        check(bool(torch.isfinite(got[1]).all()), f"B9 {name}: finite outputs (the NaN fence)")
        err9 = float((got[1] - ref[1]).abs().max())
        sargs = (int(avail[-1]), int(pos[-1]), int(nv[-1]))
        err8 = 0.0
        for cm in (False, True):
            feed = shared.transpose(1, 2).contiguous() if cm else shared
            gs = b8.fir_fleet_step_sync(plan, buf, feed, *sargs, channel_major=cm)
            rs = b8.fir_fleet_step_sync_reference(plan, buf, feed, *sargs, channel_major=cm)
            torch.cuda.synchronize()
            check(gs[2:] == rs[2:] and torch.equal(gs[0], rs[0]), f"B8 {name}: ints, buffers")
            err8 = max(err8, float((gs[1] - rs[1]).abs().max()))
        check(max(err9, err8) <= KERNEL_ATOL, f"B9/B8 vs plain {name}: {err9:.3e} / {err8:.3e}")
        print(f"[16] B9/B8 {name}: buffers [{B}, {C}, {cfg.buffer_alloc}], L/M {cfg.ratio_num}/"
              f"{cfg.ratio_den}, out_cap {cfg.out_capacity}, n_out {int(got[5].min())}-"
              f"{int(got[5].max())}: max |kernel - plain| B9 {err9:.3e}, B8 {err8:.3e} "
              "(buffers bit-equal, ints equal)")
        # kernel and plain version on the same host schedule, made once:
        # the wrappers' per-call numpy schedule and upload are host work
        # the kernel's time should not include
        s9 = b9.schedule(plan, avail, pos, nv, budget, n)
        s8 = b9.schedule(plan, *([v] for v in sargs[:3]), [cfg.out_capacity], n)
        dev_rows = {
            k: torch.from_numpy(np.stack([sc[f] for f in ("to_copy", "n_out", "base", "r")], 1)
                                .astype(np.int32)).to(device)
            for k, sc in (("fir_fleet_step", s9), ("fir_fleet_step_sync", s8))
        }
        times = {}
        for kname, feed, sc in (("fir_fleet_step", chunks, s9), ("fir_fleet_step_sync", shared, s8)):
            rows_k = dev_rows[kname]
            kn = "B9" if kname == "fir_fleet_step" else "B8"
            ms, plain_ms, tt = timed_pair(
                lambda i: b9.launch_step(plan, buf, feed, rows_k, spare, kname),
                lambda i: b9.step_reference(plan, buf, feed, sc, None),
                plain_reps=5,  # ~15 ms a call at full width
            )
            b_ms, b_by, flop, nbytes = step_bound(cfg, sc["n_out"], B)
            times[kname] = (ms, plain_ms, b_ms, b_by)
            print(f"    {kn}: kernel {tt[1]:.4f} / "
                  f"{tt[2]:.4f} ms, plain {tt[0]:.4f} / {tt[3]:.4f} ms per call; bound {b_ms:.4f} ms "
                  f"({b_by}: {flop / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB; {100 * b_ms / ms:.1f}% "
                  "of it reached)")
            if n_case == 0:
                # the per-output form on the same step: right, then timed in
                # turns with the band form (old, band, band, old)
                old = b9.launch_step(plan, buf, feed, rows_k, torch.zeros_like(buf), kname,
                                     _form="thread")
                ref_k = b9.step_reference(plan, buf, feed, sc, None)
                torch.cuda.synchronize()
                err_old = float((old[1] - ref_k[1]).abs().max())
                check(torch.equal(old[0], ref_k[0]) and err_old <= KERNEL_ATOL,
                      f"{kn} per-output form {name}: {err_old:.3e}")
                del old, ref_k
                band_ms, old_ms, to = timed_pair(
                    lambda i: b9.launch_step(plan, buf, feed, rows_k, spare, kname),
                    lambda i: b9.launch_step(plan, buf, feed, rows_k, spare, kname, _form="thread"),
                )
                print(f"    {kn} forms in turns: per-output {to[0]:.4f} / {to[3]:.4f} ms, band "
                      f"{to[1]:.4f} / {to[2]:.4f} ms per call ({old_ms / band_ms:.2f}x); per-output "
                      f"form vs plain {err_old:.3e}")
        if not entries:
            L, M, span, K = cfg.ratio_num, cfg.ratio_den, plan.span, plan.K
            new, R = ref[0], B * C
            base = int(b9.schedule(plan, avail, pos, nv, budget, n)["base"][0])
            i0 = ((int(pos[0]) % M) * plan.l_inv) % M
            c0 = (i0 * L) // M
            a = plan.tables(device)["a2"][i0 : i0 + M, c0 : c0 + span].contiguous()

            def library(i):
                view = new.as_strided((R, span, K), (cfg.buffer_alloc, 1, L), base)
                return torch.matmul(a, view)  # [R, M, K]

            lib = library(0).view(B, C, M, K).permute(0, 3, 2, 1).reshape(B, K * M, C)
            lib_n = int(got[5][0])
            lib_err = float((lib[:, :lib_n] - ref[1][:, :lib_n]).abs().max())
            del lib
            lib_ms = elapsed_ms(library, 20)
            print(f"    library torch.matmul(atlas window, as_strided window view of the new buffer), "
                  f"the contraction alone: {lib_ms:.4f} ms, max |library - plain| {lib_err:.3e}")
            for kname, (ms, plain_ms, b_ms, b_by) in times.items():
                entries[kname] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                      library_ms=lib_ms, max_abs_err=0.0)
        entries["fir_fleet_step"]["max_abs_err"] = max(entries["fir_fleet_step"]["max_abs_err"], err9)
        entries["fir_fleet_step_sync"]["max_abs_err"] = max(
            entries["fir_fleet_step_sync"]["max_abs_err"], err8)
        del t, buf, chunks, shared, spare, got, ref
        torch.cuda.empty_cache()
    return entries


def expected_stream_schedules(cfg, B, nvs):
    """Every stream's schedule as plain integer arithmetic, one stream at
    a time: ``(to_copy [B], n_out [B])`` per step."""
    L, M, cap, taps, out_cap = (
        cfg.ratio_num, cfg.ratio_den, cfg.input_capacity, cfg.taps, cfg.out_capacity
    )
    avail, pos = [0] * B, [0] * B
    for nv in nvs:
        tc, no = [], []
        for b in range(B):
            to_copy = min(int(nv[b]), cap - avail[b])
            a = avail[b] + to_copy
            limit = (a - taps + 1) * M - pos[b]
            n_out = min(-(-limit // L) if limit > 0 else 0, out_cap)
            p = pos[b] + n_out * L
            consumed = min(p // M, a)
            avail[b], pos[b] = a - consumed, p - consumed * M
            tc.append(to_copy)
            no.append(n_out)
        yield np.asarray(tc), np.asarray(no)


def phase_vmapped_fleet(device, smi, B=1024, C=2, n=4096, n_steps=40, T=8, nbuf=8, mirror=4, warm=8):
    """The default fleet (``synchronized=False``) at bench.py:44's width:
    every fifth call feeds each stream 0, 1, n/3 or n frames, so the
    streams' schedules diverge."""
    torch.cuda.reset_peak_memory_stats()
    args = (C, 44100, 48000, Latency.Sample64, Attenuation.Db90)
    fleet = BatchedResamplerFir(B, *args, device=device)
    cfg = fleet.config
    rng = np.random.default_rng(7)
    chunks_np = [rng.standard_normal((B, n, C), dtype=np.float32) for _ in range(nbuf)]
    chunks = [torch.from_numpy(c).to(device) for c in chunks_np]
    nvs = [rng.choice([0, 1, n // 3, n], B) if i % 5 == 4 else np.full(B, n)
           for i in range(n_steps + T)]
    many = torch.stack([chunks[(n_steps + t) % nbuf] for t in range(T)])
    torch.cuda.synchronize()

    zero_launches()  # count only this path's own launches
    small, steps, peaks = [], [], []
    t0 = time.perf_counter()
    for i in range(n_steps):
        if i == warm:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
        out, c, p, peak = fleet.resample(chunks[i % nbuf], nvs[i])
        small.append(out[:mirror].clone())
        steps.append((c, p))
        peaks.append(peak)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    t1 = time.perf_counter()
    outs, cs, ps, peak_many = fleet.resample_many(many, np.stack(nvs[n_steps:]))
    torch.cuda.synchronize()
    dt_many = time.perf_counter() - t1
    launches = dict(_build.LAUNCHES)
    steps += list(zip(cs, ps))
    total = n_steps + T

    for i, (want_c, want_p) in enumerate(expected_stream_schedules(cfg, B, nvs)):
        check(np.array_equal(steps[i][0], want_c) and np.array_equal(steps[i][1], want_p),
              f"vmapped fleet: step {i}: every stream's schedule == host recomputation")
    emitting = sum(int(p.max()) > 0 for _, p in steps)
    check(emitting == total, f"vmapped fleet: every step emits ({emitting} of {total})")
    check(any(len(set(p.tolist())) > 1 for _, p in steps), "vmapped fleet: the schedules diverged")
    check(launches == dict({k: 0 for k in launches}, fir_fleet_step=emitting),
          f"vmapped fleet: one B9 launch per emitting step and nothing else: {launches}")
    check(tuple(out.shape) == (B, cfg.out_capacity, C) and tuple(outs.shape) == (T, B, cfg.out_capacity, C),
          "vmapped fleet: shapes")
    check(bool(torch.isfinite(torch.stack(peaks)).all()) and bool(torch.isfinite(outs).all()),
          "vmapped fleet: finite outputs")

    cpu = BatchedResamplerFir(mirror, *args, device="cpu")
    err = 0.0
    for i in range(total):
        ref, c, p, _ = cpu.resample(chunks_np[i % nbuf][:mirror], nvs[i][:mirror])
        check(np.array_equal(c, steps[i][0][:mirror]) and np.array_equal(p, steps[i][1][:mirror]),
              f"vmapped fleet: CPU mirror schedule at step {i}")
        got = small[i] if i < n_steps else outs[i - n_steps, :mirror]
        err = max(err, float((got.cpu() - ref).abs().max()))
    check(err <= DEVICE_ATOL, f"vmapped fleet vs CPU mirror {err:.3e} > {DEVICE_ATOL}")

    def rate(step_slice, seconds):
        return sum(int(p.sum()) for _, p in step_slice) / seconds / 1e6

    dt_warm, dt = t_end - t_warm, t_end - t0
    print(f"[17] vmapped fleet: {B} streams x {C} ch, 44100 -> 48000 Hz taps 128, chunk {n}, every fifth "
          f"call ragged per stream; {total} steps, launches {launches}; every stream's schedule == host "
          f"recomputation; streams 0-{mirror - 1} vs CPU fleet max err {err:.3e}")
    print(f"    fleet: {rate(steps[warm:n_steps], dt_warm):.1f} Msamples/s over resample() calls "
          f"{warm + 1}-{n_steps} ({dt_warm * 1e3 / (n_steps - warm):.3f} ms/step); all {n_steps} calls "
          f"{rate(steps[:n_steps], dt):.1f}; first resample_many(T={T}) {rate(steps[n_steps:], dt_many):.1f} "
          f"Msamples/s [output frames x streams per second, phase 4's count; card: {smi}]")
    print(f"    peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    per_kernel = profile_steps(fleet, chunks)
    b9_us = sum(us for key, us in per_kernel.items() if any(k in key for k in STEP_KERNELS))
    check(b9_us > 0, "the profile saw B9's kernels")
    b_ms, b_by, _, _ = step_bound(cfg, steps[n_steps - 2][1], B)
    print(f"    B9 in the profile: {b9_us / 1e3:.4f} ms/step against its bound {b_ms:.4f} ms ({b_by}) "
          f"at a full-feed step ({100 * b_ms * 1e3 / b9_us if b9_us else 0:.1f}% of it reached)")
    del fleet, chunks, many, outs, small
    torch.cuda.empty_cache()
    return launches["fir_fleet_step"]


def phase_vmapped_farrow(device, smi, B=256, C=2, n=2048, n_steps=12, mirror=4):
    """The vmapped fleet on a coprime pair at bench.py:142's width: the
    batched Farrow convolve in torch ops (the JAX package leaves it to
    XLA), no hand-written kernel."""
    args = (C, 44100, 44101, Latency.Sample64, Attenuation.Db90)
    fleet = BatchedResamplerFir(B, *args, device=device)
    cpu = BatchedResamplerFir(mirror, *args, device="cpu")
    rng = np.random.default_rng(8)
    zero_launches()
    err, produced, dt = 0.0, 0, 0.0
    for i in range(n_steps):
        x = rng.standard_normal((B, n, C), dtype=np.float32)
        nv = rng.choice([0, n // 2, n], B) if i % 3 == 2 else np.full(B, n)
        xd = torch.from_numpy(x).to(device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, c, p, _ = fleet.resample(xd, nv)
        torch.cuda.synchronize()
        if i >= 2:
            dt += time.perf_counter() - t
            produced += int(p.sum())
        ref, cc, pc, _ = cpu.resample(x[:mirror], nv[:mirror])
        check(np.array_equal(cc, c[:mirror]) and np.array_equal(pc, p[:mirror]), f"farrow mirror ints {i}")
        err = max(err, float((out[:mirror].cpu() - ref).abs().max()))
    check(err <= DEVICE_ATOL, f"vmapped farrow fleet vs CPU {err:.3e}")
    check(sum(_build.LAUNCHES.values()) == 0, f"vmapped farrow fleet launched no kernel: {_build.LAUNCHES}")
    print(f"[18] vmapped farrow fleet: {B} streams x {C} ch, 44100 -> 44101 Hz, chunk {n}, {n_steps} "
          f"steps (ragged every third): torch ops, no kernel; streams 0-{mirror - 1} vs CPU max err "
          f"{err:.3e}; {produced / dt / 1e6:.1f} Msamples/s over calls 3-{n_steps} "
          f"({dt * 1e3 / (n_steps - 2):.3f} ms/step, host clock; card: {smi})")


def phase_slide_fleet(device, smi, B=1024, C=2, n=4096, n_steps=40, T=8, nbuf=8, timed=24):
    """The slide fleet at full width, in lockstep with the time-major
    fleet on the same feed, then timed alone."""
    torch.cuda.reset_peak_memory_stats()
    args = (B, C, 44100, 48000, Latency.Sample64, Attenuation.Db90)
    slide = BatchedResamplerFir(*args, synchronized=True, sync_variant="slide", device=device)
    tm = BatchedResamplerFir(*args, synchronized=True, max_chunk=n, device=device)
    rng = np.random.default_rng(9)
    chunks = [torch.from_numpy(rng.standard_normal((B, n, C), dtype=np.float32)).to(device)
              for _ in range(nbuf)]
    many = torch.stack([chunks[(n_steps + t) % nbuf] for t in range(T)])
    torch.cuda.synchronize()
    zero_launches()
    err, steps = 0.0, []
    for i in range(n_steps):
        os_, cs_, ps_, _ = slide.resample(chunks[i % nbuf])
        ot, ct, pt, _ = tm.resample(chunks[i % nbuf])
        check(np.array_equal(cs_, ct) and np.array_equal(ps_, pt), f"slide vs tm ints at step {i}")
        err = max(err, float((os_ - ot).abs().max()))
        steps.append(int(ps_[0]))
    os_, cs_, ps_, _ = slide.resample_many(many)
    ot, ct, pt, _ = tm.resample_many(many)
    check(np.array_equal(cs_, ct) and np.array_equal(ps_, pt), "slide vs tm resample_many ints")
    err = max(err, float((os_ - ot).abs().max()))
    steps += ps_.tolist()
    launches = dict(_build.LAUNCHES)
    emitting = sum(p > 0 for p in steps)
    # two f32 sums of 128 taps in different orders; the JAX suite's 2e-6
    # (tests/test_batched.py:186) is for 32 taps, and the CPU port's slide
    # and tm fleets already differ by 2.4e-6 at 128
    check(err <= SLIDE_TM_ATOL, f"slide vs tm fleet {err:.3e} > {SLIDE_TM_ATOL}")
    check(launches == dict({k: 0 for k in launches}, fir_fleet_step_sync=len(steps),
                           dma_banded_contract=emitting) and emitting == len(steps),
          f"slide fleet: one B8 launch per emitting step (and one B1 for the tm fleet): {launches}")
    del tm, os_, ot
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    produced = 0
    for i in range(timed):
        _, _, p, _ = slide.resample(chunks[i % nbuf])
        produced += int(p[0]) * B
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[19] slide fleet: {B} streams x {C} ch, 44100 -> 48000 Hz taps 128, chunk {n}: "
          f"{len(steps)} steps in lockstep with the tm fleet, launches {launches}; max |slide - tm| "
          f"{err:.3e}")
    print(f"    fleet: {produced / dt / 1e6:.1f} Msamples/s over {timed} more resample() calls "
          f"({dt * 1e3 / timed:.3f} ms/step) [output frames x streams per second; card: {smi}]")
    print(f"    peak device memory (with the tm fleet) {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    per_kernel = profile_steps(slide, chunks)
    b8_us = sum(us for key, us in per_kernel.items() if any(k in key for k in STEP_KERNELS))
    check(b8_us > 0, "the profile saw B8's kernels")
    b_ms, b_by, _, _ = step_bound(slide.config, steps[n_steps - 1], B)
    print(f"    B8 in the profile: {b8_us / 1e3:.4f} ms/step against its bound {b_ms:.4f} ms ({b_by}) "
          f"({100 * b_ms * 1e3 / b8_us if b8_us else 0:.1f}% of it reached)")
    del slide, chunks, many
    torch.cuda.empty_cache()
    return launches["fir_fleet_step_sync"]


def phase_end_aligned_differential(device, in_hz, out_hz, B=3, C=2, n=1024, n_steps=20, **kw):
    """Card against CPU on a small vmapped or slide fleet: ragged feeds
    with NaN junk past the valid frames, a slew part-way."""
    args = (B, C, in_hz, out_hz, Latency.Sample64, Attenuation.Db90)
    dev = BatchedResamplerFir(*args, device=device, **kw)
    cpu = BatchedResamplerFir(*args, device="cpu", **kw)
    rng = np.random.default_rng(12)
    err = 0.0
    for i in range(n_steps):
        nv = rng.integers(0, n + 1, B)
        nv[i % B] = n
        x = rng.standard_normal((B, n, C), dtype=np.float32)
        valid = np.full(B, nv.min()) if kw else nv  # the slide fleet feeds the minimum
        x[np.arange(n)[None, :] >= valid[:, None]] = np.nan
        od, cd, pd, kd = dev.resample(x, nv)
        oc, cc, pc, kc = cpu.resample(x, nv)
        check(np.array_equal(cd, cc) and np.array_equal(pd, pc), f"ints at step {i}")
        err = max(err, float((od.cpu() - oc).abs().max()), abs(float(kd) - float(kc)))
        if i == 9:
            s = 0.3 if kw else [0.3, -0.2, 2.0]
            check(np.array_equal(dev.slew(s), cpu.slew(s)), "slew")
        sd, sc = dev.state, cpu.state
        check(all(np.array_equal(sd[k], sc[k]) for k in sc if k != "buffer"), f"state ints at step {i}")
        check(torch.equal(sd["buffer"].cpu(), sc["buffer"]), f"buffer bit-equal at step {i}")
    check(err <= DEVICE_ATOL, f"card vs CPU {in_hz}->{out_hz} {kw}: {err:.3e} > {DEVICE_ATOL}")
    print(f"[20] card vs CPU, {in_hz} -> {out_hz} Hz ({kw.get('sync_variant', 'vmapped')}): {B}-stream "
          f"stereo fleet, {n_steps} ragged steps with NaN junk: ints equal, buffers bit-equal, max "
          f"|card - CPU| = {err:.3e}")


def phase_end_aligned_alias(device):
    for label, name, kw in (("B9 (vmapped fleet)", "fir_fleet_step", dict(synchronized=False)),
                            ("B8 (slide fleet)", "fir_fleet_step_sync",
                             dict(synchronized=True, sync_variant="slide"))):
        before = _build.LAUNCHES[name]
        db, n = alias_db(device, 48000, 44100, **kw)
        launches = _build.LAUNCHES[name] - before
        check(launches > 0, f"the tone ran through {label}")
        check(db >= 100.0, f"alias rejection through {label} {db:.1f} dB >= 100")
        print(f"[21] alias rejection through {label} (48 -> 44.1 kHz, 23 kHz tone): {db:.1f} dB over "
              f"{n} frames, {launches} launches")


def phase_vmapped_streaming(device, smi, B=64, C=8, chunk=2048, n_steps=6):
    """BASELINE config 5: 64 concurrent 8-channel streams with arbitrary
    input sizes, on the default runtime (the vmapped fleet)."""
    rng = np.random.default_rng(13)
    args = (B, C, 44100, 48000, Latency.Sample64, Attenuation.Db90)
    dev = StreamingFleet(*args, chunk_frames=chunk, device=device)
    cpu = StreamingFleet(*args, chunk_frames=chunk, device="cpu")
    fill_s, engine_s = [], []

    def timed(fn, into):
        def call(*a):
            t = time.perf_counter()
            got = fn(*a)
            torch.cuda.synchronize()
            into.append(time.perf_counter() - t)
            return got
        return call

    dev.pool.fill = timed(dev.pool.fill, fill_s)
    dev.engine.resample = timed(dev.engine.resample, engine_s)
    launches0 = _build.LAUNCHES["fir_fleet_step"]
    err, produced, step_s = 0.0, 0, []
    for _ in range(n_steps):
        for b in range(B):
            x = rng.standard_normal(C * int(rng.integers(0, 2 * chunk))).astype(np.float32)
            check(dev.push(b, x) == x.size and cpu.push(b, x) == x.size, "push accepted")
        t = time.perf_counter()
        ys = dev.step()
        step_s.append(time.perf_counter() - t)
        for y, yc in zip(ys, cpu.step()):
            check(y.shape == yc.shape and bool(np.isfinite(y).all()), "StreamingFleet outputs")
            err = max(err, float(np.abs(y - yc).max(initial=0.0)))
        produced += sum(y.size for y in ys) // C
    launches = _build.LAUNCHES["fir_fleet_step"] - launches0
    check(err <= DEVICE_ATOL, f"StreamingFleet card vs CPU {err:.3e} > {DEVICE_ATOL}")
    check(launches == n_steps and produced > 0, f"StreamingFleet: {launches} B9 launches, {produced} frames")
    print(f"[22] StreamingFleet({B}, {C}, 44100 -> 48000, chunk {chunk}; the vmapped fleet) on the card: "
          f"{n_steps} steps of ragged pushes (0-2 chunks per stream), {produced} frames over all streams, "
          f"{launches} B9 launches; every stream vs the CPU runtime max err {err:.3e}; step "
          f"{1e3 * np.mean(step_s[1:]):.1f} ms of which the host pool's drain {1e3 * np.mean(fill_s[1:]):.1f} "
          f"ms and the fleet step {1e3 * np.mean(engine_s[1:]):.1f} ms (steps 2-{n_steps}, host clock; "
          f"card: {smi})")


# --------------------------------------------------------------------------
# phases 23-27: the bf16 split-precision forms, kernels B7 and B6b
# --------------------------------------------------------------------------


def b7_build_report() -> None:
    """B7's kernels as built: ptxas's registers, shared memory and spills,
    and the Hopper instructions in the library's SASS (``HGMMA``, the wgmma;
    ``UTMALDG``, the TMA load), or, where no disassembler exists, in the
    source that the build compiled."""
    log = _build.build_log()
    section = log[log.find("== matmul3.cu"):].split("\n== ")[0]
    for line in section.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line or "wgmma" in line:
            print(f"[23] ptxas: {line.strip()}")
    libs = _build.build()
    print(f"[23] B7's GEMM: {libs['matmul3_gemm_smem'].matmul3_gemm_smem()} bytes of dynamic shared memory per "
          f"block; ptxas's count is the 384-thread launch bound's, setmaxnreg then gives the consumer "
          f"warpgroups 232 registers and the producer 40")
    counts, where = sass_counts(libs["matmul3_gemm"]._name, ("HGMMA", "UTMALDG"), SOURCES["matmul3"][0],
                                ("wgmma.mma_async", "cp.async.bulk.tensor"))
    check(all(counts.values()), f"B7's wgmma and TMA instructions in {where}: {counts}")
    print(f"[23] B7 in {where}: {counts}")


def phase_matmul3_kernel(device):
    """B7 against its plain version at its paths' shapes, NaN and Inf rows
    confined to their rows, the floor against f64; times (plain, kernel,
    kernel, plain) against the bound and one f32 ``torch.matmul`` of the
    same product (TF32 off) as the library yardstick.  The FFT projector
    gives the kernel's line."""
    entry, worst = None, 0.0
    gen = torch.Generator(device=device)
    gen.manual_seed(41)
    b7_build_report()

    # (a) the FFT projector at 8192 stereo streams, three passes; the calls
    # rotate over 8 inputs (616 MB) so that each finds its rows outside L2
    T = fft_engine.get_projection_matrix(1176, 1280)
    t_hi, t_lo = (h.to(device) for h in m3.split_weight(torch.from_numpy(T)))
    pool = torch.randn((8, 16384, 1176), generator=gen, device=device)
    got = m3.matmul3(pool[0], t_hi, t_lo, passes=3)
    ref = m3.matmul3_reference(pool[0], t_hi, t_lo, passes=3)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    check(err <= KERNEL_ATOL, f"B7 vs plain at the projector: {err:.3e} > {KERNEL_ATOL}")
    worst = max(worst, err)
    ref64 = pool[0, :64].double() @ torch.from_numpy(T).to(device).double()

    def floor(out):
        e = out[:64].double() - ref64
        return float(-20 * torch.log10(e.pow(2).mean().sqrt() / ref64.pow(2).mean().sqrt()))

    fl_kernel, fl_plain = floor(got), floor(ref)
    check(fl_kernel >= 99.0, f"B7 floor at the projector {fl_kernel:.2f} dB >= 99")
    # the two launches apart on one call: the split pass against its plain
    # version, then the GEMM in both accumulation forms and both column tiles
    call = m3._prepare(pool[0], t_hi, t_lo, 3, None)
    m3._split(call)
    want = m3.split_pass_reference(call.x3, call.plan.Kp)
    check(torch.equal(call.x_hi, want[0]) and torch.equal(call.x_lo, want[1]),
          "B7 split pass == split_pass_reference bit for bit")
    del want
    forms = {}
    for promote in (0, 1):
        m3._gemm(call, 3, promote)
        torch.cuda.synchronize()
        forms[promote] = (float((call.out - ref).abs().max()),
                          elapsed_ms(lambda i: m3._gemm(call, 3, promote), 20))
    check(forms[m3._PROMOTE][0] <= KERNEL_ATOL, f"B7's kept form at the projector: {forms[m3._PROMOTE][0]:.3e}")
    split_ms = elapsed_ms(lambda i: m3._split(call), 20)
    del call
    ms, plain_ms, t = timed_pair(
        lambda i: m3.matmul3(pool[i % 8], t_hi, t_lo, passes=3),
        lambda i: m3.matmul3_reference(pool[i % 8], t_hi, t_lo, passes=3),
        plain_reps=5,
    )
    t32 = torch.from_numpy(T).to(device)
    lib = torch.matmul(pool[0], t32)
    lib_err = float((lib - ref).abs().max())
    del lib, got, ref
    lib_ms = elapsed_ms(lambda i: torch.matmul(pool[i % 8], t32), 20)
    M_, K_, N_ = 16384, 1176, 2560
    flop = 2 * M_ * K_ * N_ * 3
    nbytes = 4 * M_ * K_ + 2 * 2 * K_ * N_ + 4 * M_ * N_
    b_ms, b_by = bound_ms(flop, nbytes, BF16_PEAK_TFLOPS)
    print(f"[23] B7 projector [{M_}, {K_}] @ [{K_}, {N_}], 3 passes: max |kernel - plain| = {err:.3e}; "
          f"floor vs f64 (64 rows) kernel {fl_kernel:.2f} dB, plain {fl_plain:.2f} dB")
    print(f"    kernel {t[1]:.4f} / {t[2]:.4f} ms, plain {t[0]:.4f} / {t[3]:.4f} ms per call; kernel "
          f"{flop / ms / 1e9:.1f} TFLOP/s ({100 * b_ms / ms:.1f}% of the bound {b_ms:.4f} ms, {b_by}: "
          f"{flop / 1e9:.1f} GFLOP at {BF16_PEAK_TFLOPS:.0f} TFLOP/s bf16, {nbytes / 1e6:.1f} MB); library "
          f"f32 torch.matmul(x, T), TF32 off: {lib_ms:.4f} ms, max |library - plain| {lib_err:.3e}")
    print(f"    split pass {split_ms:.4f} ms (== its plain version bit for bit); GEMM: chained accumulator "
          f"{forms[0][1]:.4f} ms, max |kernel - plain| {forms[0][0]:.3e}; per-K-tile promotion {forms[1][1]:.4f} "
          f"ms, {forms[1][0]:.3e}; kept: {('chained', 'promoted')[m3._PROMOTE]}")
    entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    del pool, t32

    # (b) the main path's tm window, four passes, at several atlas windows
    # and bases: the overlapping ring view and the time-major output view
    L, M, taps, R = 147, 160, 128, 2048
    cfg = FirConfig(channels=2, taps=taps, ratio_num=L, ratio_den=M)
    span, K = L + taps + 1, -(-cfg.out_capacity // M)
    ring = fir_fleets._ring_rows(cfg, 4096, 16)
    buf = torch.randn((ring, R), generator=gen, device=device)
    a2 = fir_fleets._sync_atlas(cfg, coeffs_for(44100, 48000, taps))
    a_hi, a_lo = fir_fleets._split_atlas_t(a2, device)  # the fleet's padded, transposed split atlas
    windows = [((i0 * L) // M, i0) for i0 in (0, 77, M - 1)]
    top = ring - ((K - 1) * L + span)
    out = torch.empty((K, M, R), device=device)

    def tm_call(fn, base, c0, i0):
        x = buf[base:].as_strided((K, R, span), (L * R, 1, R))
        return fn(x, fir_fleets._atlas_window(a_hi, c0, i0, span, M), fir_fleets._atlas_window(a_lo, c0, i0, span, M),
                  passes=4, out=out.permute(0, 2, 1))

    err = 0.0
    for c0, i0 in windows:
        for base in (1, 3, 4097, 2 * (ring // 4) + 1, top):
            got = tm_call(m3.matmul3, base, c0, i0).clone()
            ref = tm_call(m3.matmul3_reference, base, c0, i0)
            err = max(err, float((got - ref).abs().max()))
    torch.cuda.synchronize()
    check(err <= KERNEL_ATOL, f"B7 vs plain at the tm window: {err:.3e} > {KERNEL_ATOL}")
    worst = max(worst, err)
    rot = np.linspace(0, top, 8).astype(int).tolist()
    c0, i0 = windows[1]
    ms_w, plain_w, t = timed_pair(lambda i: tm_call(m3.matmul3, rot[i % 8], c0, i0),
                                  lambda i: tm_call(m3.matmul3_reference, rot[i % 8], c0, i0))
    calls = [m3._prepare(buf[base:].as_strided((K, R, span), (L * R, 1, R)),
                         fir_fleets._atlas_window(a_hi, c0, i0, span, M), fir_fleets._atlas_window(a_lo, c0, i0, span, M),
                         4, out.permute(0, 2, 1)) for base in rot]
    for c in calls:
        m3._split(c)
    split_w = elapsed_ms(lambda i: m3._split(calls[i % 8]), 20)
    gemm_w = elapsed_ms(lambda i: m3._gemm(calls[i % 8], 4), 20)
    del calls
    a32 = torch.from_numpy(np.ascontiguousarray(a2[i0 : i0 + M, c0 : c0 + span])).to(device)
    lib_w = elapsed_ms(lambda i: torch.matmul(
        a32, buf[rot[i % 8]:].as_strided((K, span, R), (L * R, R, 1))), 20)
    flop = 2 * K * R * span * M * 4
    nbytes = 4 * (((K - 1) * L + span) * R + K * M * R) + 2 * 2 * span * M
    bw_ms, bw_by = bound_ms(flop, nbytes, BF16_PEAK_TFLOPS)
    print(f"[23] B7 tm window K {K} R {R} span {span} Mg {M}, 4 passes, {len(windows)} atlas windows x 5 "
          f"bases: max |kernel - plain| = {err:.3e}")
    print(f"    kernel {t[1]:.4f} / {t[2]:.4f} ms, plain {t[0]:.4f} / {t[3]:.4f} ms per call; kernel "
          f"{flop / ms_w / 1e9:.1f} TFLOP/s; bound {bw_ms:.4f} ms ({bw_by}: {flop / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB; {100 * bw_ms / ms_w:.1f}% of it reached); library f32 "
          f"torch.matmul(atlas window, window view): {lib_w:.4f} ms")
    print(f"    split pass {split_w:.4f} ms ({2 * 2 * K * R * (-(-span // 8) * 8) / 1e6:.1f} MB of bf16 written), "
          f"GEMM {gemm_w:.4f} ms")
    entry["tm_window"] = dict(ms=ms_w, plain_ms=plain_w, bound_ms=bw_ms, bound_by=bw_by, library_ms=lib_w)
    del buf, out

    # (c) the FFT conv backend's windows at 1024 stereo streams: [g, R,
    # (g+1) L'] at a 147-float offset, the output [R, g, M'] as [g, R, M']
    g, lp, mp, R = 8, 147, 160, 2048
    x2 = torch.randn((R, 2 * 1176), generator=gen, device=device)
    w = torch.from_numpy(np.ascontiguousarray(fft_engine.input_domain_conv_operator(1176, 1280).reshape(-1, mp)))
    w_hi, w_lo = (h.to(device) for h in m3.split_weight(w))
    x = x2.as_strided((g, R, (g + 1) * lp), (lp, 2 * 1176, 1))
    out = torch.empty((R, g, mp), device=device)
    got = m3.matmul3(x, w_hi, w_lo, passes=3, out=out.permute(1, 0, 2)).clone()
    ref = m3.matmul3_reference(x, w_hi, w_lo, passes=3)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    check(err <= KERNEL_ATOL, f"B7 vs plain at the conv windows: {err:.3e} > {KERNEL_ATOL}")
    worst = max(worst, err)
    ms_c = elapsed_ms(lambda i: m3.matmul3(x, w_hi, w_lo, passes=3, out=out.permute(1, 0, 2)), 20)
    print(f"[23] B7 conv windows [{g}, {R}, {(g + 1) * lp}] @ [{(g + 1) * lp}, {mp}], 3 passes: max |kernel - "
          f"plain| = {err:.3e}; kernel {ms_c:.4f} ms")
    del x2, out, got, ref

    # (d) ragged strided, NaN and Inf rows
    big = torch.randn((3, 77, 301), generator=gen, device=device)
    x = big[:, 5:, 7:300]
    x[1, 9, 4] = float("nan")
    x[2, 70, 0] = float("inf")
    w = torch.randn((293, 97), generator=gen, device=device) / 17
    w_hi, w_lo = m3.split_weight(w)
    got = m3.matmul3(x, w_hi, w_lo, passes=3)
    ref = m3.matmul3_reference(x, w_hi, w_lo, passes=3)
    torch.cuda.synchronize()
    fin = torch.isfinite(ref)
    check(torch.equal(torch.isfinite(got), fin), "B7 ragged: non-finite pattern")
    check(not fin[1, 9].any() and not fin[2, 70].any() and int(fin.sum()) == fin.numel() - 2 * 97,
          "B7 ragged: only the NaN and Inf rows go non-finite")
    err = float((got[fin] - ref[fin]).abs().max())
    check(err <= KERNEL_ATOL, f"B7 vs plain ragged: {err:.3e}")
    worst = max(worst, err)
    print(f"[23] B7 ragged [3, 72, 293] @ [293, 97] strided, NaN and Inf rows: max |kernel - plain| = "
          f"{err:.3e}, non-finite only in those rows")
    entry["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return entry


class TmFleet:
    """A functional fleet step behind ``BatchedResamplerFir.resample``'s
    call: ``resample(chunks, n_valid)`` takes ``[B, n, C]`` chunks (numpy or
    a tensor) or a time-major ``[n, B*C]`` tensor, and returns ``(out [B,
    out_cap, C], consumed [B], produced [B], peak)``."""

    def __init__(self, step, state, B, C, device):
        self.step, self.state, self.B, self.C, self.device = step, state, B, C, device

    def resample(self, chunks, n_valid=None):
        chunks = torch.as_tensor(chunks, device=self.device)
        if chunks.ndim == 3:
            chunks = chunks.permute(1, 0, 2).reshape(chunks.shape[1], self.B * self.C)
        nv = chunks.shape[0] if n_valid is None else int(np.min(n_valid))
        self.state, out, c, p = self.step(self.state, chunks, nv)
        return out, np.full(self.B, c), np.full(self.B, p), out.abs().amax()


def tm_fleet(device, in_hz, out_hz, B, C=2, precision="bf16x4", max_chunk=4096, horizon=16, **kw):
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = FirConfig(channels=C, taps=Latency.Sample64.taps, ratio_num=L, ratio_den=M)
    coeffs = coeffs_for(in_hz, out_hz, cfg.taps)
    step = fir_fleets.make_fir_fleet_step_sync_tm(
        cfg, coeffs, B, max_chunk=max_chunk, horizon=horizon, precision=precision, device=device, **kw)
    state = fir_fleets.fir_fleet_init_sync_tm(cfg, B, max_chunk=max_chunk, horizon=horizon, device=device)
    return cfg, TmFleet(step, state, B, C, device)


def async_fleet(device, in_hz, out_hz, B, phases, kernel, C=2, max_chunk=2048, horizon=16, **kw):
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = FirConfig(channels=C, taps=Latency.Sample64.taps, ratio_num=L, ratio_den=M)
    step = fir_fleets.make_fir_fleet_step_async_tm(
        cfg, coeffs_for(in_hz, out_hz, cfg.taps), B, max_chunk=max_chunk, horizon=horizon, kernel=kernel,
        device=device, **kw)
    state = fir_fleets.fir_fleet_init_async_tm(cfg, B, max_chunk=max_chunk, horizon=horizon, pos_num=phases,
                                               device=device)
    return cfg, TmFleet(step, state, B, C, device)


def phase_bf16x4_tm_fleet(device, smi, B=1024, C=2, max_chunk=4096, n_steps=40, nbuf=8, warm=8, mirror=4):
    """The tm fleet's ``precision="bf16x4"`` at full width (B7, four
    passes), counted and timed, keeping streams 0-3; a CPU fleet of those
    streams on the same feed; then a second bf16x4 fleet in lockstep with
    the f32 fleet (B1), every output compared as it comes (the timed run
    keeps no full outputs, so the allocator does not grow in it); alias
    rejection through B7."""
    torch.cuda.reset_peak_memory_stats()
    cfg, fleet = tm_fleet(device, 44100, 48000, B, C, out_layout="tm")
    gen = torch.Generator(device=device)
    gen.manual_seed(42)
    chunks = [torch.randn((max_chunk, B * C), generator=gen, device=device) for _ in range(nbuf)]
    torch.cuda.synchronize()

    zero_launches()  # count only this path's own launches
    small, steps, fills, peaks = [], [], [], []
    t0 = time.perf_counter()
    for i in range(n_steps):
        if i == warm:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
        out, c, p, peak = fleet.resample(chunks[i % nbuf])
        small.append(out[:, : mirror * C].clone())
        steps.append((int(c[0]), int(p[0])))
        fills.append(fleet.state["fill"])
        peaks.append(peak)
    torch.cuda.synchronize()
    dt_warm, dt = time.perf_counter() - t_warm, time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)

    check(steps == list(expected_schedule(cfg, [max_chunk] * n_steps)), "bf16x4 tm fleet: exact schedule")
    emitting = sum(p > 0 for _, p in steps)
    check(launches == dict({k: 0 for k in launches}, matmul3=emitting),
          f"bf16x4 tm fleet: one B7 launch per emitting step ({emitting}), no B1: {launches}")
    compactions = sum(b < a for a, b in zip(fills, fills[1:]))
    check(compactions >= 2, f"bf16x4 tm fleet: {compactions} compactions >= 2")
    check(bool(torch.isfinite(torch.stack(peaks)).all()), "bf16x4 tm fleet: finite outputs")

    # streams 0-3 on a CPU fleet (B7's plain version), then a second bf16x4
    # fleet in lockstep with the f32 fleet (B1), every output
    _, cpu = tm_fleet("cpu", 44100, 48000, mirror, C, out_layout="tm")
    err_f32 = err_cpu = 0.0
    for i in range(n_steps):
        oc, c, p, _ = cpu.resample(chunks[i % nbuf][:, : mirror * C].cpu())
        check((int(c[0]), int(p[0])) == steps[i], f"CPU mirror schedule at step {i}")
        err_cpu = max(err_cpu, float((small[i].cpu() - oc).abs().max()))
    _, again = tm_fleet(device, 44100, 48000, B, C, out_layout="tm")
    _, f32 = tm_fleet(device, 44100, 48000, B, C, precision="highest", out_layout="tm")
    for i in range(n_steps):
        o16, c, p, _ = again.resample(chunks[i % nbuf])
        check((int(c[0]), int(p[0])) == steps[i] and torch.equal(o16[:, : mirror * C], small[i]),
              f"the second bf16x4 fleet repeats the first at step {i}")
        o32, c, p, _ = f32.resample(chunks[i % nbuf])
        check((int(c[0]), int(p[0])) == steps[i], f"f32 fleet schedule at step {i}")
        err_f32 = max(err_f32, float((o16 - o32).abs().max()))
    check(0 < err_f32 <= BF16X4_VS_F32_ATOL, f"bf16x4 vs f32 tm fleet {err_f32:.3e} (0, {BF16X4_VS_F32_ATOL}]")
    check(err_cpu <= DEVICE_ATOL, f"bf16x4 tm fleet vs CPU mirror {err_cpu:.3e} > {DEVICE_ATOL}")
    rate = sum(p for _, p in steps[warm:]) * B / dt_warm / 1e6
    print(f"[25] bf16x4 tm fleet: {B} streams x {C} ch, 44100 -> 48000 Hz taps {cfg.taps}, chunk {max_chunk}, "
          f"{n_steps} steps ({emitting} emitting, {compactions} compactions), launches {launches}; schedule "
          f"exact; every output vs the f32 tm fleet (B1) max {err_f32:.3e}; streams 0-{mirror - 1} vs CPU "
          f"(B7's plain version) max {err_cpu:.3e}")
    print(f"    fleet: {rate:.1f} Msamples/s over steps {warm + 1}-{n_steps} "
          f"({dt_warm * 1e3 / (n_steps - warm):.3f} ms/step); all {n_steps} steps "
          f"{sum(p for _, p in steps) * B / dt / 1e6:.1f} [output frames x streams per second; card: {smi}]")
    print(f"    peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del again, f32
    profile_steps(fleet, chunks)
    del fleet, chunks
    torch.cuda.empty_cache()

    before = _build.LAUNCHES["matmul3"]
    db, n = alias_db(device, 48000, 44100, fleet=tm_fleet(device, 48000, 44100, 2)[1])
    launched = _build.LAUNCHES["matmul3"] - before
    check(launched > 0, "the tone ran through B7")
    check(db >= 100.0, f"alias rejection through B7 {db:.2f} dB >= 100")
    print(f"[25] alias rejection through B7 (bf16x4 tm fleet, 48 -> 44.1 kHz, 23 kHz tone): {db:.2f} dB over "
          f"{n} frames, {launched} launches")
    return launches["matmul3"]


def phase_async_pallas_fleet(device, smi, label, in_hz, out_hz, B=1024, C=2, max_chunk=2048, n_steps=40,
                             nbuf=8, warm=8):
    """The async fleet with ``kernel="pallas"`` (B6b) at full width,
    counted and timed; then a second such fleet in lockstep with the f32
    async fleet (B6) on the same feed, every output compared as it comes."""
    L, M = reduce_ratio(in_hz, out_hz)
    max_out = async_max_out(in_hz, out_hz, max_chunk)
    phases = np.random.default_rng(7).integers(0, M, B)
    cfg, fleet = async_fleet(device, in_hz, out_hz, B, phases, "pallas", max_out=max_out, out_layout="tm")
    out_cap = min(cfg.out_capacity, max_out)
    gen = torch.Generator(device=device)
    gen.manual_seed(43)
    chunks = [torch.randn((max_chunk, B * C), generator=gen, device=device) for _ in range(nbuf)]
    torch.cuda.synchronize()

    zero_launches()  # count only this path's own launches
    steps, peaks = [], []
    t0 = time.perf_counter()
    for i in range(n_steps):
        if i == warm:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
        _, c, p, peak = fleet.resample(chunks[i % nbuf])
        steps.append((int(c[0]), int(p[0])))
        peaks.append(peak)
    torch.cuda.synchronize()
    dt_warm, dt = time.perf_counter() - t_warm, time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check(launches == dict({k: 0 for k in launches}, async_combine_bf16x4=n_steps),
          f"{label}: exactly one B6b launch per step and nothing else: {launches}")
    sched = (0, [int(p) for p in phases])
    for i, step in enumerate(steps):
        to_copy, n_out, _, sched = expected_async_schedule(cfg, out_cap, sched, max_chunk)
        check((to_copy, n_out) == step, f"{label}: step {i} {step} == host schedule {(to_copy, n_out)}")
    check(async_positions(fleet.state, M, cfg.wide) == sched[1], f"{label}: positions == host schedule")
    check(bool(torch.isfinite(torch.stack(peaks)).all()), f"{label}: finite outputs")

    _, again = async_fleet(device, in_hz, out_hz, B, phases, "pallas", max_out=max_out, out_layout="tm")
    _, f32 = async_fleet(device, in_hz, out_hz, B, phases, "auto", max_out=max_out, out_layout="tm")
    err = 0.0
    for i in range(n_steps):
        o16, c, p, _ = again.resample(chunks[i % nbuf])
        o32, c32, p32, _ = f32.resample(chunks[i % nbuf])
        check((int(c[0]), int(p[0])) == (int(c32[0]), int(p32[0])) == steps[i],
              f"{label}: schedules at step {i}")
        err = max(err, float((o16 - o32).abs().max()))
    check(err <= ASYNC_BF16X4_ATOL, f"{label}: B6b vs B6 fleet {err:.3e} > {ASYNC_BF16X4_ATOL}")
    rate = sum(p for _, p in steps[warm:]) * B * C / dt_warm / 1e6
    print(f"[26] {label}: {B} streams x {C} ch, {in_hz} -> {out_hz} Hz taps {cfg.taps}, max_out {max_out}, "
          f"kernel='pallas'; {n_steps} steps, launches {launches}; schedule == host recomputation; every "
          f"output vs the f32 fleet (B6) max {err:.3e}")
    print(f"    fleet: {rate:.1f} Msamples/s over steps {warm + 1}-{n_steps} "
          f"({dt_warm * 1e3 / (n_steps - warm):.3f} ms/step); all {n_steps} steps "
          f"{sum(p for _, p in steps) * B * C / dt / 1e6:.1f} [output frames x streams x channels per "
          f"second, phase 12's count; card: {smi}]")
    profile_steps(fleet, chunks)
    del fleet, again, f32, chunks
    torch.cuda.empty_cache()
    return launches["async_combine_bf16x4"]


def phase_async_pallas_alias(device):
    M = reduce_ratio(48000, 44101)[1]
    before = _build.LAUNCHES["async_combine_bf16x4"]
    fleet = async_fleet(device, 48000, 44101, 2, [0, M // 2], "pallas", max_chunk=4096)[1]
    db, n = alias_db(device, 48000, 44101, fleet=fleet)
    launched = _build.LAUNCHES["async_combine_bf16x4"] - before
    check(launched > 0, "the tone ran through B6b")
    check(db >= 100.0, f"alias rejection through B6b {db:.2f} dB >= 100")
    print(f"[26] alias rejection through B6b (async fleet, kernel='pallas', 48000 -> 44101 Hz, 23 kHz tone): "
          f"{db:.2f} dB over {n} frames, {launched} launches")


def phase_fft_b7(device, smi, backend, B, C=2, n_steps=40, T=8, nbuf=8, warm=8, mirror=4):
    """``BatchedResamplerFft(B, C, 44100, 48000, backend)`` on the card,
    matmul or conv: one B7 launch per call and per chunk of
    ``resample_many``, streams 0-3 against B7's plain version on the same
    chunks."""
    torch.cuda.reset_peak_memory_stats()
    fleet = BatchedResamplerFft(B, C, 44100, 48000, backend=backend, device=device)
    n_in, n_out = fleet.config.fft_size_input, fleet.config.fft_size_output
    gen = torch.Generator(device=device)
    gen.manual_seed(44)
    chunks = [torch.randn((B, C, n_in), generator=gen, device=device) for _ in range(nbuf)]
    many = torch.stack([chunks[(n_steps + t) % nbuf] for t in range(T)])
    torch.cuda.synchronize()

    zero_launches()  # count only this path's own launches
    small = []
    t0 = time.perf_counter()
    for i in range(n_steps):
        if i == warm:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
        small.append(fleet.resample(chunks[i % nbuf])[:mirror].clone())
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    outs = fleet.resample_many(many)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check(launches == dict({k: 0 for k in launches}, matmul3=n_steps + T),
          f"FFT {backend} fleet: one B7 launch per call and chunk: {launches}")
    check(bool(torch.isfinite(outs).all()) and float(outs.abs().max()) > 0, f"FFT {backend}: finite outputs")
    seq = torch.stack([chunks[i % nbuf][:mirror] for i in range(n_steps)] + [many[t, :mirror] for t in range(T)])
    ref = fft_b7_plain(backend, seq.reshape(n_steps + T, mirror * C, n_in), n_in, n_out)
    got = torch.cat([torch.stack(small), outs[:, :mirror]]).reshape(n_steps + T, mirror * C, n_out)
    err = float((got - ref).abs().max())
    check(err <= KERNEL_ATOL, f"FFT {backend} fleet vs B7's plain version {err:.3e} > {KERNEL_ATOL}")
    per_step = B * C * n_out
    dt_warm = t_end - t_warm
    print(f"[27] FFT fleet, backend {backend}: {B} streams x {C} ch, 44100 -> 48000 Hz (N {n_in}, M {n_out}): "
          f"{n_steps} resample() + resample_many(T={T}); launches {launches}; streams 0-{mirror - 1} vs B7's "
          f"plain version max err {err:.3e}")
    print(f"    fleet: {per_step * (n_steps - warm) / dt_warm / 1e6:.1f} Msamples/s over resample() calls "
          f"{warm + 1}-{n_steps} ({dt_warm * 1e3 / (n_steps - warm):.3f} ms/step) [B x C x M output samples "
          f"per step; card: {smi}]")
    print(f"    peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if backend == "matmul":
        profile_steps(fleet, chunks)
    del fleet, chunks, many, outs, small
    torch.cuda.empty_cache()
    return launches["matmul3"]


def phase_fft_b7_quality(device):
    for backend in ("matmul", "conv"):
        zero_launches()
        pair_db = fft_bench_pair_floor_db(device, backend)
        n_pair = _build.LAUNCHES["matmul3"]
        stop_db = fft_stopband_db(device, backend)
        n_stop = _build.LAUNCHES["matmul3"] - n_pair
        check(n_pair == 2 and n_stop > 0 and sum(_build.LAUNCHES.values()) == n_pair + n_stop,
              f"{backend} quality gates ran through B7 ({n_pair}, {n_stop} launches)")
        check(pair_db >= 99.0, f"{backend} fft_bench_pair_floor_db {pair_db:.2f} >= 99")
        check(stop_db >= 99.0, f"{backend} fft_stopband_db {stop_db:.2f} >= 99")
        print(f"[27] FFT quality through B7 ({backend}, 3 passes): fft_bench_pair_floor_db {pair_db:.2f} dB "
              f"({n_pair} launches), fft_stopband_db {stop_db:.2f} dB ({n_stop} launches); gates >= 99 dB")


#: B6's and B6b's cases (phases 11 and 24)
ASYNC_CASES = [
    ("(a) main 44100->44101 taps 128, 1024x2", 44100, 44101, 128, 2048, 1, False),
    ("(b) 22050->96000 skew 2, 1024x2", 22050, 96000, 128, 2048, 2, False),
    ("(c) downsampling 48000->44101, 1024x2", 48000, 44101, 128, 2048, 1, False),
    ("(d) wide 4000000000->4000000001, 1024x2", 4_000_000_000, 4_000_000_001, 128, 2048, 1, False),
    ("(e) heavy downsampling 367500->1601, 1024x2", 367500, 1601, 128, 2048, 1, False),
    ("(f) ragged 44100->44101, R 6", 44100, 44101, 128, 6, 1, False),
    ("(g) starved, base_rel past skew_periods, 1024x2", 44100, 44101, 128, 2048, 1, True),
]


def main() -> None:
    smi = phase_device()
    device = torch.device("cuda")
    phase_build()
    entries = {"dma_banded_contract": phase_banded_kernel(device, [
        ("main path 44.1->48k taps 128, 1024x2", (44100, 48000, 128, 2048, 4096, 16)),
        ("44.1->48k taps 64, 1024x2", (44100, 48000, 64, 2048, 4096, 16)),
        ("grouped 48->96k taps 64 (g 64), 128x2", (48000, 96000, 64, 256, 512, 3)),
        ("ragged 44.1->48k taps 128, R 6", (44100, 48000, 128, 6, 512, 3)),
        ("48->44.1k taps 128, 1024x2", (48000, 44100, 128, 2048, 4096, 16)),
    ])}
    entries.update(phase_farrow_kernels(device, [
        ("44.1->44.101k taps 128, 1024x2", (44100, 44101, 128, 2048, 4096, 16)),
        ("367500->1601 taps 128, 1024x2", (367500, 1601, 128, 2048, 4096, 16)),
        ("ragged 44.1->44.101k taps 128, R 6", (44100, 44101, 128, 6, 512, 3)),
        ("ragged 48000->3001 (q 4) taps 128, R 6", (48000, 3001, 128, 6, 512, 3)),
        ("wide 600011->600013 taps 128, 1024x2", (600011, 600013, 128, 2048, 4096, 16)),
    ]))
    entries.update(phase_magsplit_kernels(
        device,
        [(1176, 1280, 16384), (588, 1280, 16384), (1280, 1176, 37), (1280, 1176, 2),
         (1280, 3528, 4099), (2560, 2352, 1027), (3528, 1280, 130)],
        timed=(1176, 1280, 16384),  # 8192 stereo streams at the bench pair
    ))
    launches = {name: 0 for name in entries}
    for label, in_hz, out_hz, kname, path in (
        ("periodic main path", 44100, 48000, "dma_banded_contract", "auto"),
        ("farrow", 44100, 44101, "dma_farrow_contract", "auto"),
        ("lerp", 44100, 44101, "dma_farrow_contract", "lerp"),
        ("wide u32", 600011, 600013, "dma_farrow_contract", "auto"),
        ("heavy downsampling", 367500, 1601, "dma_farrow_contract_packed", "auto"),
    ):
        launches[kname] += phase_fleet(device, smi, label, in_hz, out_hz, kname, path=path)
    phase_differential(device, 44100, 48000)
    phase_differential(device, 44100, 44101)
    phase_differential(device, 600011, 600013)
    phase_alias(device)
    phase_per_stream(device, 44100, 48000)
    phase_per_stream(device, 44100, 44101)
    fft_launches = phase_fft_fleet(device, smi)
    for name in ("magsplit_projector", "magsplit_projector_pool"):
        launches[name] = fft_launches[name]
    phase_fft_quality(device)
    phase_fft_per_stream(device)
    entries["async_combine"] = phase_async_kernel(device, ASYNC_CASES)
    launches["async_combine"] = sum(
        phase_async_fleet(device, smi, label, in_hz, out_hz)
        for label, in_hz, out_hz in (
            ("async fleet", 44100, 44101),
            ("async fleet, wide", 4_000_000_000, 4_000_000_001),
        )
    )
    for in_hz, out_hz in ((44100, 44101), (600011, 600013)):
        M = reduce_ratio(in_hz, out_hz)[1]
        phase_differential(device, in_hz, out_hz, horizon=2, sync_variant="async_tm",
                           initial_positions=[0, M // 3, M - 1])
    phase_async_alias(device)
    phase_async_streaming(device, smi)
    entries.update(phase_step_kernels(device, [
        ("(a) main 44.1->48k taps 128, 1024x2, chunk 4096", 44100, 48000, 128, 1024, 2, 4096, False),
        ("(b) ragged feeds, NaN junk, diverged positions, 1024x2", 44100, 48000, 128, 1024, 2, 4096, True),
        ("(c) 48->44.1k taps 128, 1024x2", 48000, 44100, 128, 1024, 2, 4096, False),
        ("(d) 48000->96000 (M 2) taps 128, 128x2", 48000, 96000, 128, 128, 2, 4096, False),
        ("(e) ragged R 6 (3x2)", 44100, 48000, 128, 3, 2, 4096, True),
        ("(f) 47952->48000 (L/M 999/1000) taps 128, 1024x2", 47952, 48000, 128, 1024, 2, 4096, False),
    ]))
    launches["fir_fleet_step"] = phase_vmapped_fleet(device, smi)
    phase_vmapped_farrow(device, smi)
    launches["fir_fleet_step_sync"] = phase_slide_fleet(device, smi)
    for in_hz, out_hz, kw in ((44100, 48000, {}), (44100, 44101, {}), (600011, 600013, {}),
                              (44100, 48000, dict(synchronized=True, sync_variant="slide"))):
        phase_end_aligned_differential(device, in_hz, out_hz, **kw)
    phase_end_aligned_alias(device)
    phase_vmapped_streaming(device, smi)
    entries["matmul3"] = phase_matmul3_kernel(device)
    entries["async_combine_bf16x4"] = phase_async_kernel(device, ASYNC_CASES, precision="bf16x4")
    launches["matmul3"] = phase_bf16x4_tm_fleet(device, smi)
    launches["async_combine_bf16x4"] = sum(
        phase_async_pallas_fleet(device, smi, label, in_hz, out_hz)
        for label, in_hz, out_hz in (
            ("async fleet (B6b)", 44100, 44101),
            ("async fleet (B6b), wide", 4_000_000_000, 4_000_000_001),
        )
    )
    phase_async_pallas_alias(device)
    launches["matmul3"] += phase_fft_b7(device, smi, "matmul", 8192)
    phase_fft_b7(device, smi, "conv", 1024)
    phase_fft_b7_quality(device)
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "launches": launches[name],
            **{k: entries[name][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        }
        for name in SOURCES
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
