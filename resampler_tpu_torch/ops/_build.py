"""Build, load and launch the port's hand-written CUDA kernels.

Every source in ``csrc/`` (``_SOURCES``) is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, on first use,
into the gitignored ``resampler_tpu_torch/_build/``: one ``nvcc`` per
source, all started together.  The libraries are bound with ``ctypes``.
Nothing here runs at import time, so the CPU-only tests import every
module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "SMEM_MAX", "build", "build_log", "launch"]

#: Kernel launches made by each wrapper in this process (a wrapper adds
#: one where it launches its kernel, and nowhere else).
LAUNCHES = {
    "dma_banded_contract": 0,
    "dma_farrow_contract": 0,
    "dma_farrow_contract_packed": 0,
    "magsplit_projector": 0,
    "magsplit_projector_pool": 0,
    "async_combine": 0,
    "async_combine_bf16x4": 0,
    "matmul3": 0,
    "fir_fleet_step_sync": 0,
    "fir_fleet_step": 0,
}

#: shared memory one block may hold on an H100 (227 KB)
SMEM_MAX = 232448

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
#: one shared library per source; the headers are included by the B2 source
#: (tiled_contract), by the B4, B6 and B7 sources (bf16_split) and by the B4
#: and B7 sources (hopper_tma)
_SOURCES = (
    "fir_banded_contract.cu", "fir_farrow_contract.cu", "fft_magsplit.cu", "fir_async_combine.cu",
    "fir_fleet_step.cu", "matmul3.cu",
)
_HEADERS = ("tiled_contract.cuh", "bf16_split.cuh", "hopper_tma.cuh")
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # buffer, a, a strides (j, s), tiles, out, R, base, L, M, span, K, rows,
    # vec, stream
    "fir_banded_contract": [_P, _P, _I64, _I64, _P, _P, _I, _I64] + [_I] * 6 + [_P],
    # buffer, a_blk, block_base, out, R, base, K, q, w, stream
    "fir_farrow_contract": [_P, _P, _P, _P, _I, _I64, _I, _I, _I, _P],
    # ... the same, then the lanes per thread (4 or 1), stream
    "fir_farrow_contract_packed": [_P, _P, _P, _P, _I, _I64, _I, _I, _I, _I, _P],
    # prev, cur and weight maps, tiles, starts, out, R, M, s, cols, cols_pad,
    # stream
    "fft_magsplit_projector": [_P] * 6 + [_I] * 5 + [_P],
    # base, kind (0 x f32, 1 weights bf16), rows, cols, map out
    "fft_magsplit_encode": [_P, _I, _I, _I, _P],
    # (none): the kernel's dynamic shared memory per block
    "fft_magsplit_smem": [],
    # buffer, a_t, js, lanes, tiles, rowmap, aux, out, R, base0, n_out, out_cap,
    # taps, M, skew, positions, n_emit, z0, rows_pad, out_max, n_aux, vec,
    # stream
    "fir_async_combine": [_P] * 8 + [_I, _I64, _I, _I, _I, _I64] + [_I] * 8 + [_P],
    # buffer, frags, s, lanes, rowmap, win, out, R, base0, n_out, out_cap,
    # taps, M, skew, outputs per tile, rows_pad, pitch_w, vec, stream
    "fir_async_combine_bf16x4": [_P] * 7 + [_I, _I64, _I, _I, _I, _I64] + [_I] * 5 + [_P],
    # x, x_hi, x_lo, batch, M, K, Kp, x strides (b, m, k), stream
    "matmul3_split": [_P] * 3 + [_I] * 4 + [_I64] * 3 + [_P],
    # x_hi, x_lo, t_hi, t_lo, out, batch, M, N, K, Kp, t row stride, out
    # strides (b, m, n), passes, promote, stream
    "matmul3_gemm": [_P] * 5 + [_I] * 5 + [_I64] * 4 + [_I] * 2 + [_P],
    # (none): the GEMM's dynamic shared memory per block
    "matmul3_gemm_smem": [],
    # old, chunks, sched, sched stride, w_t, next, out, B, C, alloc, valid_end,
    # chunk strides (b, f, c), out_cap, taps, L, M, stream
    "fir_fleet_step": [_P, _P, _P, _I, _P, _P, _P] + [_I] * 4 + [_I64] * 3 + [_I] * 4 + [_P],
    # old, chunks, sched, sched stride, bands, d_tab, next, out, B, C, alloc,
    # valid_end, chunk strides (b, f, c), out_cap, L, M, l_inv, R, warps,
    # groups, band_w, win, pitch, q tiles, stream
    "fir_fleet_step_band": [_P, _P, _P, _I] + [_P] * 4 + [_I] * 4 + [_I64] * 3 + [_I] * 11
    + [_P],
}
_libs: dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
#: ``nvcc`` output of the last build in this process (``-Xptxas -v``
#: register / shared-memory / spill report of every source).
_build_log = ""


def build_log() -> str:
    return _build_log


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def build() -> dict[str, ctypes.CDLL]:
    """Compile (once per content of the sources) and load every kernel
    library: one ``nvcc`` per source, all started together.  A failed
    build raises with the compiler's output.  Returns the library of each
    C entry point by name."""
    global _build_log
    with _lib_lock:
        if _libs:
            return _libs
        digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
        for name in _HEADERS + _SOURCES:
            digest.update((_CSRC / name).read_bytes())
        tag = digest.hexdigest()[:16]
        sos = {src: _BUILD_DIR / f"lib{Path(src).stem}_{tag}.so" for src in _SOURCES}
        procs = {}
        for src, so in sos.items():
            if not so.exists():
                if not procs:
                    nvcc = _nvcc()
                    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                procs[src] = (tmp, subprocess.Popen(
                    [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                ))
        logs, failed = [], []
        for src, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            logs.append(f"== {src}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{src} (exit code {proc.returncode})")
            else:
                os.replace(tmp, sos[src])
        if procs:
            _build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{_build_log}")
        libs = {}
        for so in sos.values():
            lib = ctypes.CDLL(str(so))
            for fn_name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, fn_name, None)
                if fn is not None:
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    libs[fn_name] = lib
        _libs.update(libs)
        return _libs


def launch(fn_name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``fn_name`` with ``args`` and the current
    stream of ``device``; raise if it returns a CUDA error."""
    lib = build()[fn_name]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")


def device_kind(t: torch.Tensor) -> str:
    """``"cpu"`` or ``"cuda"``; any other device raises (a wrapper never
    runs its plain version for a tensor that is not on the CPU)."""
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return kind
