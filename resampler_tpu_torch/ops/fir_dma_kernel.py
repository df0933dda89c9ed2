"""Kernel B1: the banded contraction of the time-major sync FIR fleet.

Port of ``resampler_tpu/ops/fir_dma_kernel.py:277 dma_banded_contract``:

    out[k, j, r] = sum_{s < span} a[j, s] * buffer[base + k*L + s, r],  k < K

``buffer [ring, R]`` f32, ``base`` a Python int, ``a [M, span]`` f32;
returns ``[K, M, R]`` f32.  The TPU kernel's Mosaic workarounds (8-row
aligned DMA with a remainder-shifted ``[8, M, s_dma]`` atlas, the
``R % 128`` lane gate) do not carry over: the CUDA kernel addresses any
row offset and masks a ragged lane edge itself.

``dma_banded_contract`` launches the hand-written CUDA kernel
(``csrc/fir_banded_contract.cu``) for CUDA tensors and runs
``dma_banded_contract_reference`` (the plain PyTorch version of the same
contract) only for CPU tensors; there is no fallback between the two.
The kernel is compiled with ``nvcc`` for ``sm_90a`` on first use, into
``resampler_tpu_torch/_build/``, and bound with ``ctypes``.
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

__all__ = [
    "LAUNCHES",
    "build",
    "dma_banded_contract",
    "dma_banded_contract_reference",
]

#: Kernel launches made by ``dma_banded_contract`` in this process.
LAUNCHES = 0
#: ``nvcc`` output of the last build in this process (``-Xptxas -v``
#: register / shared-memory / spill report).
BUILD_LOG = ""

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "fir_banded_contract.cu"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def build() -> ctypes.CDLL:
    """Compile (once per source content) and load the kernel library.
    A failed build raises with the compiler's output."""
    global _lib, BUILD_LOG
    with _lib_lock:
        if _lib is not None:
            return _lib
        tag = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
        so = _BUILD_DIR / f"libfir_banded_contract_{tag}.so"
        if not so.exists():
            nvcc = _nvcc()
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                capture_output=True,
                text=True,
            )
            BUILD_LOG = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with exit code {proc.returncode}:\n{BUILD_LOG}"
                )
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        fn = lib.fir_banded_contract
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _check(buffer, base, a, L, M, span, K) -> None:
    if not isinstance(base, int) or isinstance(base, bool):
        raise TypeError(f"base must be a Python int, got {type(base).__name__}")
    for name, t, nd in (("buffer", buffer, 2), ("a", a, 2)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.ndim != nd:
            raise TypeError(f"{name} must be a {nd}-D float32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.device != buffer.device:
        raise ValueError(f"a is on {a.device}, buffer on {buffer.device}")
    if min(L, M, span, K) < 1:
        raise ValueError(f"L, M, span, K must be >= 1: {(L, M, span, K)}")
    if tuple(a.shape) != (M, span):
        raise ValueError(f"a must be [{M}, {span}], got {tuple(a.shape)}")
    ring, R = buffer.shape
    if R < 1:
        raise ValueError("buffer has no lanes")
    if max(ring, R, M * K) >= 1 << 31:
        raise ValueError("the kernel takes 32-bit row, lane and block counts")
    top = base + (K - 1) * L + span
    if base < 0 or top > ring:
        raise IndexError(
            f"rows [{base}, {top}) fall outside the ring of {ring} rows"
        )


def dma_banded_contract_reference(buffer, base: int, a, *, L: int, M: int, span: int, K: int):
    """Plain PyTorch version of the contract: a stride-``L`` window view
    of ``buffer[base : base + (K-1)*L + span]`` contracted with ``a`` in
    f32.  ``[K, M, R]``."""
    _check(buffer, base, a, L, M, span, K)
    windows = buffer[base : base + (K - 1) * L + span].unfold(0, span, L)  # [K, R, span]
    return torch.einsum("js,krs->kjr", a, windows)


def dma_banded_contract(buffer, base: int, a, *, L: int, M: int, span: int, K: int):
    """``out[k, j, r] = sum_s a[j, s] * buffer[base + k*L + s, r]``,
    ``[K, M, R]`` f32.  CUDA tensors launch kernel B1 on the current
    stream (and count in ``LAUNCHES``); CPU tensors run the plain
    version.  Anything else raises."""
    global LAUNCHES
    _check(buffer, base, a, L, M, span, K)
    if buffer.device.type == "cpu":
        return dma_banded_contract_reference(buffer, base, a, L=L, M=M, span=span, K=K)
    if buffer.device.type != "cuda":
        raise ValueError(f"unsupported device {buffer.device}")
    lib = build()
    R = buffer.shape[1]
    out = torch.empty((K, M, R), dtype=torch.float32, device=buffer.device)
    with torch.cuda.device(buffer.device):
        stream = torch.cuda.current_stream(buffer.device).cuda_stream
        err = lib.fir_banded_contract(
            ctypes.c_void_p(buffer.data_ptr()),
            ctypes.c_void_p(a.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_int(R),
            ctypes.c_int(base),
            ctypes.c_int(L),
            ctypes.c_int(M),
            ctypes.c_int(span),
            ctypes.c_int(K),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"fir_banded_contract launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
