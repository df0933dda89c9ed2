"""Polyphase FIR resampler engine: PyTorch port of ``resampler_tpu.engine.fir``.

The host-side design layer (constants, ``FirConfig``, the coefficient
table and its cache, the convolve-path and grouping rules) is copied from
the JAX module verbatim in its arithmetic.  The chunk step runs on torch
tensors on the configured device.

State is a dict: ``buffer`` is a ``[C, buffer_alloc]`` f32 tensor; the
schedule scalars ``available_frames`` and ``pos_num`` are exact Python
ints kept on the host, so a step never waits on the device to learn
them.  The non-wide overflow analysis (``_compute_n_out``) keeps every
scheduled value below 2^31, so the Python-int results equal the JAX
package's int32 ones.

Ported paths: periodic (banded atlas), farrow (Chebyshev basis) and lerp
(SVD table basis), on the int32 envelope and on the wide two-word u32
schedule (farrow only, as in the JAX package).  The wide schedule is kept
as host Python ints and reproduces the JAX package's u32 arithmetic bit
for bit (``WideSchedule``).  The table-lerp oracle ``path="gather"``
raises ``NotImplementedError`` (ROADMAP A9).

``make_fir_step_batched`` is the counterpart of ``jax.vmap(make_fir_step)``
(the JAX package's general fleet): a ``[B, C, buffer_alloc]`` buffer and
each stream's schedule as ``[B]`` int64 numpy arrays, computed on the host
with whole-fleet numpy.  Its periodic step is kernel B9
(``ops/fir_kernel.py``); the farrow and lerp steps are torch ops.
"""

from __future__ import annotations

import dataclasses
import math
import threading

import numpy as np
import torch

from ..dsp.window import WindowType, calculate_cutoff_kaiser, make_sincs_for_kaiser
from ..types import Attenuation
from ..utils import tracing

__all__ = [
    "PHASES",
    "INPUT_CAPACITY",
    "MAX_CHUNK",
    "FARROW_DEGREE",
    "FARROW_BLOCK",
    "FARROW_BLOCK_MAX",
    "FirConfig",
    "WideSchedule",
    "farrow_block_size",
    "farrow_matrix",
    "fir_init",
    "fir_init_batched",
    "fir_cutoff",
    "fir_coefficients",
    "make_fir_step",
    "make_fir_step_batched",
    "resolve_convolve_path",
    "resolve_device",
    "resolve_path",
]

#: Polyphase branch count (reference: src/resampler_fir.rs:17).
PHASES = 1024
#: Maximum buffered input frames (reference: src/resampler_fir.rs:18).
INPUT_CAPACITY = 4096
#: Largest input chunk accepted by one ``step`` call (frames).
MAX_CHUNK = INPUT_CAPACITY
#: Fallback slack after the valid region (non-periodic paths).
MIN_READ_SLACK = 128
#: Reduced output-rate denominator limit keeping every scheduled int32
#: quantity below 2^31; beyond it the engine switches to the WIDE
#: two-word u32 schedule (``WideSchedule``).
MAX_REDUCED_RATE = 500_000
#: Static output-lane cap for extreme upsampling ratios.
OUT_CAP_MAX = 1 << 20
#: Periodic-path limits: the banded kernel atlas is [2M, 2L + taps + 1].
MAX_PERIOD = 2048
MAX_PERIOD_L = 4000
MAX_ATLAS_BYTES = 32 << 20
#: Farrow path: Chebyshev degree and outputs per block (the JAX package's
#: tuned values; the block size adapts to the ratio, ``farrow_block_size``).
FARROW_DEGREE = 7
FARROW_BLOCK = 64
FARROW_BLOCK_MAX = 4096


def resolve_device(device) -> torch.device:
    """``"cpu"`` or ``"cuda[:n]"`` as a ``torch.device``.  A CUDA device
    with no GPU present raises; there is no fallback to the CPU.  On the
    card, float32 matmuls and convolutions are pinned to full f32 (both
    TF32 flags off): TF32 keeps ~3 decimal digits and cannot pass the
    100 dB alias gate."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} was requested but torch.cuda.is_available() "
                "is False"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cpu' or 'cuda'")
    return dev


@dataclasses.dataclass(frozen=True)
class FirConfig:
    """Static FIR engine configuration (same fields and derived sizes as
    ``resampler_tpu.engine.fir.FirConfig``)."""

    channels: int
    taps: int
    ratio_num: int  # L: reduced input rate
    ratio_den: int  # M: reduced output rate
    phases: int = PHASES
    input_capacity: int = INPUT_CAPACITY

    def __post_init__(self) -> None:
        if self.channels < 1:
            raise ValueError("channel count must be at least 1")
        if not (1 <= self.ratio_num < (1 << 32)) or not (
            1 <= self.ratio_den < (1 << 32)
        ):
            raise ValueError(
                "sample rates must reduce to nonzero u32 values "
                f"(reference parity): {self.ratio_num}/{self.ratio_den}"
            )

    @property
    def wide(self) -> bool:
        """True when the reduced ratio exceeds the int32 schedule envelope
        and the position is carried as two u32 words (``WideSchedule``)."""
        return self.ratio_den > MAX_REDUCED_RATE or self.ratio_num > (
            1 << 31
        ) // (self.input_capacity + 2)

    @property
    def read_slack(self) -> int:
        """Rows after the valid region that every periodic read may touch
        (the JAX package's bound, so both allocate the same buffers)."""
        L, taps = self.ratio_num, self.taps
        j_max = ((self.out_capacity - 1) * L) // self.ratio_den
        if self.wide:
            j_max = min(j_max, self.input_capacity + 2)
        gather_need = j_max + 2 + taps + MIN_READ_SLACK
        if resolve_convolve_path(self) != "periodic":
            slack = gather_need
        else:
            span = L + taps + 1
            K = -(-self.out_capacity // self.ratio_den)
            n_blk = 1 + -(-(span - L) // L)
            region_cols = max((K + n_blk) * L, (K - 1) * L + span)
            g = _periodic_group_factor(L, self.ratio_den)
            if g > 1:
                Lg, Mg = L * g, self.ratio_den * g
                span_g = Lg + taps + 1
                K_g = -(-self.out_capacity // Mg)
                n_blk_g = 1 + -(-(span_g - Lg) // Lg)
                region_cols = max(
                    region_cols,
                    (K_g + n_blk_g) * Lg,
                    (K_g - 1) * Lg + span_g,
                )
            slack = max(
                region_cols + L // self.ratio_den + MIN_READ_SLACK,
                gather_need,
            )
        return -(-slack // 256) * 256

    @property
    def buffer_alloc(self) -> int:
        return self.input_capacity + self.read_slack

    @property
    def out_capacity(self) -> int:
        """Maximum output frames a single call can produce."""
        max_usable = self.input_capacity - self.taps
        exact = (max_usable * self.ratio_den) // self.ratio_num + (
            1 if (max_usable * self.ratio_den) % self.ratio_num else 0
        ) + 2
        return min(exact, OUT_CAP_MAX)

    @property
    def delay(self) -> int:
        """Algorithmic latency in input samples
        (reference: src/resampler_fir.rs:623-632)."""
        return self.taps // 2


def zero_position(config: FirConfig) -> dict:
    """The schedule position at stream start: ``pos_num`` on the int32
    envelope, ``pos_hi`` / ``pos_lo`` (u32 words, Python ints) when wide."""
    return dict(pos_hi=0, pos_lo=0) if config.wide else dict(pos_num=0)


def fir_init(config: FirConfig, device="cuda") -> dict:
    """Zero per-stream state: ``buffer [C, buffer_alloc]`` f32 on
    ``device``, ``available_frames`` and the position as Python ints."""
    return dict(
        buffer=torch.zeros(
            (config.channels, config.buffer_alloc),
            dtype=torch.float32,
            device=resolve_device(device),
        ),
        available_frames=0,
        **zero_position(config),
    )


def fir_init_batched(config: FirConfig, n_streams: int, device="cuda") -> dict:
    """Zero state of ``n_streams`` independent streams (the JAX package's
    ``vmap(fir_init)``): ``buffer [B, C, buffer_alloc]`` f32 on ``device``,
    ``available_frames`` and the position words as ``[B]`` int64 numpy."""
    zeros = np.zeros(n_streams, np.int64)
    return dict(
        buffer=torch.zeros(
            (n_streams, config.channels, config.buffer_alloc),
            dtype=torch.float32,
            device=resolve_device(device),
        ),
        available_frames=zeros.copy(),
        **{k: zeros.copy() for k in zero_position(config)},
    )


_COEFF_CACHE: dict[tuple, np.ndarray] = {}
_COEFF_LOCK = threading.Lock()


def fir_cutoff(taps: int, attenuation: Attenuation, ratio: float) -> float:
    """Normalized cutoff: Kaiser-theory cutoff for ``taps``, scaled to the
    output Nyquist when downsampling (reference: src/resampler_fir.rs:316-324)."""
    base = calculate_cutoff_kaiser(taps, attenuation.kaiser_beta)
    if ratio > 1.0:
        return base / ratio
    return base


def fir_coefficients(
    taps: int, attenuation: Attenuation, cutoff: float
) -> np.ndarray:
    """``[PHASES, taps]`` float32 polyphase table, cached process-wide by
    ``(cutoff bits, taps, attenuation)``."""
    key = (np.float32(cutoff).tobytes(), taps, attenuation)
    with _COEFF_LOCK:
        table = _COEFF_CACHE.get(key)
        if table is None:
            table = make_sincs_for_kaiser(
                taps,
                PHASES,
                float(np.float32(cutoff)),
                attenuation.kaiser_beta,
                WindowType.SYMMETRIC,
            )
            _COEFF_CACHE[key] = table
    return table


def _compute_n_out(config: FirConfig, pos_num: int, avail: int, out_budget: int) -> int:
    """Output frames producible this call: the largest ``n`` with
    ``pos_num + (n-1)*L < (avail - taps + 1) * M``, capped by the
    caller's budget (reference loop guard: src/resampler_fir.rs:544-554)."""
    L, M = config.ratio_num, config.ratio_den
    limit = (avail - config.taps + 1) * M - pos_num
    n_from_input = (limit + L - 1) // L if limit > 0 else 0
    return min(max(n_from_input, 0), out_budget)


def stream_schedule(config: FirConfig, avail, pos_num, n_valid, out_budget):
    """``make_fir_step``'s copy-in and emission count for every stream at
    once, ``[B]`` int64 numpy in and out: ``(to_copy, avail + to_copy,
    n_out)``.  ``n_valid`` is already clipped to the chunk."""
    L, M = config.ratio_num, config.ratio_den
    to_copy = np.minimum(n_valid, config.input_capacity - avail)
    avail = avail + to_copy
    limit = (avail - config.taps + 1) * M - pos_num
    # ceil(limit / L) where limit > 0, else <= 0 and clipped to 0
    n_out = np.minimum(np.maximum(-(-limit // L), 0), out_budget)
    return to_copy, avail, n_out


def stream_consume(config: FirConfig, pos_num, n_out, avail):
    """``make_fir_step``'s consume for every stream at once: ``(avail',
    pos_num')`` after emitting ``n_out`` outputs, ``[B]`` int64 numpy."""
    L, M = config.ratio_num, config.ratio_den
    pos_after = pos_num + n_out * L
    consumed = np.minimum(pos_after // M, avail)
    return avail - consumed, pos_after - consumed * M


def slide_in(buffers, chunks, to_copy: np.ndarray, valid_end: int):
    """The end-aligned copy-in of every stream (the JAX step's masked
    concat at the static seam and window ending at the new valid end):
    ``[old[to_copy:valid_end] | chunk[:to_copy] | 0]`` per stream.
    ``buffers [B, C, alloc]``, ``chunks [B, n, C]`` (any strides),
    ``to_copy [B]``; returns a new ``[B, C, alloc]`` tensor.  Frames past
    ``to_copy`` are selected out, never multiplied (the NaN fence)."""
    B, C, alloc = buffers.shape
    dev = buffers.device
    tc = torch.from_numpy(np.array(to_copy, np.int64)).to(dev)
    fresh = chunks.transpose(1, 2)  # [B, C, n]
    frame = torch.arange(fresh.shape[2], device=dev)
    fresh = torch.where((frame[None, :] < tc[:, None])[:, None, :], fresh, 0.0)
    conc = torch.cat([buffers[:, :, :valid_end], fresh], dim=2)
    cols = (tc[:, None] + torch.arange(valid_end, device=dev))[:, None, :]
    return torch.cat(
        [conc.gather(2, cols.expand(B, C, valid_end)),
         buffers.new_zeros((B, C, alloc - valid_end))],
        dim=2,
    )


_U32 = (1 << 32) - 1


def _scalars(*words) -> bool:
    """Whether every word is one number (a Python int, or a 0-d array or
    numpy scalar), not a ``[B]`` array."""
    return all(type(w) is int or np.ndim(w) == 0 for w in words)


class WideSchedule:
    """The wide schedule's static split tables and per-step arithmetic
    (``resampler_tpu.engine.fir._make_wide_step``, shared by the fleet).

    The position is ``pos_hi + pos_lo / M`` input frames, two u32 words
    held as Python ints.  Every sum wraps mod 2^32 and every carry is
    detected as the JAX package detects it (a wrapped sum compares
    smaller), and the frame word saturates where JAX's does, so counts
    and states equal the JAX package's for every u32 pair -- including
    its documented under-skip for ``L//M > 2^32 - 8195`` (PARITY.md)."""

    def __init__(self, config: FirConfig, out_cap: int | None = None):
        L, M, N = config.ratio_num, config.ratio_den, out_cap or config.out_capacity
        self.L, self.M, self.N, self.taps = L, M, N, config.taps
        self.clamp = config.input_capacity + 2
        i = np.arange(N, dtype=np.int64)
        self.j_lane = np.minimum((i * L) // M, self.clamp).astype(np.uint32)
        self.s_lane = ((i * L) % M).astype(np.uint32)
        n = np.arange(N + 1, dtype=np.int64)
        self.nl_hi = np.minimum((n * L) // M, _U32).astype(np.uint32)
        self.nl_lo = ((n * L) % M).astype(np.uint32)
        # the stride tables as Python ints, for one shared position
        self._nl = list(zip(self.nl_hi.tolist(), self.nl_lo.tolist()))

    def emitted(self, pos_hi, pos_lo, avail):
        """Lanes whose taps window ends inside the ``avail`` buffered
        frames (the emission mask's count, on the host): an int, or for
        ``[B]`` arrays of words and frames one count per stream.  One
        position takes the closed form, short of the u32 corners."""
        if _scalars(pos_hi, pos_lo):
            n = self._emitted_closed(int(pos_hi), int(pos_lo), int(avail))
            if n is not None:
                return n
        return self.emitted_mask(pos_hi, pos_lo, avail)

    def _emitted_closed(self, hi: int, lo: int, avail: int):
        """``emitted`` for one position in closed form, or ``None`` where a
        u32 sum of the mask could wrap.  Short of a wrap, lane ``i`` is
        emitted iff ``j_lane + wrap <= a = avail - hi - taps``.  Below the
        frame clamp ``j_lane + wrap = (i*L + lo) // M`` grows with ``i``;
        the lanes held at the clamp read ``clamp`` or ``clamp + 1``, so
        ``a == clamp``, the one value that splits them, takes the mask."""
        M, a = self.M, avail - self.taps - hi
        if not (0 <= lo < M and 0 <= hi and 2 * M <= _U32 + 1
                and hi + self.clamp + 1 + self.taps <= _U32) or a == self.clamp:
            return None
        if a < 0:
            return 0
        if a > self.clamp:
            return self.N
        return min(self.N, ((a + 1) * M - lo - 1) // self.L + 1)

    def emitted_mask(self, pos_hi, pos_lo, avail):
        """``emitted`` lane by lane: the mask over every output lane, in the
        JAX package's u32 arithmetic."""
        hi = np.asarray(pos_hi, np.uint32)[..., None]
        lo = np.asarray(pos_lo, np.uint32)[..., None]
        t = lo + self.s_lane
        wrap = ((t < lo) | (t >= self.M)).astype(np.uint32)
        o1 = hi + self.j_lane
        o2 = o1 + wrap + np.uint32(self.taps)
        ok = (o1 >= hi) & (o2 >= o1) & (o2 <= np.asarray(avail, np.int64)[..., None])
        n = ok.sum(axis=-1)
        return int(n) if n.ndim == 0 else n.astype(np.int64)

    def _stride(self, pos_hi, pos_lo, n_out):
        """The words after a stride of ``n_out * L`` (``n_out`` an int or
        one per stream): the static tables, the subframe carry and the
        saturating frame add, as int64 arrays."""
        M = self.M
        pos_hi, pos_lo = np.asarray(pos_hi, np.int64), np.asarray(pos_lo, np.int64)
        t2 = (pos_lo + self.nl_lo[n_out].astype(np.int64)) & _U32
        carry = (t2 < pos_lo) | (t2 >= M)
        lo_after = np.where(carry, (t2 - M) & _U32, t2)
        hi_raw = (pos_hi + self.nl_hi[n_out].astype(np.int64) + carry) & _U32
        return np.where(hi_raw < pos_hi, _U32, hi_raw), lo_after

    def advance(self, pos_hi, pos_lo, n_out: int, avail: int):
        """``(consumed, pos_hi', pos_lo')`` after emitting ``n_out``
        outputs, with eager consumption.  The words are Python ints (one
        shared position), or int64 arrays of per-stream words (the async
        fleet), which all advance by the same stride and are consumed by
        their minimum."""
        if _scalars(pos_hi, pos_lo):
            # one shared position: the same u32 sums on Python ints
            hi, lo, M = int(pos_hi), int(pos_lo), self.M
            nl_hi, nl_lo = self._nl[n_out]
            t2 = (lo + nl_lo) & _U32
            carry = int(t2 < lo or t2 >= M)
            lo_after = (t2 - M) & _U32 if carry else t2
            hi_raw = (hi + nl_hi + carry) & _U32
            hi_after = _U32 if hi_raw < hi else hi_raw
            consumed = min(hi_after, avail)
            return consumed, int(hi_after - consumed), lo_after
        hi_after, lo_after = self._stride(pos_hi, pos_lo, n_out)
        consumed = min(int(hi_after.min()), avail)
        hi_after -= consumed
        if hi_after.ndim == 0:
            return consumed, int(hi_after), int(lo_after)
        return consumed, hi_after, lo_after

    def advance_each(self, pos_hi, pos_lo, n_out, avail):
        """``advance`` for independent streams (the vmapped fleet): each
        ``[B]`` word pair takes its own stride ``n_out[b] * L`` and is
        consumed by its own frames, ``min(pos_hi', avail)``.  Returns
        ``(avail', pos_hi', pos_lo')`` as int64 arrays."""
        hi_after, lo_after = self._stride(pos_hi, pos_lo, n_out)
        consumed = np.minimum(hi_after, avail)
        return avail - consumed, hi_after - consumed, lo_after


def lane_residues(s: np.ndarray, M: int, pos):
    """Per-lane ``(wrap, rem)`` of the shared position against the static
    splits ``s = (i*L) % M``: ``rem = (pos mod M + s) mod M`` and the
    carry ``wrap``.  ``pos`` is ``pos_num`` (int32 envelope, exact ints)
    or ``(pos_hi, pos_lo)`` (wide: u32 sums that wrap, as in JAX)."""
    if isinstance(pos, tuple):
        pos_lo = pos[1]
        t = np.uint32(pos_lo) + s.astype(np.uint32)
        wrap = (t < pos_lo) | (t >= M)
        rem = np.where(wrap, t - np.uint32(M), t)
        return wrap.astype(np.int64), rem
    r = pos % M
    wrap = (r + s >= M).astype(np.int64)
    return wrap, r + s - M * wrap


def combine_basis(rem: np.ndarray, M: int, U=None, phases: int = PHASES) -> np.ndarray:
    """Per-output combine coefficients ``[..., d1]`` f32 for residues
    ``rem``: the Chebyshev values ``T_d(2*rem/M - 1)`` (``U is None``,
    the farrow basis), or the table-lerp of rows of the SVD factor ``U``
    with the reference's ``p2 = min(p1 + 1, phases - 1)`` clamp (lerp).
    The same f32 arithmetic as the JAX package, on the host."""
    if U is None:
        frac = rem.astype(np.float32) / np.float32(M)
        u = np.float32(2.0) * frac - np.float32(1.0)
        ts = [np.ones_like(u), u]
        for _ in range(FARROW_DEGREE - 1):
            ts.append(np.float32(2.0) * u * ts[-1] - ts[-2])
        return np.stack(ts, axis=-1)
    pf = rem.astype(np.int64) * phases
    p1 = pf // M
    p2 = np.minimum(p1 + 1, phases - 1)
    fp = (pf - p1 * M).astype(np.float32) / np.float32(M)
    u1, u2 = U[p1], U[p2]
    return u1 + fp[..., None] * (u2 - u1)


def farrow_block_size(L: int, M: int, block: int = FARROW_BLOCK) -> int:
    """Outputs per Farrow block, adapted to the ratio so a block's input
    span stays ~``block`` frames (copied from the JAX package)."""
    return max(1, min(FARROW_BLOCK_MAX, (block * M) // max(L, 1)))


def farrow_matrix(coeffs, degree: int = FARROW_DEGREE):
    """``[degree+1, taps]`` Chebyshev-basis coefficients fit to the phase
    table, ``c_t(phi) ~= sum_k A[k, t] T_k(2 phi - 1)``; returns ``(A f32,
    max grid residual)`` (copied from the JAX package)."""
    table = np.asarray(coeffs, np.float64)
    P = table.shape[0]
    u = 2 * (np.arange(P) / P) - 1
    V = np.polynomial.chebyshev.chebvander(u, degree)
    A, *_ = np.linalg.lstsq(V, table, rcond=None)
    resid = float(np.abs(V @ A - table).max())
    return A.astype(np.float32), resid


def _table_svd_basis(coeffs, tol: float = 1e-7):
    """Rank-r factorization ``T ~= U @ A`` of the phase table with
    ``max|T - U@A| < tol`` (f64 SVD, singular values folded into U;
    copied from the JAX package)."""
    T = np.asarray(coeffs, np.float64)
    Uf, s, Vt = np.linalg.svd(T, full_matrices=False)
    r = len(s)
    for cand in range(1, len(s) + 1):
        err = np.abs((Uf[:, :cand] * s[:cand]) @ Vt[:cand] - T).max()
        if err < tol:
            r = cand
            break
    return (Uf[:, :r] * s[:r]).astype(np.float32), Vt[:r].astype(np.float32)


def _basis_tables(config: FirConfig, coeffs, path: str):
    """Static tables of the coprime-ratio convolve: each output's row
    ``j = (i*L)//M`` (clamped at the buffer edge when wide: such lanes can
    never be emitted, and the clamp bounds the region, as in the JAX
    package) and split ``s = (i*L) % M``, the region length, the basis
    ``A [d1, taps]`` and (lerp) the SVD factor ``U``."""
    L, M, N = config.ratio_num, config.ratio_den, config.out_capacity
    i = np.arange(N, dtype=np.int64)
    j = (i * L) // M
    if config.wide:
        j = np.minimum(j, config.input_capacity + 2)
    if path == "lerp":
        U, A = _table_svd_basis(coeffs)
    else:
        U, (A, _) = None, farrow_matrix(coeffs)
    return j, (i * L) % M, int(j[-1]) + 2 + config.taps, A, U


def _convolve_basis(config: FirConfig, coeffs, path: str, device: torch.device):
    """Coprime-ratio path (``resampler_tpu.engine.fir._convolve_farrow``
    and ``_convolve_lerp``): per call

        Y[c, d, p] = sum_t A[d, t] * region[c, p + t]       (basis responses)
        out[i, c]  = sum_d v[i, d] * Y[c, d, j_i + wrap_i]

    with ``A`` the Chebyshev fit (farrow) or the SVD table basis (lerp)
    and ``v`` the per-output combine coefficients (``combine_basis``).
    The basis responses are an ``unfold`` window view and an einsum
    (a ``conv1d`` would run TF32 on the card).  The JAX package selects
    ``Y[.., j_i + wrap_i]`` through blocked one-hot contractions because
    the TPU cannot gather; here it is one index, and the sum over ``d``
    is the same."""
    M, taps = config.ratio_den, config.taps
    wide = config.wide
    j, s, region_len, A, U = _basis_tables(config, coeffs, path)
    A = torch.from_numpy(A).to(device)  # [d1, taps]

    def convolve(buffer, read_pos: int, pos):
        avail = config.input_capacity - read_pos
        base = min(pos[0] if wide else pos // M, avail)
        wrap, rem = lane_residues(s, M, pos)
        v = upload(combine_basis(rem, M, U), device)  # [N, d1]
        idx = upload(j + wrap, device)
        start = read_pos + base
        check_window(start, region_len, buffer.shape[1], f"{path} region")
        region = buffer[:, start : start + region_len]
        y = torch.einsum("dt,cpt->cdp", A, region.unfold(1, taps, 1))
        return torch.einsum("nd,cdn->nc", v, y[:, :, idx])

    return convolve


def combine_basis_device(rem: torch.Tensor, M: int, U=None, phases: int = PHASES):
    """``combine_basis`` on the device, for the ``[B, N]`` residues of a
    vmapped fleet (host numpy over such tables cost far more than the
    step; PERF.md): the same f32 operations, in the same order, on an
    int64 tensor of residues; ``U`` (lerp) a tensor on its device."""
    M_f = torch.tensor(np.float32(M), device=rem.device)
    if U is None:
        u = 2.0 * (rem.to(torch.float32) / M_f) - 1.0
        ts = [torch.ones_like(u), u]
        for _ in range(FARROW_DEGREE - 1):
            ts.append(2.0 * u * ts[-1] - ts[-2])
        return torch.stack(ts, dim=-1)
    pf = rem * phases
    p1 = pf // M
    p2 = torch.clamp(p1 + 1, max=phases - 1)
    fp = (pf - p1 * M).to(torch.float32) / M_f
    u1, u2 = U[p1], U[p2]
    return u1 + fp[..., None] * (u2 - u1)


def _convolve_basis_batched(config: FirConfig, coeffs, path: str, device: torch.device):
    """``_convolve_basis`` for independent streams: each stream's region
    starts at its own row and each output takes its own stream's residue.
    ``convolve(buffers [B, C, alloc], avail [B], pos, n_out [B]) -> out
    [B, out_cap, C]`` (lanes past each ``n_out`` zero), ``pos`` the
    ``[B]`` ``pos_num`` or the wide ``(pos_hi, pos_lo)`` words.  The
    ``[B, N]`` residues and combine coefficients are computed on the
    device from each stream's residue word (``lane_residues``' exact
    integer arithmetic, u32 sums wrapped as in JAX when wide).  Streams
    that emit nothing read no region of their own."""
    M, taps, N = config.ratio_den, config.taps, config.out_capacity
    valid_end = config.input_capacity
    wide = config.wide
    j, s, region_len, A, U = _basis_tables(config, coeffs, path)
    A = torch.from_numpy(A).to(device)  # [d1, taps]
    d1 = A.shape[0]
    j, s = torch.from_numpy(j).to(device), torch.from_numpy(s).to(device)
    U = None if U is None else torch.from_numpy(U).to(device)
    lane = torch.arange(N, device=device)
    rows = torch.arange(region_len, device=device)

    def convolve(buffers, avail, pos, n_out):
        B, C, alloc = buffers.shape
        emitting = n_out > 0
        base = np.minimum(pos[0] if wide else pos // M, avail)
        start = np.where(emitting, valid_end - avail + base, 0)
        bad = emitting & ((start < 0) | (start + region_len > alloc))
        if bad.any():
            b = int(np.flatnonzero(bad)[0])
            check_window(int(start[b]), region_len, alloc, f"stream {b} region")
        # one upload: each stream's residue word, region start and n_out
        words = upload(np.stack([pos[1] if wide else pos % M, start, n_out]), device)
        res = words[0][:, None]
        t = res + s  # [B, N]
        if wide:
            t = t & _U32
            wrap = (t < res) | (t >= M)
            rem = torch.where(wrap, (t - M) & _U32, t)
        else:
            wrap = t >= M
            rem = t - M * wrap
        v = combine_basis_device(rem, M, U)  # [B, N, d1]
        idx = j + wrap
        region = buffers.gather(
            2, (words[1][:, None] + rows)[:, None, :].expand(B, C, region_len)
        )
        y = torch.einsum("dt,bcpt->bcdp", A, region.unfold(2, taps, 1))
        sel = y.gather(3, idx[:, None, None, :].expand(B, C, d1, N))
        out = torch.einsum("bnd,bcdn->bnc", v, sel)
        keep = lane[None, :] < words[2][:, None]
        return torch.where(keep[:, :, None], out, 0.0)

    return convolve


def _use_im2col(L: int, taps: int) -> bool:
    """im2col pads the contraction to n_blk*L columns; worth it unless the
    padding exceeds ~50% extra FLOPs over the exact span (L >> taps)."""
    span = L + taps + 1
    n_blk = 1 + -(-(span - L) // L)
    return n_blk * L <= 1.5 * span and n_blk <= 256


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A per-step host table on ``device`` without waiting for the
    device: a copy from pageable memory would synchronize the stream, so
    the table is staged in pinned memory (PyTorch's caching host
    allocator keeps the block until the transfer is done) and sent
    asynchronously."""
    t = torch.from_numpy(array)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def check_window(start: int, size: int, limit: int, what: str) -> None:
    """Raise unless rows ``[start, start + size)`` lie inside ``[0, limit)``.
    ``jax.lax.dynamic_slice`` clamps an out-of-range start (shifting the
    window); torch slicing would silently truncate it.  The port checks
    the invariant instead."""
    if start < 0 or start + size > limit:
        raise IndexError(
            f"{what}: window [{start}, {start + size}) outside [0, {limit})"
        )


def phase_rows(config: FirConfig, coeffs) -> np.ndarray:
    """``W [M, taps]`` f32: the table row blended for each residue ``rho``
    (rows ``floor(rho*P/M)`` and the next, clamped, lerped by the
    fraction; the JAX package's arithmetic, in numpy f32)."""
    M = config.ratio_den
    table = np.asarray(coeffs, np.float32)
    pf = np.arange(M, dtype=np.int64) * config.phases
    p1 = pf // M
    p2 = np.minimum(p1 + 1, config.phases - 1)
    frac = ((pf - p1 * M) / M).astype(np.float32)[:, None]
    return (1.0 - frac) * table[p1] + frac * table[p2]


def _sync_atlas(config: FirConfig, coeffs) -> np.ndarray:
    """Doubled banded-kernel atlas ``[2M, 2L + taps + 1]``:
    ``A2[i, s] = W[(i*L) % M][s - (i*L)//M]`` with ``W = phase_rows``
    (numpy, same arithmetic as the JAX package's ``_sync_atlas``)."""
    L, M, taps = config.ratio_num, config.ratio_den, config.taps
    w_resid = phase_rows(config, coeffs)
    i = np.arange(2 * M, dtype=np.int64)
    a2 = np.zeros((2 * M, 2 * L + taps + 1), np.float32)
    for ii in range(2 * M):
        off = int((i[ii] * L) // M)
        a2[ii, off : off + taps] = w_resid[int((i[ii] * L) % M)]
    return a2


def _convolve_periodic(config: FirConfig, coeffs, device: torch.device):
    """Small-denominator path: the polyphase schedule is periodic with
    ``M`` outputs per ``L`` inputs, so with ``r = pos_num mod M`` every
    period block ``k`` reads a contiguous segment and

        out[k*M + j, c] = sum_s A(r)[j, s] * region[c, k*L + s]

    where ``A(r)`` is a contiguous ``[M, span]`` window (rows ``i0..i0+M``,
    ``i0 = r * L^-1 mod M``) of the doubled banded atlas ``_sync_atlas``.

    Both of the JAX module's branches read the same region as there and
    run as im2col + matmul.  The JAX conv branch (``L >> taps``) is NOT a
    ``conv1d``: cuDNN would run it in TF32.  Its stride-``L`` windows are
    an ``unfold`` view instead."""
    L, M, taps, C = config.ratio_num, config.ratio_den, config.taps, config.channels
    span = L + taps + 1
    K = -(-config.out_capacity // M)
    a2 = torch.from_numpy(_sync_atlas(config, coeffs)).to(device)
    l_inv = pow(L, -1, M) if M > 1 else 0
    im2col = _use_im2col(L, taps)
    if im2col:
        n_blk = 1 + -(-(span - L) // L)
        s_len = n_blk * L
        region_len = (K + n_blk) * L
    else:
        region_len = (K - 1) * L + span

    def convolve(buffer, read_pos: int, pos_num: int):
        d_min, r = divmod(pos_num, M)
        i0 = (r * l_inv) % M
        c0 = (i0 * L) // M
        a = a2[i0 : i0 + M, c0 : c0 + span]
        base = read_pos + d_min
        check_window(base, region_len, buffer.shape[1], "periodic region")
        region = buffer[:, base : base + region_len]
        if im2col:
            blocks = region.reshape(C, K + n_blk, L)
            segs = torch.cat(
                [blocks[:, b : b + K, :] for b in range(n_blk)], dim=2
            )  # [C, K, s_len]
            a = torch.nn.functional.pad(a, (0, s_len - span))
        else:
            segs = region.unfold(1, span, L)  # [C, K, span]
        out = torch.einsum("js,cks->kjc", a, segs)  # [K, M, C]
        return out.reshape(K * M, C)[: config.out_capacity]

    return convolve


def resolve_convolve_path(config: FirConfig, path: str = "auto") -> str:
    """The periodic banded matmul whenever the schedule period fits; the
    Farrow path for every other ratio (same rule as the JAX package)."""
    if path != "auto":
        return path
    atlas_bytes = 8 * config.ratio_den * (2 * config.ratio_num + config.taps + 1)
    if (
        config.ratio_den <= MAX_PERIOD
        and config.ratio_num <= MAX_PERIOD_L
        and atlas_bytes <= MAX_ATLAS_BYTES
    ):
        return "periodic"
    return "farrow"


def resolve_path(config: FirConfig, path: str = "auto") -> str:
    """``resolve_convolve_path`` plus the JAX ``make_fir_step`` rules:
    the wide schedule takes only the farrow path; ``"gather"`` (the
    table-lerp oracle) is not ported."""
    path = resolve_convolve_path(config, path)
    if path == "gather":
        raise NotImplementedError(
            "the 'gather' convolve path is not ported yet (ROADMAP A9)"
        )
    if path not in ("periodic", "farrow", "lerp"):
        raise ValueError(f"unknown convolve path {path!r}")
    if config.wide and path != "farrow":
        raise ValueError(
            f"ratios beyond the int32 schedule envelope use the farrow "
            f"path (wide uint32 scheduling), not {path!r}"
        )
    return path


def make_fir_step(
    config: FirConfig, coeffs: np.ndarray, *, path: str = "auto", device="cuda"
):
    """Build the chunk-step function for ``config``.

    ``step(state, chunk [n, C] f32 tensor, n_valid, out_budget) ->
    (state', out [out_capacity, C] f32, consumed, produced)``, frames
    counted per channel, ``consumed``/``produced`` Python ints.  Same
    semantics as ``resampler_tpu.engine.fir.make_fir_step``: end-aligned
    copy-in, exact integer schedule (two u32 words when wide), convolve
    (periodic, farrow or lerp), masked tail, consume."""
    path = resolve_path(config, path)
    device = resolve_device(device)
    coeffs = np.asarray(coeffs, np.float32)
    assert coeffs.shape == (config.phases, config.taps)
    C = config.channels
    L, M = config.ratio_num, config.ratio_den
    valid_end = config.input_capacity
    out_cap = config.out_capacity
    if path == "periodic":
        convolve = _convolve_periodic(config, coeffs, device)
    else:
        convolve = _convolve_basis(config, coeffs, path, device)
    wide = WideSchedule(config) if config.wide else None

    def step(state: dict, chunk, n_valid: int, out_budget: int):
        chunk = torch.as_tensor(chunk, dtype=torch.float32, device=device)
        n_in = chunk.shape[0]
        if chunk.ndim != 2 or chunk.shape[1] != C or n_in > valid_end:
            raise ValueError(
                f"chunk must be [n <= {valid_end}, {C}], got {tuple(chunk.shape)}"
            )
        if n_valid < 0:
            raise ValueError(f"n_valid must be >= 0, got {n_valid}")
        n_valid = min(int(n_valid), n_in)

        buffer = state["buffer"]
        avail = state["available_frames"]

        # ---- copy-in: the valid region always ends at column valid_end;
        # frames past to_copy are never written (the NaN fence) ----
        to_copy = min(n_valid, valid_end - avail)
        buffer = torch.cat(
            [
                buffer[:, to_copy:valid_end],
                chunk[:to_copy].T,
                buffer.new_zeros((C, config.read_slack)),
            ],
            dim=1,
        )
        avail += to_copy

        # ---- schedule (reference hot loop: src/resampler_fir.rs:542-565);
        # the wide one counts its emission mask ----
        if wide:
            pos = (state["pos_hi"], state["pos_lo"])
            n_out = min(wide.emitted(*pos, avail), int(out_budget))
        else:
            pos = state["pos_num"]
            n_out = _compute_n_out(config, pos, avail, int(out_budget))

        # ---- convolution; a step that emits nothing skips it (its lanes
        # are all masked, and the JAX read there may be a clamped one) ----
        if n_out:
            out = convolve(buffer, valid_end - avail, pos)
            out[n_out:] = 0.0
        else:
            out = buffer.new_zeros((out_cap, C))

        # ---- consume (reference: src/resampler_fir.rs:592-615) ----
        if wide:
            consumed, hi, lo = wide.advance(*pos, n_out, avail)
            pos_state = dict(pos_hi=hi, pos_lo=lo)
        else:
            pos_after = pos + n_out * L
            consumed = min(pos_after // M, avail)
            pos_state = dict(pos_num=pos_after - consumed * M)
        new_state = dict(buffer=buffer, available_frames=avail - consumed, **pos_state)
        return new_state, out, to_copy, n_out

    return step


def stream_words(values, n: int, what: str) -> np.ndarray:
    """``values`` as ``[n]`` int64 numpy, one per stream; any other shape
    raises."""
    arr = np.asarray(values, np.int64)
    if arr.shape != (n,):
        raise ValueError(f"{what} must hold one value per stream ({n},), got {arr.shape}")
    return arr


def stream_ints(values, n_streams: int, what: str) -> np.ndarray:
    """A per-stream count as ``[B]`` int64 numpy (a scalar broadcasts);
    negative counts raise."""
    arr = np.broadcast_to(np.asarray(values, np.int64), (n_streams,)).copy()
    if (arr < 0).any():
        raise ValueError(f"{what} must be >= 0, got {arr.min()}")
    return arr


def make_fir_step_batched(
    config: FirConfig, coeffs: np.ndarray, n_streams: int, *, path: str = "auto",
    device="cuda",
):
    """Build the chunk step of ``n_streams`` independent streams, the
    counterpart of the JAX package's ``jax.vmap(make_fir_step)``.

    ``step(state, chunks [B, n, C] f32, n_valid [B], out_budget [B]) ->
    (state', out [B, out_capacity, C] f32, consumed [B], produced [B])``
    with ``consumed`` / ``produced`` int64 numpy; ``state`` as
    ``fir_init_batched`` makes it.  Per stream the semantics of
    ``make_fir_step``: each stream has its own ``avail``, position,
    ``n_valid`` and budget.

    The schedule is whole-fleet numpy on the host, so a step never waits
    on the device.  On the periodic path the step is kernel B9
    (``ops/fir_kernel.py``: the copy-in and the banded contraction, one
    step on the card, its plain version on the CPU); it writes the next
    buffer into a second ``[B, C, alloc]`` tensor and recycles the
    previous state's buffer as the one after (the JAX wrapper donates its
    state for the same reason), so a state's buffer is overwritten two
    steps later.
    Farrow, lerp and the wide schedule run the copy-in (``slide_in``) and
    a batched ``_convolve_basis`` in torch ops, as the JAX package leaves
    them to XLA."""
    path = resolve_path(config, path)
    device = resolve_device(device)
    coeffs = np.asarray(coeffs, np.float32)
    assert coeffs.shape == (config.phases, config.taps)
    B, C = n_streams, config.channels
    valid_end = config.input_capacity

    def checked(state, chunks, n_valid, out_budget):
        chunks = torch.as_tensor(chunks, dtype=torch.float32, device=device)
        with tracing.span("fir.check"):
            if chunks.ndim != 3 or chunks.shape[0] != B or chunks.shape[2] != C or (
                chunks.shape[1] > valid_end
            ):
                raise ValueError(
                    f"chunks must be [{B}, n <= {valid_end}, {C}], got {tuple(chunks.shape)}"
                )
            if tuple(state["buffer"].shape) != (B, C, config.buffer_alloc):
                raise ValueError(f"state buffer must be [{B}, {C}, {config.buffer_alloc}]")
            n_valid = np.minimum(stream_ints(n_valid, B, "n_valid"), chunks.shape[1])
            return chunks, n_valid, stream_ints(out_budget, B, "out_budget")

    if path == "periodic":
        from ..ops.fir_kernel import FleetStepPlan, SpareBuffer, fir_fleet_step

        plan = FleetStepPlan(config, coeffs)
        spare = SpareBuffer()

        def step(state: dict, chunks, n_valid, out_budget):
            chunks, n_valid, budget = checked(state, chunks, n_valid, out_budget)
            buffer = state["buffer"]
            buffer, out, avail, pos, to_copy, n_out = fir_fleet_step(
                plan, buffer, chunks, state["available_frames"], state["pos_num"],
                n_valid, budget, out_buffers=spare.swap(buffer),
            )
            return dict(buffer=buffer, available_frames=avail, pos_num=pos), out, to_copy, n_out

        return step

    convolve = _convolve_basis_batched(config, coeffs, path, device)
    wide = WideSchedule(config) if config.wide else None

    def step(state: dict, chunks, n_valid, out_budget):
        chunks, n_valid, budget = checked(state, chunks, n_valid, out_budget)
        with tracing.span("fir.schedule"):
            avail = np.asarray(state["available_frames"], np.int64)
            if wide:
                pos = (np.asarray(state["pos_hi"], np.int64),
                       np.asarray(state["pos_lo"], np.int64))
                to_copy = np.minimum(n_valid, valid_end - avail)
                avail = avail + to_copy
                n_out = np.minimum(wide.emitted(*pos, avail), budget)
            else:
                pos = np.asarray(state["pos_num"], np.int64)
                to_copy, avail, n_out = stream_schedule(config, avail, pos, n_valid, budget)
        with tracing.span("fir.contract"):
            buffer = slide_in(state["buffer"], chunks, to_copy, valid_end)
            out = convolve(buffer, avail, pos, n_out)
        with tracing.span("fir.schedule"):
            if wide:
                avail, hi, lo = wide.advance_each(*pos, n_out, avail)
                pos_state = dict(pos_hi=hi, pos_lo=lo)
            else:
                avail, pos = stream_consume(config, pos, n_out, avail)
                pos_state = dict(pos_num=pos)
        return dict(buffer=buffer, available_frames=avail, **pos_state), out, to_copy, n_out

    return step


def _periodic_group_factor(L: int, M: int) -> int:
    """Group ``g`` schedule periods of the banded atlas into one
    UNREDUCED ``(gL, gM)`` atlas so the periodic contraction has >= 128
    output rows.  Grouping is free at the schedule level:
    ``(i*gL) // (gM) == (i*L) // M`` exactly, so the grouped atlas rows
    are bit-identical to the reduced ones.  ``g`` also rounds up so
    ``g*L % 8 == 0`` (kept for parity with the JAX package)."""
    if M >= 128:
        return 1
    g = -(-128 // M)
    align = 8 // math.gcd(L, 8)
    return -(-g // align) * align
