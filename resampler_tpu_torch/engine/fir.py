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

Only the narrow periodic path is ported; the farrow/lerp/gather paths
and the wide u32 schedule raise ``NotImplementedError`` (ROADMAP A5, A9).
"""

from __future__ import annotations

import dataclasses
import math
import threading

import numpy as np
import torch

from ..dsp.window import WindowType, calculate_cutoff_kaiser, make_sincs_for_kaiser
from ..types import Attenuation

__all__ = [
    "PHASES",
    "INPUT_CAPACITY",
    "MAX_CHUNK",
    "FirConfig",
    "fir_init",
    "fir_cutoff",
    "fir_coefficients",
    "make_fir_step",
    "resolve_convolve_path",
    "resolve_device",
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
#: quantity below 2^31; beyond it the JAX engine switches to the WIDE
#: u32 schedule (not ported yet, ROADMAP A5).
MAX_REDUCED_RATE = 500_000
#: Static output-lane cap for extreme upsampling ratios.
OUT_CAP_MAX = 1 << 20
#: Periodic-path limits: the banded kernel atlas is [2M, 2L + taps + 1].
MAX_PERIOD = 2048
MAX_PERIOD_L = 4000
MAX_ATLAS_BYTES = 32 << 20


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
        (the JAX engine's u32 two-word schedule; not ported yet)."""
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


def fir_init(config: FirConfig, device="cpu") -> dict:
    """Zero per-stream state: ``buffer [C, buffer_alloc]`` f32 on
    ``device``, ``available_frames`` and ``pos_num`` Python ints."""
    if config.wide:
        raise NotImplementedError(
            "the wide u32 schedule is not ported yet (ROADMAP A5)"
        )
    return dict(
        buffer=torch.zeros(
            (config.channels, config.buffer_alloc),
            dtype=torch.float32,
            device=resolve_device(device),
        ),
        available_frames=0,
        pos_num=0,
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


def _use_im2col(L: int, taps: int) -> bool:
    """im2col pads the contraction to n_blk*L columns; worth it unless the
    padding exceeds ~50% extra FLOPs over the exact span (L >> taps)."""
    span = L + taps + 1
    n_blk = 1 + -(-(span - L) // L)
    return n_blk * L <= 1.5 * span and n_blk <= 256


def check_window(start: int, size: int, limit: int, what: str) -> None:
    """Raise unless rows ``[start, start + size)`` lie inside ``[0, limit)``.
    ``jax.lax.dynamic_slice`` clamps an out-of-range start (shifting the
    window); torch slicing would silently truncate it.  The port checks
    the invariant instead."""
    if start < 0 or start + size > limit:
        raise IndexError(
            f"{what}: window [{start}, {start + size}) outside [0, {limit})"
        )


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
    from .fir_fleets import _sync_atlas

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


def require_periodic(config: FirConfig, path: str) -> None:
    """Raise unless ``path`` resolves to the ported periodic path."""
    path = resolve_convolve_path(config, path)
    if path in ("farrow", "lerp"):
        raise NotImplementedError(
            f"the {path!r} convolve path (coprime ratios) is not ported yet "
            "(ROADMAP A5)"
        )
    if path == "gather":
        raise NotImplementedError(
            "the 'gather' convolve path is not ported yet (ROADMAP A9)"
        )
    if path != "periodic":
        raise ValueError(f"unknown convolve path {path!r}")
    if config.wide:
        raise NotImplementedError(
            "the wide u32 schedule is not ported yet (ROADMAP A5)"
        )


def make_fir_step(
    config: FirConfig, coeffs: np.ndarray, *, path: str = "auto", device="cpu"
):
    """Build the chunk-step function for ``config`` (periodic path only).

    ``step(state, chunk [n, C] f32 tensor, n_valid, out_budget) ->
    (state', out [out_capacity, C] f32, consumed, produced)``, frames
    counted per channel, ``consumed``/``produced`` Python ints.  Same
    semantics as ``resampler_tpu.engine.fir.make_fir_step``: end-aligned
    copy-in, exact integer schedule, banded-atlas convolve, masked tail,
    consume."""
    require_periodic(config, path)
    device = resolve_device(device)
    coeffs = np.asarray(coeffs, np.float32)
    assert coeffs.shape == (config.phases, config.taps)
    C = config.channels
    L, M = config.ratio_num, config.ratio_den
    valid_end = config.input_capacity
    out_cap = config.out_capacity
    convolve = _convolve_periodic(config, coeffs, device)

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
        pos_num = state["pos_num"]

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

        # ---- schedule (reference hot loop: src/resampler_fir.rs:542-565) ----
        n_out = _compute_n_out(config, pos_num, avail, int(out_budget))

        # ---- convolution; a step that emits nothing skips it (its lanes
        # are all masked, and the JAX read there may be a clamped one) ----
        if n_out:
            out = convolve(buffer, valid_end - avail, pos_num)
            out[n_out:] = 0.0
        else:
            out = buffer.new_zeros((out_cap, C))

        # ---- consume (reference: src/resampler_fir.rs:592-615) ----
        pos_after = pos_num + n_out * L
        consumed = min(pos_after // M, avail)
        new_state = dict(
            buffer=buffer,
            available_frames=avail - consumed,
            pos_num=pos_after - consumed * M,
        )
        return new_state, out, to_copy, n_out

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
