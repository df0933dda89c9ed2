"""Kaiser-window filter design, computed in float64 NumPy.

A verbatim copy of ``resampler_tpu/dsp/window.py`` (NumPy only), kept in
the port so that ``resampler_tpu_torch`` imports nothing of the JAX
package; tests/test_torch_design.py pins the designed tables equal.
Counterpart of the reference's filter-design layer
(reference: src/window.rs:17-131).  All design math runs once at
construction time on the host in float64 (the reference designs windows in
f64 and casts to f32; we additionally keep the sinc product and
normalization in f64 before the final f32 cast, which only improves
accuracy).  The resulting coefficient tables are cast to float32 and
shipped to the device.
"""

from __future__ import annotations

import enum

import numpy as np

__all__ = [
    "WindowType",
    "bessel_i0",
    "make_kaiser_window",
    "calculate_cutoff_kaiser",
    "make_sincs_for_kaiser",
]


class WindowType(enum.Enum):
    """Kaiser window sampling grid (reference: src/window.rs:4-15)."""

    #: DFT-even window over N points; used by the FFT overlap-add path.
    PERIODIC = "periodic"
    #: Truly symmetric window; used for FIR polyphase design.
    SYMMETRIC = "symmetric"


def bessel_i0(x: np.ndarray | float) -> np.ndarray:
    """Modified Bessel function of the first kind, order zero, via the
    power-series expansion (reference: src/window.rs:96-112).

    Vectorized over ``x``; converges to f64 round-off for the β values in
    use (≤ 13) within ~40 terms; we run a fixed 60 terms which is both
    exact at f64 precision for this domain and branch-free.
    """
    x = np.asarray(x, dtype=np.float64)
    base = x * x / 4.0
    term = np.ones_like(base)
    result = np.ones_like(base)
    for idx in range(1, 60):
        term = term * base / float(idx * idx)
        result = result + term
    return result


def make_kaiser_window(
    sample_count: int, beta: float, window_type: WindowType
) -> np.ndarray:
    """Kaiser window of ``sample_count`` points (f64).

    Matches ``scipy.signal.windows.kaiser(N, beta, sym=...)``:
    ``PERIODIC`` ≙ ``sym=False``, ``SYMMETRIC`` ≙ ``sym=True``
    (reference: src/window.rs:57-94).
    """
    idx = np.arange(sample_count, dtype=np.float64)
    if window_type is WindowType.PERIODIC:
        normalized = idx / (sample_count / 2.0) - 1.0
    else:
        normalized = 2.0 * idx / (sample_count - 1) - 1.0
    arg = beta * np.sqrt(np.maximum(0.0, 1.0 - normalized**2))
    return bessel_i0(arg) / bessel_i0(beta)


def calculate_cutoff_kaiser(sample_count: int, beta: float) -> float:
    """Normalized cutoff (fraction of Nyquist) for a Kaiser windowed-sinc of
    ``sample_count`` taps, from Kaiser transition-width theory with a 0.5%
    safety margin, clamped to [0.7, 1.0]
    (reference: src/window.rs:114-131).
    """
    n = float(sample_count)
    a_db = beta / 0.1102 + 8.7
    delta_f_nyquist = (a_db - 7.95) / (14.36 * n)
    safety_margin = 1.005
    cutoff = 1.0 - delta_f_nyquist * safety_margin
    return float(np.clip(cutoff, 0.7, 1.0))


def make_sincs_for_kaiser(
    sample_count: int,
    factor: int,
    f_cutoff: float,
    beta: float,
    window_type: WindowType,
) -> np.ndarray:
    """Polyphase windowed-sinc prototype.

    Designs a ``sample_count * factor``-point Kaiser windowed sinc at
    normalized cutoff ``f_cutoff`` and splits it into ``factor`` polyphase
    branches with the reference's reversed branch ordering and sum
    normalization (each branch sums to ≈ 1)
    (reference: src/window.rs:17-55).

    Returns an ``[factor, sample_count]`` float32 array where row ``b`` is
    polyphase branch ``b``.
    """
    totpoints = sample_count * factor
    window = make_kaiser_window(totpoints, beta, window_type)
    x = (np.arange(totpoints, dtype=np.float64) - totpoints // 2) * (
        float(f_cutoff) / factor
    )
    y = window * np.sinc(x)  # np.sinc(x) = sin(pi x)/(pi x), sinc(0)=1
    total = y.sum() / factor

    # y laid out as [p0_b0, p0_b1, ..., p0_b{F-1}, p1_b0, ...]; branch n of
    # the prototype lands in output row (factor-1-n).
    sincs = y.reshape(sample_count, factor).T[::-1] / total
    return np.ascontiguousarray(sincs, dtype=np.float32)
