"""Plain reference of the FFT overlap-add resampler, from its published
description (hasenbanck/resampler, src/resampler_fft.rs:338-424 and
src/window.rs).

Per channel and chunk ``x_t`` of ``N`` frames: zero-pad to ``2N``, take the
unnormalised real FFT, multiply the first ``n_keep`` bins by the spectrum of
a Kaiser-windowed sinc (``N`` points, periodic window, normalised by
``1/(2N)``), copy them into an ``M + 1``-bin spectrum, take the unnormalised
inverse real FFT at ``2M`` and overlap-add: ``out_t = full_t[:M] +
full_{t-1}[M:]``, with ``full_{-1} = 0``.  Everything runs in float64; the
filter is designed again from the configuration.
"""

from __future__ import annotations

import numpy as np
import torch

from .fir import kaiser_cutoff
from .precision import tf32_round


def filter_spectrum(n_in: int, n_out: int, beta: float) -> np.ndarray:
    """``[n_in + 1]`` complex128 bins of the overlap-add filter."""
    if n_in > n_out:
        cutoff = kaiser_cutoff(n_out, beta) * (n_out / n_in)
    else:
        cutoff = kaiser_cutoff(n_in, beta)
    cutoff = float(np.float32(cutoff))  # the crate designs at an f32 cutoff
    window = np.kaiser(n_in + 1, beta)[:-1]  # periodic: the DFT-even window
    x = (np.arange(n_in, dtype=np.float64) - n_in // 2) * cutoff
    proto = window * np.sinc(x)
    proto /= proto.sum()
    padded = np.zeros(2 * n_in)
    padded[:n_in] = proto / (2 * n_in)
    return np.fft.rfft(padded)


class FftReference:
    def __init__(self, config: dict, device):
        self.n_in, self.n_out = config["fft_size_input"], config["fft_size_output"]
        self.keep = self.n_in + 1 if self.n_in < self.n_out else self.n_out
        spec = filter_spectrum(self.n_in, self.n_out, config["kaiser_beta"])
        self.spec = torch.from_numpy(spec[: self.keep]).to(device)

    def full(self, x: torch.Tensor, control: bool = False) -> torch.Tensor:
        """``[R, 2M]`` float64 frame of each row of ``x [R, N]``."""
        x = x.to(torch.float64)
        spec = self.spec
        if control:
            # TF32 operands: the samples and the filter's coefficients
            x = tf32_round(x)
            spec = torch.complex(tf32_round(spec.real), tf32_round(spec.imag))
        bins = torch.fft.rfft(x, n=2 * self.n_in, dim=1)[:, : self.keep] * spec
        out = torch.zeros((x.shape[0], self.n_out + 1), dtype=torch.complex128, device=x.device)
        out[:, : self.keep] = bins
        return torch.fft.irfft(out, n=2 * self.n_out, dim=1) * (2 * self.n_out)

    def step(self, prev, cur, control: bool = False) -> torch.Tensor:
        """``[R, M]`` output of the chunk ``cur`` after ``prev`` (``None``
        for the stream's first chunk)."""
        out = self.full(cur, control)[:, : self.n_out]
        if prev is not None:
            out = out + self.full(prev, control)[:, self.n_out :]
        return out
