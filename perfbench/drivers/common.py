"""What the drivers share: the program's import and the seeded inputs."""

from __future__ import annotations

import torch


def program():
    """The system under test, ``resampler_tpu_torch`` (from the checkout's
    root, which ``run.py`` puts on the path)."""
    import resampler_tpu_torch

    return resampler_tpu_torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from the run's seed (any whole
    number: it is folded into 64 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def device_noise(seed: int, shape, device) -> torch.Tensor:
    """Uniform white noise in [-1, 1), f32, made on ``device`` in one call."""
    x = torch.rand(shape, generator=generator(seed, device), device=device, dtype=torch.float32)
    return x.mul_(2.0).sub_(1.0)


def absmax(t: torch.Tensor) -> float:
    """``max |t|``, 0 for an empty tensor."""
    return float(t.abs().max()) if t.numel() else 0.0
