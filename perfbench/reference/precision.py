"""The control's precision: TF32, the nearest below the configurations'
float32 with TF32 off."""

from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 explicit mantissa bits, round to nearest
    even) through float32, returned in ``x``'s dtype: the operand a TF32
    tensor core multiplies."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32).to(x.dtype)
