"""The wide schedule's per-step arithmetic for one shared position
(``WideSchedule.emitted``'s closed form, ``advance`` on Python ints)
against its lane-by-lane form (``emitted_mask``, the array ``advance``),
word for word: both sides of a ``pos_lo`` wrap, the frame clamp, the u32
corners where the closed form hands over to the mask."""

from __future__ import annotations

import numpy as np
import pytest

from resampler_tpu_torch.engine.fir import FirConfig, WideSchedule, _U32

# (L, M, taps, input_capacity), reduced: the millihertz bridge (48,000,000
# -> 48,000,066 mHz), a small wide pair, the saturation corner
# (L // M > 2^32 - 8195) and a short ring
PAIRS = [
    (8_000_000, 8_000_011, 128, 4096),
    (600_011, 600_013, 128, 4096),
    ((1 << 32) - 5, 3, 128, 4096),
    (600_011, 600_013, 16, 256),
]


def _schedule(pair) -> WideSchedule:
    L, M, taps, cap = pair
    cfg = FirConfig(channels=1, taps=taps, ratio_num=L, ratio_den=M, input_capacity=cap)
    assert cfg.wide
    return WideSchedule(cfg)


def _words(ws: WideSchedule, rng, n: int):
    """``(pos_hi, pos_lo, avail)`` triples: random ones, and the corners
    of each word and of the frame clamp."""
    M, T, cap = ws.M, ws.taps, ws.clamp
    top = _U32 - cap - 1 - T
    his = [0, 1, 7, top - 1, top, top + 1, _U32 - T, _U32]
    los = [0, 1, M // 2, M - 2, M - 1]
    out = []
    for hi in his:
        for lo in los:
            for a in (-2, -1, 0, 1, cap - 2, cap - 1, cap, cap + 1, cap + 2, cap + 5):
                out.append((hi, lo, hi + T + a))
    for _ in range(n):
        hi = int(rng.integers(0, 1 << 20)) if rng.random() < 0.8 else int(rng.integers(0, _U32 + 1))
        out.append((hi, int(rng.integers(0, M)), hi + T + int(rng.integers(-4, cap + 8))))
    return out


@pytest.mark.parametrize("pair", PAIRS, ids=["bridge", "small", "saturating", "short-ring"])
def test_closed_form_count_equals_the_mask(pair):
    ws = _schedule(pair)
    rng = np.random.default_rng(sum(pair))
    for hi, lo, avail in _words(ws, rng, 2000):
        assert ws.emitted(hi, lo, avail) == ws.emitted_mask(hi, lo, avail), (hi, lo, avail)


@pytest.mark.parametrize("pair", PAIRS, ids=["bridge", "small", "saturating", "short-ring"])
def test_scalar_advance_equals_the_array_stride(pair):
    ws = _schedule(pair)
    rng = np.random.default_rng(sum(pair) + 1)
    for hi, lo, avail in _words(ws, rng, 500):
        avail = max(avail, 0)
        for n_out in {0, 1, ws.N // 2, ws.N - 1, ws.N}:
            got = ws.advance(hi, lo, n_out, avail)
            c, h, low = ws.advance(np.array([hi], np.int64), np.array([lo], np.int64), n_out, avail)
            assert got == (int(c), int(h[0]), int(low[0])), (hi, lo, n_out, avail)
            assert all(type(v) is int for v in got)
