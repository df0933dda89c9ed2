"""``resampler_tpu_torch`` imports and runs with JAX, and the JAX package
itself, blocked from import."""

import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_BLOCKED_STEP = textwrap.dedent(
    """
    import sys
    for name in ("jax", "jaxlib", "resampler_tpu"):
        sys.modules[name] = None  # any import of them now raises
    import numpy as np
    import resampler_tpu_torch as rt

    x = np.random.default_rng(0).standard_normal(2 * 600).astype(np.float32)
    r = rt.ResamplerFir(
        2, 44100, 48000, rt.Latency.Sample32, rt.Attenuation.Db90, device="cpu"
    )
    out = np.zeros(r.buffer_size_output(), np.float32)
    consumed, produced = r.resample(x, out)
    n_out = -(-(600 - 64 + 1) * 160 // 147)  # exact schedule: 585 frames
    assert (consumed, produced) == (1200, 2 * n_out), (consumed, produced)
    f = rt.BatchedResamplerFir(
        2, 2, 44100, 48000, rt.Latency.Sample32, rt.Attenuation.Db90,
        synchronized=True, max_chunk=600, device="cpu",
    )
    o, c, p, peak = f.resample(x.reshape(1, 600, 2).repeat(2, axis=0))
    assert (int(c[0]), int(p[0])) == (600, n_out) and float(peak) > 0
    for in_hz, out_hz in ((44100, 44101), (600011, 600013)):  # farrow, wide u32
        c = rt.ResamplerFir(2, in_hz, out_hz, rt.Latency.Sample32, device="cpu")
        consumed, produced = c.resample(x, out)
        assert consumed == 1200 and produced > 0, (in_hz, consumed, produced)
    # the FFT engine: per stream and as a fleet, the magsplit plain version
    r = rt.ResamplerFft(2, 22050, 48000, backend="magsplit", device="cpu")
    y = r.process(np.random.default_rng(1).standard_normal(3000).astype(np.float32))
    assert y.size == -(-3000 * 1280 // 588) and np.isfinite(y).all()
    f = rt.BatchedResamplerFft(2, 2, 22050, 48000, backend="magsplit", device="cpu")
    o = f.resample_many(np.ones((3, 2, 2, 588), np.float32))
    assert tuple(o.shape) == (3, 2, 2, 1280)
    # the async fleet (B6's plain version), the serving runtime and its pool
    import resampler_tpu_torch.ops.fir_async_kernel, resampler_tpu_torch.runtime
    import resampler_tpu_torch.utils.native
    for in_hz, out_hz in ((44100, 44101), (600011, 600013)):
        f = rt.BatchedResamplerFir(
            2, 2, in_hz, out_hz, rt.Latency.Sample32, synchronized=True,
            sync_variant="async_tm", max_chunk=600, initial_positions=[0, 777],
            device="cpu",
        )
        o, c, p, peak = f.resample(x.reshape(1, 600, 2).repeat(2, axis=0))
        assert int(c[0]) == 600 and int(p[0]) > 0 and float(peak) > 0
    s = rt.StreamingFleet(2, 2, 44100, 44101, chunk_frames=256, synchronized="async",
                          initial_positions=[0, 777], device="cpu")
    s.push(0, x)
    s.push(1, x)
    assert all(y.size > 0 and np.isfinite(y).all() for y in s.step())
    # the vmapped fleet (B9's plain version, and torch ops on a coprime
    # pair), the slide fleet (B8's plain version), the default runtime
    import resampler_tpu_torch.ops.fir_kernel, resampler_tpu_torch.ops.fir_sync_kernel
    for in_hz, out_hz in ((44100, 48000), (44100, 44101)):
        f = rt.BatchedResamplerFir(2, 2, in_hz, out_hz, rt.Latency.Sample32, device="cpu")
        o, c, p, peak = f.resample(x.reshape(1, 600, 2).repeat(2, axis=0), [600, 300])
        assert c.tolist() == [600, 300] and p[0] > p[1] > 0 and float(peak) > 0
    f = rt.BatchedResamplerFir(2, 2, 44100, 48000, rt.Latency.Sample32, synchronized=True,
                               sync_variant="slide", device="cpu")
    o, c, p, peak = f.resample(x.reshape(1, 600, 2).repeat(2, axis=0))
    assert (int(c[0]), int(p[0])) == (600, n_out)
    s = rt.StreamingFleet(2, 2, 44100, 48000, chunk_frames=256, device="cpu")
    s.push(1, x)
    y0, y1 = s.step()
    assert y0.size == 0 and y1.size > 0 and np.isfinite(y1).all()
    import torch
    for make in (
        lambda: rt.ResamplerFft(2, 44100, 48000),
        lambda: rt.BatchedResamplerFft(2, 2, 44100, 48000),
        lambda: rt.ResamplerFir(2, 44100, 48000),
        lambda: rt.BatchedResamplerFir(2, 2, 44100, 44101, synchronized=True,
                                       sync_variant="async_tm"),
        lambda: rt.StreamingFleet(2, 2, 44100, 44101, synchronized="async"),
        lambda: rt.BatchedResamplerFir(2, 2, 44100, 48000),
        lambda: rt.StreamingFleet(2, 2, 44100, 48000),
    ):
        if torch.cuda.is_available():
            break
        try:
            make()  # device="cuda" is the default, and there is no card here
        except RuntimeError as e:
            assert "cuda" in str(e).lower(), e
        else:
            raise AssertionError("device='cuda' without a GPU did not raise")
    assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules
                   if sys.modules[m] is not None)
    print("ok")
    """
)


def _run(code):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )


def test_port_runs_with_jax_blocked():
    proc = _run(_BLOCKED_STEP)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_jax_package_numpy_modules_import_no_jax():
    """The numpy-only modules the port copied really are JAX-free."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import resampler_tpu.types, resampler_tpu.dsp.window, resampler_tpu.dsp.planner\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
