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
    """The two numpy-only modules the port copied really are JAX-free."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import resampler_tpu.types, resampler_tpu.dsp.window\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
