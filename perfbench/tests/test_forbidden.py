"""The check that no run loads JAX or the JAX package compares whole
top-level names."""

from perfbench import core


def test_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "resampler_tpu",
             "resampler_tpu.engine.fir", "resampler_tpu_torch", "resampler_tpu_torch.engine",
             "jaxtyping", "flaxen", "numpy", "torch"]
    assert core.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "resampler_tpu",
         "resampler_tpu.engine.fir"])


def test_harness_and_reference_load_neither():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import perfbench.core, perfbench.trace, "
            "perfbench.reference.fir, perfbench.reference.fft, perfbench.drivers.common; "
            "from perfbench import core; import glob; "
            "[core.load_module(core.HERE / p) for p in ('drivers/fir_lockstep.py', "
            "'drivers/fft_chunks.py', 'drivers/fir_streaming.py')]; "
            "print(core.forbidden_modules())" % str(core.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in (core.HERE / "reference").glob("*.py"):
        text = path.read_text()
        assert "resampler_tpu" not in text, path
        assert "import jax" not in text, path
