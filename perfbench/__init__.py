"""The benchmark of ``resampler_tpu_torch`` on one NVIDIA H100
(``run.py``; see ``core.py``)."""
