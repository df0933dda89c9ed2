"""The host's cost of issuing one FFT fleet step, in us: host clock around
``BatchedResamplerFft.resample`` (no synchronise inside), summed over the
window's calls, per call."""


def read(rec):
    mean = rec.layers.mean("fft_resample")
    return None if mean is None else mean * 1e6
