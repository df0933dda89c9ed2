"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at the
700 W power limit), frozen for the benchmark."""

F32_TFLOPS = 67.0
BF16_TFLOPS = 989.0
HBM_TBPS = 3.35


def bound_s(flop: float, nbytes: float, tflops: float) -> float:
    """The least time the card could take: the larger of the operations
    at the peak of their type and the compulsory bytes at the HBM rate."""
    return max(flop / (tflops * 1e12), nbytes / (HBM_TBPS * 1e12))
