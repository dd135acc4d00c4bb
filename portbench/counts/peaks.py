"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
at the full 700 W power limit): FP32 outside the tensor cores and HBM3
bandwidth. The planner's products are FP32 (TF32 stays off), so its
roofline is against the FP32 rate. A card set below 700 W runs below these
rates; the run prints the card's ``power.limit`` beside every share."""

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the FP32 peak and the bytes at the memory peak."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
