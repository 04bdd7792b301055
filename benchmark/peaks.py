"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit). A roofline share is stated against these, with the
card's power limit printed beside it."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for the work: the longer of its
    operations at the f32 peak and its bytes at the HBM peak."""
    return max(flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
