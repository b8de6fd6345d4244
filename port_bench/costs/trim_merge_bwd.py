"""B6 backward: the gradient of the trimmed latents gathered back to the
frames over their counts."""

KERNELS = r"trim_merge_bwd_kernel"


def cost(a):
    """(FLOPs, bytes) of one call from its arguments ``a``."""
    B, T, D = a["d_out"].shape
    return B * T * D, 4 * (2 * B * T * D + 2 * B * T)
