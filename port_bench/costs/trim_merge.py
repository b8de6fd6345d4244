"""B6: the segment means of the latents of the unpaired rows. The
probabilities and latents read once, the trimmed latents, lengths, slots
and counts written once."""

KERNELS = r"trim_merge_kernel|trim_merge_tokens_kernel|trim_merge_scan_kernel|trim_merge_means_kernel"


def cost(a):
    """(FLOPs, bytes) of one call from its arguments ``a``."""
    B, T, C = a["p_code"].shape
    D = a["latent"].shape[2]
    return 2 * B * T * (C + D), 4 * (B * T * C + 2 * B * T * D + B + 2 * B * T)
