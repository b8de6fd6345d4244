"""K5 framing: the waves (and the noise on the augmented path) read once, the
windowed frames (B, T, span) written once; a few operations a sample."""

KERNELS = r"stft_frames_kernel"


def cost(a):
    """(FLOPs, bytes) of one call from its arguments ``a``."""
    B, S = a["waves"].shape
    T, span = a["num_frames"], a["support"][1]
    noise = 0 if a.get("noise") is None else B * S
    return 4 * B * T * span, 4 * (B * S + noise + B * T * span)
