"""K4 overlap-add and framing: the frames read once, the signal or the frames
of the next round written once."""

KERNELS = r"gl_ola_frame_kernel"


def cost(a):
    """(FLOPs, bytes) of one call from its arguments ``a``."""
    B, T, span = a["frames"].shape
    out = B * a["hop"] * (T - 1) if a["emit_signal"] else B * T * span
    return 2 * B * T * span, 4 * (B * T * span + out)
