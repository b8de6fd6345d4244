"""K4 projection: [re | im] and the magnitudes read once, the projected [re |
im] written once."""

KERNELS = r"gl_project_kernel"


def cost(a):
    """(FLOPs, bytes) of one call from its arguments ``a``."""
    mag = a["mag"]
    return 8 * mag.numel(), 4 * 5 * mag.numel()
