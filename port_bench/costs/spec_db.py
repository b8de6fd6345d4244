"""K5 spectrum: [re | im] (or magnitudes) read once, the magnitude and the
normalized dB written once."""

KERNELS = r"spec_db_kernel"


def cost(a):
    """(FLOPs, bytes) of one call from its arguments ``a``."""
    x = a["x"]
    F_ = x.shape[-1] // 2 if a["reim"] else x.shape[-1]
    rows = x.numel() // x.shape[-1]
    outs = (rows * F_ if a["reim"] else 0) + (rows * F_ if a.get("db", True) else 0)
    return 8 * rows * F_, 4 * (x.numel() + outs)
