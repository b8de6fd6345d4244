"""K1 with cell states (training): as bilstm_rec, and the cell states written
too."""

KERNELS = r"lstm_rec_kernel<[^>]*true>"


def cost(a):
    """(FLOPs, bytes) of one call from its arguments ``a``."""
    T, B, H4 = a["x_proj_f"].shape
    H = H4 // 4
    n = 1 if a["w_hh_b"] is None else 2
    return n * T * B * 2 * H4 * H, 4 * (n * H4 * H + n * T * B * H4 + 2 * T * B * n * H)
