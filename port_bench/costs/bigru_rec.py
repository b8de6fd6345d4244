"""K2: the GRU recurrence (b_hn inside r) of one or two directions (T, B, 3H)
-> hs (T, B, nH). FLOPs: the recurrent product, 2 * 3H * H a row a step a
direction; bytes: W_hh, b_hh, x_proj and hs once each."""

KERNELS = r"gru_rec_kernel|rec_wide_kernel<3>|gru_wide_fwd_cluster_kernel"


def cost(a):
    """(FLOPs, bytes) of one call from its arguments ``a``."""
    T, B, H3 = a["x_proj_f"].shape
    H = H3 // 3
    n = 1 if a["w_hh_b"] is None else 2
    return n * T * B * 2 * H3 * H, 4 * (n * H3 * (H + 1) + n * T * B * H3 + T * B * n * H)
