"""K1: the LSTM recurrence of one or two directions (T, B, 4H) -> hs (T, B,
nH). FLOPs: the recurrent product, 2 * 4H * H a row a step a direction;
bytes: W_hh, x_proj and hs once each."""

KERNELS = r"lstm_rec_kernel<[^>]*false>|rec_wide_kernel<4>|lstm_wide_fwd_cluster_kernel"


def cost(a):
    """(FLOPs, bytes) of one call from its arguments ``a``."""
    T, B, H4 = a["x_proj_f"].shape
    H = H4 // 4
    n = 1 if a["w_hh_b"] is None else 2
    return n * T * B * 2 * H4 * H, 4 * (n * H4 * H + n * T * B * H4 + T * B * n * H)
