"""K8: the GRU backward recurrence: z, the hidden-side gate coefficients and
the gradient of hs -> the gradient of the output of every step. FLOPs: 2 *
3H * H a row a step a direction; bytes: W_hh, z, the coefficients, g_hs
and the output once each."""

KERNELS = r"gru_bwd_kernel|gru_wide_bwd_kernel|gru_wide_bwd_cluster_kernel"


def cost(a):
    """(FLOPs, bytes) of one call from its arguments ``a``."""
    T, B, H = a["z_f"].shape
    n = 1 if a["w_hh_b"] is None else 2
    return n * T * B * 2 * 3 * H * H, 4 * (n * 3 * H * H + n * T * B * 5 * H + T * B * n * H)
