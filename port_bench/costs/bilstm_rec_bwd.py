"""K7: the LSTM backward recurrence: gate pre-activations, cell states and
the gradient of hs -> gate gradients. FLOPs: the recurrent product dgates
@ W_hh, 2 * 4H * H a row a step a direction; bytes: W_hh, gates, cs, g_hs
and the gate gradients once each."""

KERNELS = r"lstm_bwd_kernel|lstm_wide_bwd_kernel|lstm_wide_bwd_cluster_kernel"


def cost(a):
    """(FLOPs, bytes) of one call from its arguments ``a``."""
    T, B, H4 = a["gates_f"].shape
    H = H4 // 4
    n = 1 if a["w_hh_b"] is None else 2
    return n * T * B * 2 * H4 * H, 4 * (n * H4 * H + 2 * n * T * B * H4 + 2 * T * B * n * H)
