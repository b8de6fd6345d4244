"""K6 forward: the CTC alphas of (B, T, C) log-probabilities over S = 2U + 1
states. Bound by memory: the log-probabilities, targets and lengths read
once, every alpha and the NLL written once; a handful of operations a
state a step."""

KERNELS = r"ctc_alpha_kernel|ctc_alpha_cluster_kernel|ctc_alpha_chain_kernel"


def cost(a):
    """(FLOPs, bytes) of one call from its arguments ``a``."""
    B, T, C = a["log_probs"].shape
    S = 2 * a["targets"].shape[1] + 1
    return 6 * T * B * S, 4 * (B * T * C + B * (S // 2) + 2 * B + T * B * S + B)
