"""K6 backward: the betas and the gradient of the log-probabilities. Bound by
memory: the log-probabilities, alphas, targets, lengths, NLL and incoming
gradient read once, the gradient written once."""

KERNELS = r"ctc_beta_grad_kernel|ctc_beta_grad_cluster_kernel|ctc_beta_grad_chain_kernel"


def cost(a):
    """(FLOPs, bytes) of one call from its arguments ``a``."""
    B, T, C = a["log_probs"].shape
    S = 2 * a["targets"].shape[1] + 1
    return 10 * T * B * S, 4 * (2 * B * T * C + T * B * S + B * (S // 2) + 4 * B)
