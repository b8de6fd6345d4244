"""K9: the backward of one attention step. FLOPs: the products of the
gradients of the context, the energies, the location linear layer and the
location convolution, 2 * B * L * (2D + A + 2*F*A + 2*F*C*K); bytes: every
input (the inputs of the forward, its weights and context, the two
incoming gradients) and every gradient once."""

KERNELS = r"attention_bwd_kernel|attention_bwd_sum_kernel|attention_split_bwd"


def cost(a):
    """(FLOPs, bytes) of one call from its arguments ``a``."""
    B, L, A = a["processed_memory"].shape
    D = a["memory"].shape[2]
    F_, C, K = a["loc_w"].shape if a["loc_w"] is not None else (0, 0, 0)
    flops = 2 * B * L * (2 * D + A + 2 * F_ * A + 2 * F_ * C * K)
    ins = B * A + B * L * A + B * L * D + B * C * L + F_ * C * K + A * F_ + A + B * L + 2 * B * D + B * L
    outs = B * A + B * L * A + B * L * D + B * C * L + F_ * C * K + A * F_ + A
    return flops, 4 * (ins + outs)
