"""K3: one location-sensitive attention step after the query projection.
FLOPs: the location convolution and its linear layer, the product of the
energies with v and the context, 2 * B * L * (A + D + F*C*K + F*A); bytes:
every input and output once."""

KERNELS = r"attention_step_kernel|attention_split_kernel|attention_combine_kernel"


def cost(a):
    """(FLOPs, bytes) of one call from its arguments ``a``."""
    B, L, A = a["processed_memory"].shape
    D = a["memory"].shape[2]
    F_, C, K = a["loc_w"].shape if a["loc_w"] is not None else (0, 0, 0)
    flops = 2 * B * L * (A + D + F_ * C * K + F_ * A)
    nbytes = 4 * (B * A + B * L * A + B * L * D + B * C * L + F_ * C * K + A * F_ + A + B * D + B * L)
    return flops, nbytes + (B * L if a.get("mask") is not None else 0)
