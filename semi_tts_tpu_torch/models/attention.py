"""Location-sensitive additive attention, one decode step (counterpart of
`semi_tts_tpu/models/attention.py`). After the query projection the step
runs through kernel K3."""

from __future__ import annotations

from torch import nn

from ..kernels import attention as k3
from .common import Conv1d, Linear, linear


class Attention(nn.Module):
    def __init__(self, query_dim, memory_dim, hidden_dim, n_location_filters,
                 location_kernel_size, *, loc_aware=True, use_summed_weights=True,
                 generator=None):
        super().__init__()
        g = generator
        self.query_layer = Linear(query_dim, hidden_dim, bias=False, w_init_gain="tanh", generator=g)
        self.memory_layer = Linear(memory_dim, hidden_dim, bias=False, w_init_gain="tanh", generator=g)
        self.v = Linear(hidden_dim, 1, bias=False, generator=g)
        if loc_aware:
            in_ch = 2 if use_summed_weights else 1
            self.loc_conv = Conv1d(in_ch, n_location_filters, location_kernel_size, bias=False,
                                   w_init_gain="linear", generator=g)
            self.loc_linear = Linear(n_location_filters, hidden_dim, bias=False,
                                     w_init_gain="tanh", generator=g)


def process_memory(p: Attention, memory):
    """Hoisted once per utterance."""
    return linear(p.memory_layer, memory)


def attention_step(p: Attention, query, memory, processed_memory, attn_history, mask=None):
    """query (B, Q); memory (B, L, D); processed_memory (B, L, A);
    attn_history (B, C, L); mask (B, L) bool, True = padded.
    Returns (context (B, D), weights (B, L))."""
    pq = linear(p.query_layer, query)
    loc = hasattr(p, "loc_conv")
    return k3.attention_step(pq, processed_memory, memory, attn_history,
                             p.loc_conv.w if loc else None, p.loc_linear.w if loc else None,
                             p.v.w.reshape(-1), mask)
