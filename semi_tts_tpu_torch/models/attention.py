"""Location-sensitive additive attention, one decode step (counterpart of
`semi_tts_tpu/models/attention.py`). After the query projection the step
runs through kernel K3; when autograd records, through `_AttentionStep`,
whose backward is kernel K9."""

from __future__ import annotations

import torch
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


class _AttentionStep(torch.autograd.Function):
    """K3 forward, K9 backward. Saves its inputs (views, never copies: the
    decoder's 81 steps share one memory and processed memory) and its
    outputs, the weights and the context (K9 needs sum_l w dw, which the
    context gives without the row's other positions)."""

    @staticmethod
    def forward(ctx, pq, processed_memory, memory, attn_hist, loc_w, loc_lin, v, mask):
        context, weights = k3.attention_step(pq, processed_memory, memory, attn_hist, loc_w,
                                             loc_lin, v, mask)
        ctx.save_for_backward(pq, processed_memory, memory, attn_hist, loc_w, loc_lin, v, weights,
                              context)
        return context, weights

    @staticmethod
    def backward(ctx, d_context, d_weights):
        grads = k3.attention_step_bwd(*ctx.saved_tensors, d_context.contiguous(),
                                      d_weights.contiguous())
        return grads + (None,)


def attention_step(p: Attention, query, memory, processed_memory, attn_history, mask=None):
    """query (B, Q); memory (B, L, D); processed_memory (B, L, A);
    attn_history (B, C, L); mask (B, L) bool, True = padded.
    Returns (context (B, D), weights (B, L))."""
    pq = linear(p.query_layer, query)
    loc = hasattr(p, "loc_conv")
    args = (pq, processed_memory, memory, attn_history,
            p.loc_conv.w if loc else None, p.loc_linear.w if loc else None, p.v.w.reshape(-1))
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in args):
        return _AttentionStep.apply(*args, mask)
    return k3.attention_step(*args, mask)
