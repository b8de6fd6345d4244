"""Recurrent primitives with torch gate math (counterpart of
`semi_tts_tpu/ops/rnn.py`): LSTM gates i, f, g, o; GRU gates r, z, n with
b_hn inside r. The input projection of a whole sequence is one GEMM outside
the recurrence; the recurrence itself runs in the K1/K2 kernels, both
directions of a bidirectional layer in one launch.

Parameters are `LSTMParams`/`GRUParams` modules named as the JAX pytree
leaves (``w_ih``, ``w_hh``, ``b_ih``, ``b_hh``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.rnn import bigru_rec, bilstm_rec, gru_rec, lstm_rec
from .init import uniform

__all__ = ["GRUParams", "LSTMParams", "bigru", "bigru_rec", "bilstm_rec", "gru_rec",
           "lstm_cell", "lstm_rec", "multi_lstm", "multi_lstm_init"]


class _RNNParams(nn.Module):
    """torch-style U(-1/sqrt(H), 1/sqrt(H)) init for one direction/layer."""

    gates = 0

    def __init__(self, input_dim: int, hidden_dim: int, generator=None):
        super().__init__()
        s = 1.0 / math.sqrt(hidden_dim)
        G = self.gates * hidden_dim
        self.w_ih = nn.Parameter(uniform((G, input_dim), s, generator))
        self.w_hh = nn.Parameter(uniform((G, hidden_dim), s, generator))
        self.b_ih = nn.Parameter(uniform((G,), s, generator))
        self.b_hh = nn.Parameter(uniform((G,), s, generator))


class LSTMParams(_RNNParams):
    gates = 4


class GRUParams(_RNNParams):
    gates = 3


def lstm_cell(p: LSTMParams, x, h, c):
    """One LSTMCell step. x: (B, D); h, c: (B, H). Returns (h', c')."""
    gates = x @ p.w_ih.T + p.b_ih + h @ p.w_hh.T + p.b_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return h2, c2


def _lstm_proj(p: LSTMParams, xs):
    """xs (B, T, D) -> x_proj (T, B, 4H); b_ih + b_hh are folded in."""
    return (xs @ p.w_ih.T + (p.b_ih + p.b_hh)).transpose(0, 1).contiguous()


def multi_lstm_init(input_dim: int, hidden_dim: int, num_layers: int,
                    bidirectional: bool, generator=None) -> nn.ModuleList:
    """Stacked (bi)LSTM parameters: a list of {"fwd"[, "bwd"]} layers."""
    layers = nn.ModuleList()
    d = input_dim
    for _ in range(num_layers):
        layer = nn.ModuleDict({"fwd": LSTMParams(d, hidden_dim, generator)})
        if bidirectional:
            layer["bwd"] = LSTMParams(d, hidden_dim, generator)
        layers.append(layer)
        d = hidden_dim * (2 if bidirectional else 1)
    return layers


def multi_lstm(layers: nn.ModuleList, xs):
    """Stacked (bi)LSTM matching ``nn.LSTM(batch_first=True)`` at inference
    (no inter-layer dropout)."""
    h = xs
    for layer in layers:
        f = layer["fwd"]
        if "bwd" in layer:
            b = layer["bwd"]
            hs = bilstm_rec(f.w_hh, b.w_hh, _lstm_proj(f, h), _lstm_proj(b, h))
        else:
            hs = lstm_rec(False, f.w_hh, _lstm_proj(f, h))
        h = hs.transpose(0, 1)
    return h


def _gru_proj(p: GRUParams, xs):
    """xs (B, T, D) -> x_proj (T, B, 3H); b_hh stays inside the recurrence
    (the b_hn-inside-r quirk)."""
    return (xs @ p.w_ih.T + p.b_ih).transpose(0, 1).contiguous()


def bigru(p: nn.ModuleDict, xs):
    f, b = p["fwd"], p["bwd"]
    hs = bigru_rec(f.w_hh, b.w_hh, f.b_hh, b.b_hh, _gru_proj(f, xs), _gru_proj(b, xs))
    return hs.transpose(0, 1)
