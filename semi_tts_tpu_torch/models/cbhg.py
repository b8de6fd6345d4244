"""CBHG mel->linear postnet: conv bank + highways + BiGRU (counterpart of
`semi_tts_tpu/models/cbhg.py`). The BiGRU runs through kernel K2, and
under autograd its backward through kernel K8. In train mode the
BatchNorms normalize with the batch's statistics and update their running
ones in place."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rnn import GRUParams, bigru
from .common import BatchNorm, Conv1d, Highway, Linear, batchnorm, conv1d, highway, linear


class BNConv(nn.Module):
    """Conv (no bias, torch default init), then BN(momentum 0.99, eps 1e-3)
    after the activation."""

    def __init__(self, in_ch, out_ch, k, generator=None):
        super().__init__()
        self.conv = Conv1d(in_ch, out_ch, k, bias=False, generator=generator)
        self.bn = BatchNorm(out_ch, eps=1e-3, momentum=0.99)


def _bn_conv_apply(p: BNConv, x, *, k, activation, train):
    y = conv1d(p.conv, x, padding=k // 2)
    if activation:
        y = F.relu(y)
    return batchnorm(p.bn, y, train=train)


class CBHG(nn.Module):
    def __init__(self, in_dim, K=16, hidden_sizes=(128, 128), generator=None):
        super().__init__()
        g = generator
        self.banks = nn.ModuleList(BNConv(in_dim, in_dim, k, g) for k in range(1, K + 1))
        sizes_in = [K * in_dim] + list(hidden_sizes[:-1])
        self.projs = nn.ModuleList(BNConv(ci, co, 3, g) for ci, co in zip(sizes_in, hidden_sizes))
        self.pre_highway = Linear(hidden_sizes[-1], in_dim, bias=False, init="torch", generator=g)
        self.highways = nn.ModuleList(Highway(in_dim, in_dim, g) for _ in range(4))
        self.gru = nn.ModuleDict({"fwd": GRUParams(in_dim, in_dim, g),
                                  "bwd": GRUParams(in_dim, in_dim, g)})


def cbhg_apply(p: CBHG, x, *, train=False):
    """x: (B, T, in_dim) -> (B, T, 2*in_dim)."""
    T = x.shape[1]
    outs = []
    for i, bank in enumerate(p.banks):
        y = _bn_conv_apply(bank, x, k=i + 1, activation=True, train=train)
        outs.append(y[:, :T])  # even kernels emit T+1 frames; truncate
    h = torch.cat(outs, dim=-1)
    # MaxPool1d(kernel=2, stride=1, padding=1) with -inf padding, truncated to T
    hp = F.pad(h, (0, 0, 1, 1), value=float("-inf"))
    h = torch.maximum(hp[:, :-1], hp[:, 1:])[:, :T]
    acts = [True] * (len(p.projs) - 1) + [False]
    for proj, act in zip(p.projs, acts):
        h = _bn_conv_apply(proj, h, k=3, activation=act, train=train)
    h = linear(p.pre_highway, h) + x
    for hw in p.highways:
        h = highway(hw, h)
    return bigru(p.gru, h)
