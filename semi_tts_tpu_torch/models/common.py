"""Shared building blocks (counterpart of `semi_tts_tpu/models/common.py`).

Modules hold parameters named as the JAX pytree leaves (``w``, ``b``,
``scale``, ...) so `bridge` maps one tree onto the other by path; the
functions take the module where JAX takes its params dict. Layout is the
JAX one: activations (B, T, C), linear weights (out, in), conv weights
(out, in, k). BatchNorm running statistics are buffers, kept apart from the
parameters.

`MLP`/`mlp`, the conv-stack `Postnet`/`postnet_apply` and
`sinusoid_encoding_table` are the JAX package's blocks that no live model
uses (defined but unused upstream, kept for parity).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import dropout
from ..ops.init import uniform
from ..parallel.mesh import batch_group, sync_moments

GAINS = {"linear": 1.0, "relu": math.sqrt(2.0), "tanh": 5.0 / 3.0, "sigmoid": 1.0}


# ---------------- Linear ----------------

class Linear(nn.Module):
    """``init="xavier"``: xavier-uniform with torch gain semantics and torch's
    default bias init; ``init="torch"``: torch nn.Linear default
    (U(+-1/sqrt(fan_in)) for weight and bias)."""

    def __init__(self, in_dim, out_dim, *, bias=True, w_init_gain="linear",
                 init="xavier", generator=None):
        super().__init__()
        if init == "xavier":
            a = GAINS[w_init_gain] * math.sqrt(6.0 / (in_dim + out_dim))
        else:
            a = 1.0 / math.sqrt(in_dim)
        self.w = nn.Parameter(uniform((out_dim, in_dim), a, generator))
        if bias:
            self.b = nn.Parameter(uniform((out_dim,), 1.0 / math.sqrt(in_dim), generator))
        else:
            self.b = None


def linear(p: Linear, x):
    y = x @ p.w.T
    if p.b is not None:
        y = y + p.b
    return y


# ---------------- Conv1d (layout (B, T, C)) ----------------

class Conv1d(nn.Module):
    """Weight (out, in, k). ``w_init_gain=None`` -> torch conv default init."""

    def __init__(self, in_ch, out_ch, kernel_size, *, bias=True, w_init_gain=None,
                 generator=None):
        super().__init__()
        fan_in = in_ch * kernel_size
        if w_init_gain is None:
            a = 1.0 / math.sqrt(fan_in)
        else:
            a = GAINS[w_init_gain] * math.sqrt(6.0 / (fan_in + out_ch * kernel_size))
        self.w = nn.Parameter(uniform((out_ch, in_ch, kernel_size), a, generator))
        self.b = nn.Parameter(uniform((out_ch,), 1.0 / math.sqrt(fan_in), generator)) if bias else None


def conv1d(p: Conv1d, x, *, stride=1, padding=None, dilation=1):
    """x: (B, T, Cin) -> (B, T', Cout); torch-style symmetric int padding,
    default ``dilation * (k - 1) // 2``."""
    k = p.w.shape[2]
    if padding is None:
        padding = (dilation * (k - 1)) // 2
    y = F.conv1d(x.transpose(1, 2), p.w, p.b, stride=stride, padding=padding, dilation=dilation)
    return y.transpose(1, 2)


# ---------------- BatchNorm (stats over B and T of (B, T, C)) ----------------

class BatchNorm(nn.Module):
    """Parameters ``scale``/``bias``; running ``mean``/``var`` and the
    ``eps``/``momentum`` constants as buffers (the JAX ``state`` tree)."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        self.register_buffer("eps", torch.tensor(eps, dtype=torch.float32))
        self.register_buffer("momentum", torch.tensor(momentum, dtype=torch.float32))


def batchnorm(p: BatchNorm, x, *, train: bool):
    """torch BatchNorm1d semantics on (B, T, C): biased variance to
    normalize, unbiased for the running update, which follows the JAX
    convention ``(1 - m) * old + m * batch`` and is written into the
    module's buffers in place. Within `parallel.mesh.split_rows` the
    statistics are those of the whole batch, over every rank of the data
    group (`sync_moments`: the count, the sums and the deviations from the
    global mean), and the running update uses the global count."""
    if train:
        axes = tuple(range(x.ndim - 1))
        mean = x.mean(dim=axes)
        var = x.var(dim=axes, unbiased=False)
        n = x.numel() // x.shape[-1]
        group = batch_group()
        if group is not None:
            mean, var, n = sync_moments(mean, var, n, group)
            unbias = n / torch.clamp(n - 1, min=1)
        else:
            unbias = n / max(n - 1, 1)
        with torch.no_grad():
            m = p.momentum
            p.mean.copy_((1 - m) * p.mean + m * mean)
            p.var.copy_((1 - m) * p.var + m * var * unbias)
    else:
        mean, var = p.mean, p.var
    return (x - mean) * torch.rsqrt(var + p.eps) * p.scale + p.bias


# ---------------- Prenet (dropout ALWAYS on, serving included) ----------------

def prenet_init(in_dim, hidden_dims=(256, 256), generator=None) -> nn.ModuleList:
    dims = [in_dim] + list(hidden_dims)
    return nn.ModuleList(Linear(a, b, bias=False, generator=generator)
                         for a, b in zip(dims[:-1], dims[1:]))


def prenet(layers: nn.ModuleList, x, rate: float = 0.5, generator=None):
    """relu(linear) + dropout per layer; the dropout is active at inference."""
    for layer in layers:
        x = dropout(F.relu(linear(layer, x)), rate, enabled=True, generator=generator)
    return x


# ---------------- Highway ----------------

class Highway(nn.Module):
    def __init__(self, in_dim, out_dim, generator=None):
        super().__init__()
        self.H = Linear(in_dim, out_dim, init="torch", generator=generator)
        self.T = Linear(in_dim, out_dim, init="torch", generator=generator)
        with torch.no_grad():
            self.H.b.zero_()
            self.T.b.fill_(-1.0)


def highway(p: Highway, x):
    h = F.relu(linear(p.H, x))
    t = torch.sigmoid(linear(p.T, x))
    return h * t + x * (1.0 - t)


# ---------------- MLP ----------------

class MLP(nn.ModuleList):
    """Linear layers of ``in_dim -> dims[0] -> ... -> dims[-1]`` with torch's
    default init (the JAX ``mlp_init`` list)."""

    def __init__(self, in_dim, dims, generator=None):
        sizes = [in_dim] + list(dims)
        super().__init__(Linear(a, b, init="torch", generator=generator)
                         for a, b in zip(sizes[:-1], sizes[1:]))


def mlp(layers: MLP, x, *, relu=True, drop_rate=0.0, train=True, generator=None):
    """Each layer, a ReLU unless ``relu`` is False, and dropout at
    ``drop_rate`` in train mode."""
    for layer in layers:
        x = linear(layer, x)
        if relu:
            x = F.relu(x)
        x = dropout(x, drop_rate, enabled=train, generator=generator)
    return x


# ---------------- conv-stack Postnet ----------------

class Postnet(nn.Module):
    """``n_conv`` convolutions (``n_mels -> embed_dim -> ... -> n_mels``,
    kernel ``kernel_size``; xavier gains tanh, the last linear), each with a
    BatchNorm (the JAX ``postnet_init`` pair of trees)."""

    def __init__(self, n_mels, embed_dim, kernel_size, n_conv, generator=None):
        super().__init__()
        ins = [n_mels] + [embed_dim] * (n_conv - 1)
        outs = [embed_dim] * (n_conv - 1) + [n_mels]
        gains = ["tanh"] * (n_conv - 1) + ["linear"]
        self.convs = nn.ModuleList(Conv1d(a, b, kernel_size, w_init_gain=g, generator=generator)
                                   for a, b, g in zip(ins, outs, gains))
        self.bn = nn.ModuleList(BatchNorm(b) for b in outs)


def postnet_apply(p: Postnet, x, *, drop_rate, train, generator=None):
    """x (B, T, n_mels): each conv, its BatchNorm (batch statistics and the
    running update in train mode), tanh on all but the last, dropout."""
    n = len(p.convs)
    for i, (conv, bn) in enumerate(zip(p.convs, p.bn)):
        x = batchnorm(bn, conv1d(conv, x), train=train)
        if i < n - 1:
            x = torch.tanh(x)
        x = dropout(x, drop_rate, enabled=train, generator=generator)
    return x


def sinusoid_encoding_table(n_position, d_hid, padding_idx=None):
    """Sinusoid position encoding (n_position, d_hid), float32: sin on the
    even dimensions, cos on the odd, of ``pos / 10000^(2 (dim // 2) /
    d_hid)`` (computed in float64); the ``padding_idx`` row zero."""
    pos = np.arange(n_position)[:, None].astype(np.float64)
    dim = np.arange(d_hid)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, 2.0 * (dim // 2) / d_hid)
    table = np.where(dim % 2 == 0, np.sin(angle), np.cos(angle))
    if padding_idx is not None:
        table[padding_idx] = 0.0
    return torch.from_numpy(table.astype(np.float32))
