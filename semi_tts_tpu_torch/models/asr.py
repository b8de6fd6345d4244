"""CTC phoneme-ASR encoder (counterpart of `semi_tts_tpu/models/asr.py`):
a conv stack (one stride 2) with BatchNorm, tanh, residuals and dropout,
then a stacked BiLSTM (kernels K1/K7), an optional layer norm and a linear
projection to the latent space; plus the optional ASR postnet (2-layer
BiLSTM, linear, log-softmax)."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.dropout import dropout
from ..ops.rnn import multi_lstm, multi_lstm_init
from .common import BatchNorm, Conv1d, Linear, batchnorm, conv1d, linear


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    """Mirror of the YAML `model.encoder` block."""

    in_dim: int = 80
    out_dim: int = 64  # latent_dim
    dim: int = 512
    kernel: tuple = (3, 4, 3, 3, 3, 1)
    stride: tuple = (1, 2, 1, 1, 1, 1)
    residual: tuple = (0, 0, 1, 1, 1, 1)
    dropout: float = 0.5
    activation: str = "tanh"
    batch_norm: bool = True
    rnn_bid: bool = True
    rnn_layers: int = 2
    rnn_dim: int = 256
    layer_norm: bool = False

    @property
    def time_reduce_factor(self) -> int:
        return 2 ** sum(1 for s in self.stride if s != 1)


class _LayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class ASR(nn.Module):
    """Parameters of the JAX ``asr_init`` tree (``convs``, ``bn``, ``rnn``,
    ``postnet``, ``ln``) and the BN running statistics as buffers."""

    def __init__(self, cfg: ASRConfig, generator=None):
        super().__init__()
        dims = [cfg.in_dim] + [cfg.dim] * len(cfg.kernel)
        self.convs = nn.ModuleList(Conv1d(dims[i], dims[i + 1], k, generator=generator)
                                   for i, k in enumerate(cfg.kernel))
        if cfg.batch_norm:
            self.bn = nn.ModuleList(BatchNorm(d) for d in dims[1:])
        self.rnn = multi_lstm_init(dims[-1], cfg.rnn_dim, cfg.rnn_layers, cfg.rnn_bid,
                                   generator=generator)
        rnn_out = cfg.rnn_dim * (2 if cfg.rnn_bid else 1)
        self.postnet = Linear(rnn_out, cfg.out_dim, init="torch", generator=generator)
        if cfg.layer_norm:
            self.ln = _LayerNorm(rnn_out)


def asr_apply(asr: ASR, x, *, cfg: ASRConfig, train: bool, generator=None):
    """x: (B, T, in_dim) -> latents (B, T // time_reduce_factor, out_dim).
    In train mode BatchNorm normalizes with the batch statistics and updates
    the running ones in place, and dropout draws from ``generator``."""
    act = getattr(torch, cfg.activation.lower())
    for i, conv_p in enumerate(asr.convs):
        k = cfg.kernel[i]
        y = conv1d(conv_p, x, stride=cfg.stride[i], padding=1 if k != 1 else 0)
        if cfg.batch_norm:
            y = batchnorm(asr.bn[i], y, train=train)
        y = act(y)
        if cfg.residual[i]:
            y = y + x
        x = dropout(y, cfg.dropout, enabled=train, generator=generator)
    x = multi_lstm(asr.rnn, x, dropout=cfg.dropout, train=train, generator=generator)
    if cfg.layer_norm:
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, unbiased=False, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + 1e-5) * asr.ln.scale + asr.ln.bias
    x = dropout(x, cfg.dropout, enabled=train, generator=generator)
    return linear(asr.postnet, x)


class ASRPostnet(nn.Module):
    """2-layer BiLSTM over the latents, then a linear layer."""

    def __init__(self, latent_dim: int, vocab_size: int, generator=None):
        super().__init__()
        self.rnn = multi_lstm_init(latent_dim, latent_dim, 2, True, generator=generator)
        self.linear = Linear(latent_dim * 2, vocab_size, init="torch", generator=generator)


def asr_postnet_apply(p: ASRPostnet, x, *, train: bool, generator=None):
    """(B, T, D) -> log-softmax posteriors (B, T, V); dropout 0.5 in train mode."""
    y = multi_lstm(p.rnn, x, dropout=0.5, train=train, generator=generator)
    y = dropout(y, 0.5, enabled=train, generator=generator)
    return torch.log_softmax(linear(p.linear, y), dim=-1)
