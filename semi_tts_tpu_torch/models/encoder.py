"""Tacotron2 text-side encoder: conv x N + BiLSTM (counterpart of
`semi_tts_tpu/models/encoder.py`). The BiLSTM runs through kernel K1, and
under autograd through K1 with cell states and the K7 backward. In train
mode the BatchNorms normalize with the batch's statistics and update their
running ones in place."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..ops.dropout import dropout
from ..ops.rnn import multi_lstm, multi_lstm_init
from .common import BatchNorm, Conv1d, batchnorm, conv1d


class Encoder(nn.Module):
    def __init__(self, in_dim, enc_embed_dim, enc_n_conv, enc_rnn_layer, enc_kernel_size,
                 generator=None):
        super().__init__()
        self.convs = nn.ModuleList()
        self.bn = nn.ModuleList()
        d = in_dim
        for _ in range(enc_n_conv):
            self.convs.append(Conv1d(d, enc_embed_dim, enc_kernel_size, w_init_gain="relu",
                                     generator=generator))
            self.bn.append(BatchNorm(enc_embed_dim))
            d = enc_embed_dim
        self.lstm = multi_lstm_init(enc_embed_dim, enc_embed_dim // 2, enc_rnn_layer,
                                    bidirectional=True, generator=generator)


def encoder_apply(enc: Encoder, x, *, dropout_rate=0.5, train=False, generator=None):
    """x: (B, L, in_dim) -> (B, L, enc_embed_dim)."""
    for conv_p, bn_p in zip(enc.convs, enc.bn):
        x = F.relu(batchnorm(bn_p, conv1d(conv_p, x), train=train))
        x = dropout(x, dropout_rate, enabled=train, generator=generator)
    return multi_lstm(enc.lstm, x)
