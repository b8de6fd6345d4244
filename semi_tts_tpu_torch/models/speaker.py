"""Speaker encoder: a conv stack with BatchNorm, then mean and standard
deviation over time (counterpart of `semi_tts_tpu/models/speaker.py`).
No path of either package uses it: the live model looks speakers up in a
table. Its BatchNorm running statistics are buffers, the JAX ``state``
tree ``{"bn": [...]}``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import dropout
from .common import BatchNorm, Conv1d, batchnorm, conv1d


class SpeakerEncoder(nn.Module):
    """``convs`` (``filters`` wide, the last ``out_dim // 2``; xavier with
    the ReLU gain, the last linear) and ``bn``, one BatchNorm a conv."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int, filters, generator=None):
        super().__init__()
        ins = [in_dim] + list(filters)
        outs = list(filters) + [out_dim // 2]
        gains = ["relu"] * (len(outs) - 1) + ["linear"]
        self.convs = nn.ModuleList(Conv1d(a, b, kernel_size, w_init_gain=gain, generator=generator)
                                   for a, b, gain in zip(ins, outs, gains))
        self.bn = nn.ModuleList(BatchNorm(b) for b in outs)


def speaker_encoder_apply(m: SpeakerEncoder, x, *, drop_rate: float, train: bool,
                          generator=None):
    """x (B, T, n_mels) -> (B, out_dim): the mean and the standard deviation
    (ddof 1) over time of the last conv's output. ``train``: batch
    statistics (the running ones updated in place) and dropout."""
    n = len(m.convs)
    for i, (conv, bn) in enumerate(zip(m.convs, m.bn)):
        x = batchnorm(bn, conv1d(conv, x), train=train)
        if i < n - 1:
            x = F.relu(x)
        x = dropout(x, drop_rate, enabled=train, generator=generator)
    return torch.cat([x.mean(1), x.std(1, unbiased=True)], dim=-1)
