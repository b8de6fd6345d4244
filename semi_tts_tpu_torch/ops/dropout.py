"""Dropout with an explicit `torch.Generator` (the masks are drawn on the
activations' device). The models and the stacked LSTM share it."""

from __future__ import annotations

import torch


def dropout(x, rate: float, *, enabled: bool = True, generator=None):
    if not enabled or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
