"""Dropout with an explicit `torch.Generator` (the masks are drawn on the
activations' device). The models and the stacked LSTM share it. Every
input is rows first; within `parallel.mesh.split_rows` the mask is drawn
for the whole batch and this rank keeps its rows (`draw_rows`)."""

from __future__ import annotations

import torch

from ..parallel.mesh import draw_rows


def dropout(x, rate: float, *, enabled: bool = True, generator=None):
    if not enabled or rate <= 0.0:
        return x
    u = draw_rows(lambda s: torch.rand(s, generator=generator, device=x.device), x.shape)
    keep = u < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
