"""Segment trim/merge for the unpaired speech cycle (counterpart of
`semi_tts_tpu/ops/quantize.py`): `trim_merge_segments` (kernel B6, a
`torch.autograd.Function` whose backward is B6's gather) and
`padded_concat`."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.quantize import trim_merge, trim_merge_bwd


class _TrimMerge(torch.autograd.Function):
    """B6 forward; the backward of the segment means: d_out[slot] / count on
    kept frames, 0 elsewhere. ``p_code`` gets no gradient (an argmax)."""

    @staticmethod
    def forward(ctx, p_code, latent, max_frames_per_phn, tokens):
        out, lengths, slot, count = trim_merge(p_code.contiguous(), latent.contiguous(),
                                               max_frames_per_phn, tokens)
        ctx.save_for_backward(slot, count)
        ctx.mark_non_differentiable(lengths)
        return out, lengths

    @staticmethod
    def backward(ctx, d_out, _):
        slot, count = ctx.saved_tensors
        return None, trim_merge_bwd(d_out.contiguous(), slot, count), None, None


def trim_merge_segments(p_code, latent, *, max_frames_per_phn: int, tokens=None):
    """p_code (B, T, C), latent (B, T, D) -> (trimmed (B, T, D), lengths (B,)
    int32, ok): the mean latent of each non-blank segment of each row,
    compacted left and zero-filled; a segment ends where the argmax token
    changes or its run passes ``max_frames_per_phn`` frames. ``ok`` (a bool
    tensor on the device) is False when a row keeps no segment. ``tokens``
    (B, T): the tokens to segment by instead of the argmax (so a reference
    run can follow another run's segmentation)."""
    out, lengths = _TrimMerge.apply(p_code, latent, max_frames_per_phn,
                                    None if tokens is None else tokens.to(torch.int32).contiguous())
    return out, lengths, (lengths > 0).all()


def padded_concat(pair, unpair):
    """Concatenate two batches on the batch axis, zero-padding time (axis 1)
    to the longer."""
    pad = [0, 0] * (pair.dim() - 2)
    T = max(pair.shape[1], unpair.shape[1])
    return torch.cat([F.pad(pair, pad + [0, T - pair.shape[1]]),
                      F.pad(unpair, pad + [0, T - unpair.shape[1]])], 0)
