"""CTC loss (counterpart of `semi_tts_tpu/ops/ctc.py`), the
``torch.nn.CTCLoss(blank=0)`` semantics the reference trains with.

The per-utterance negative log likelihood is a `torch.autograd.Function`
whose forward is kernel K6 `ctc_alpha` (alphas kept for the backward) and
whose backward is K6 `ctc_beta_grad`: the alpha-beta occupancies give the
gradient directly, as the JAX package's custom VJP does.
"""

from __future__ import annotations

import torch

from ..kernels.ctc import NEG_INF, ctc_alpha, ctc_beta_grad

__all__ = ["NEG_INF", "ctc_loss"]


class _CTCNll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths, blank):
        alphas, nll = ctc_alpha(log_probs, targets, input_lengths, target_lengths, blank)
        ctx.save_for_backward(log_probs, targets, input_lengths, target_lengths, alphas, nll)
        ctx.blank = blank
        return nll

    @staticmethod
    def backward(ctx, g):
        log_probs, targets, input_lengths, target_lengths, alphas, nll = ctx.saved_tensors
        grad = ctc_beta_grad(log_probs, targets, input_lengths, target_lengths, alphas, nll,
                             g.contiguous(), ctx.blank)
        return grad, None, None, None, None


def ctc_loss(log_probs, targets, input_lengths, target_lengths, *, blank: int = 0,
             reduction: str = "mean"):
    """CTC loss of batch-major ``log_probs`` (B, T, C) for ``targets`` (B, U)
    padded with ``blank``. ``reduction``: 'mean' (each NLL divided by its
    target length, then averaged), 'sum' or 'none' (the NLL of each row)."""
    i32 = lambda x: torch.as_tensor(x, device=log_probs.device).to(torch.int32).contiguous()
    tl = i32(target_lengths)
    nll = _CTCNll.apply(log_probs.contiguous(), i32(targets), i32(input_lengths), tl, blank)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return (nll / torch.clamp(tl, min=1).to(nll.dtype)).mean()
    raise ValueError(reduction)
