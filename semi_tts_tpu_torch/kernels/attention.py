"""K3 `attention_step`: location features, energies, softmax and context of
one location-sensitive attention step, given the projected query.

The wrapper launches `csrc/attention.cu` for CUDA tensors and runs its plain
PyTorch version only for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build


def attention_step_plain(pq, processed_memory, memory, attn_hist, loc_w, loc_lin, v, mask=None):
    """pq (B, A), processed_memory (B, L, A), memory (B, L, D), attn_hist
    (B, C, L), loc_w (F, C, K) or None, loc_lin (A, F), v (A), mask (B, L)
    bool (True = padded) -> (context (B, D), weights (B, L))."""
    energy_in = pq[:, None, :]
    if loc_w is not None:
        k = loc_w.shape[2]
        loc = F.conv1d(attn_hist, loc_w, padding=(k - 1) // 2)      # (B, F, L)
        energy_in = energy_in + loc.transpose(1, 2) @ loc_lin.T     # (B, L, A)
    energy = torch.tanh(energy_in + processed_memory) @ v           # (B, L)
    if mask is not None:
        energy = energy.masked_fill(mask, float("-inf"))
    weights = torch.softmax(energy, dim=1)
    context = torch.einsum("bl,bld->bd", weights, memory)
    return context, weights


def attention_step(pq, processed_memory, memory, attn_hist, loc_w, loc_lin, v, mask=None):
    """Counterpart of `semi_tts_tpu.models.attention.attention_step` after its
    query projection; one launch per call on the card."""
    if not pq.is_cuda:
        return attention_step_plain(pq, processed_memory, memory, attn_hist,
                                    loc_w, loc_lin, v, mask)
    B, L, A = processed_memory.shape
    D = memory.shape[2]
    C = attn_hist.shape[1]
    build.require(pq, (B, A), "attention pq")
    build.require(processed_memory, (B, L, A), "attention processed_memory")
    build.require(memory, (B, L, D), "attention memory")
    build.require(attn_hist, (B, C, L), "attention attn_hist")
    build.require(v, (A,), "attention v")
    if loc_w is None:
        n_filt, K, loc_ptr, lin_ptr = 0, 1, None, None
    else:
        n_filt, K = loc_w.shape[0], loc_w.shape[2]
        build.require(loc_w, (n_filt, C, K), "attention loc_w")
        build.require(loc_lin, (A, n_filt), "attention loc_lin")
        loc_ptr, lin_ptr = loc_w.data_ptr(), loc_lin.data_ptr()
    mask_ptr = None
    if mask is not None:
        if not (mask.is_cuda and mask.dtype == torch.bool and mask.is_contiguous()
                and tuple(mask.shape) == (B, L)):
            raise ValueError("attention mask: expected a contiguous CUDA bool tensor (B, L)")
        mask_ptr = mask.data_ptr()  # torch.bool is one byte per element
    context = torch.empty((B, D), device=pq.device, dtype=torch.float32)
    weights = torch.empty((B, L), device=pq.device, dtype=torch.float32)
    if B == 0:
        return context, weights
    fn = build.bind("attention", "attention_step_f32", 10, 7)
    build.check(fn(pq.data_ptr(), processed_memory.data_ptr(), memory.data_ptr(),
                   attn_hist.data_ptr(), loc_ptr, lin_ptr, v.data_ptr(), mask_ptr,
                   context.data_ptr(), weights.data_ptr(),
                   B, L, A, D, C, n_filt, K, build.stream()), "attention_step")
    attention_step.launches += 1
    return context, weights


attention_step.launches = 0
