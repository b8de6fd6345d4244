"""K6: CTC over the log-semiring lattice (`csrc/ctc.cu`), one CTA per
utterance.

`ctc_alpha` is the forward recursion: alphas (T, B, S) and the negative log
likelihood (B,), S = 2U + 1. `ctc_beta_grad` runs the backward recursion and
turns the occupancies ``exp(min(alpha + beta + nll, 0))`` into the gradient
of ``sum_b g[b] * nll[b]`` with respect to the log-probabilities, (B, T, C)
(two kernels in one launch call: the recursion, then a parallel sum).
Both reproduce `semi_tts_tpu/ops/ctc.py` edge for edge: the ``NEG_INF``
sentinel and the ``1e-37`` clamp of the three-way log-add, rows frozen past
their input length, target length 0, T = 1, and an impossible alignment
(nll ~ 1e30) with a zero gradient. Each wrapper launches its kernel for
CUDA tensors and runs its plain PyTorch version only for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build

NEG_INF = -1e30
MAX_STATES = 1024  # S = 2U + 1 states a CTA holds: one thread each


def _logaddexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    dead = m <= NEG_INF / 2
    m_safe = torch.where(dead, 0.0, m)
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe) + torch.exp(c - m_safe)
    out = m_safe + torch.log(torch.clamp(s, min=1e-37))
    return torch.where(dead, NEG_INF, out)


def _logaddexp(a, b):
    m = torch.maximum(a, b)
    return m + torch.log1p(torch.exp(-torch.abs(a - b)))


def _lattice(targets, target_lengths, blank: int):
    """Extended labels z (B, S), the skip mask (into odd states whose label
    differs from the one two back) and the valid-state mask."""
    B, U = targets.shape
    S = 2 * U + 1
    z = torch.full((B, S), blank, dtype=targets.dtype, device=targets.device)
    z[:, 1::2] = targets
    s = torch.arange(S, device=targets.device)
    z2 = torch.roll(z, 2, dims=1)
    can_skip = (s % 2 == 1)[None, :] & (z != z2) & (s >= 2)[None, :]
    valid = s[None, :] < (2 * target_lengths[:, None] + 1)
    return z, can_skip, valid


def _neg(shape, like):
    return torch.full(shape, NEG_INF, dtype=like.dtype, device=like.device)


def ctc_alpha_plain(log_probs, targets, input_lengths, target_lengths, blank: int = 0):
    B, T, C = log_probs.shape
    z, can_skip, valid = _lattice(targets.long(), target_lengths.long(), blank)
    S = z.shape[1]
    lp0 = log_probs[:, 0, :]
    alpha = _neg((B, S), log_probs)
    alpha[:, 0] = lp0[:, blank]
    if S > 1:
        alpha[:, 1] = torch.where(target_lengths > 0, lp0.gather(1, z[:, 1:2])[:, 0], NEG_INF)
    alpha = torch.where(valid, alpha, NEG_INF)
    alphas = [alpha]
    for t in range(1, T):
        a1 = torch.cat([_neg((B, 1), alpha), alpha[:, :-1]], 1)
        a2 = torch.cat([_neg((B, 2), alpha), alpha[:, :-2]], 1)[:, :S]
        a2 = torch.where(can_skip, a2, NEG_INF)
        new = _logaddexp3(alpha, a1, a2) + log_probs[:, t, :].gather(1, z)
        new = torch.where(valid, new, NEG_INF)
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
        alphas.append(alpha)
    end = 2 * target_lengths.long()
    a_end = alpha.gather(1, end[:, None])[:, 0]
    a_last = torch.where(target_lengths > 0,
                         alpha.gather(1, torch.clamp(end - 1, min=0)[:, None])[:, 0], NEG_INF)
    return torch.stack(alphas), -_logaddexp(a_end, a_last)


def ctc_beta_grad_plain(log_probs, targets, input_lengths, target_lengths, alphas, nll, g,
                        blank: int = 0):
    B, T, C = log_probs.shape
    z, can_skip, valid = _lattice(targets.long(), target_lengths.long(), blank)
    S = z.shape[1]
    s = torch.arange(S, device=z.device)[None, :]
    end = 2 * target_lengths.long()[:, None]
    term = torch.where((s == end) | ((s == end - 1) & (target_lengths[:, None] > 0)), 0.0, NEG_INF)
    term = torch.where(valid, term, NEG_INF).to(log_probs.dtype)
    skip_from = torch.cat([can_skip[:, 2:], torch.zeros_like(can_skip[:, :2])], 1)[:, :S]
    betas = [term]
    beta = term
    for t in range(T - 2, -1, -1):
        x = torch.where(valid, beta + log_probs[:, t + 1, :].gather(1, z), NEG_INF)
        x1 = torch.cat([x[:, 1:], _neg((B, 1), x)], 1)
        x2 = torch.cat([x[:, 2:], _neg((B, 2), x)], 1)[:, :S]
        x2 = torch.where(skip_from, x2, NEG_INF)
        beta = torch.where((t >= input_lengths - 1)[:, None], term, _logaddexp3(x, x1, x2))
        betas.append(beta)
    betas = torch.stack(betas[::-1])                                     # (T, B, S)
    occ = torch.exp(torch.clamp(alphas + betas + nll[None, :, None], max=0.0))
    onehot = ((z[:, :, None] == torch.arange(C, device=z.device)[None, None, :])
              & valid[:, :, None]).to(occ.dtype)
    grad = -torch.einsum("tbs,bsc->btc", occ, onehot)
    tmask = torch.arange(T, device=z.device)[None, :] < input_lengths[:, None]
    finite = nll < -NEG_INF / 2
    return grad * (g * finite)[:, None, None] * tmask[:, :, None].to(occ.dtype)


def _check(log_probs, targets, input_lengths, target_lengths, what):
    B, T, C = log_probs.shape
    build.require(log_probs, (B, T, C), f"{what} log_probs")
    build.require_int(targets, (B, targets.shape[1]), f"{what} targets")
    build.require_int(input_lengths, (B,), f"{what} input_lengths")
    build.require_int(target_lengths, (B,), f"{what} target_lengths")
    S = 2 * targets.shape[1] + 1
    if S > MAX_STATES:
        raise ValueError(f"{what}: {S} lattice states, the kernel takes at most {MAX_STATES}")
    return B, T, C, S


def ctc_alpha(log_probs, targets, input_lengths, target_lengths, blank: int = 0):
    """Forward recursion: (alphas (T, B, S), nll (B,)). ``targets`` (B, U)
    and the lengths are int32 (pad == blank)."""
    if not log_probs.is_cuda:
        return ctc_alpha_plain(log_probs, targets, input_lengths, target_lengths, blank)
    B, T, C, S = _check(log_probs, targets, input_lengths, target_lengths, "ctc_alpha")
    alphas = torch.empty((T, B, S), device=log_probs.device, dtype=torch.float32)
    nll = torch.empty((B,), device=log_probs.device, dtype=torch.float32)
    if B and T:
        fn = build.bind("ctc", "ctc_alpha_f32", 6, 5)
        build.check(fn(log_probs.data_ptr(), targets.data_ptr(), input_lengths.data_ptr(),
                       target_lengths.data_ptr(), alphas.data_ptr(), nll.data_ptr(),
                       B, T, C, targets.shape[1], blank, build.stream()), "ctc_alpha")
        ctc_alpha.launches += 1
    return alphas, nll


def ctc_beta_grad(log_probs, targets, input_lengths, target_lengths, alphas, nll, g,
                  blank: int = 0):
    """Backward recursion and gradient: d(sum_b g[b] nll[b]) / d log_probs,
    (B, T, C); zero at t >= input_lengths[b] and for impossible rows."""
    if not log_probs.is_cuda:
        return ctc_beta_grad_plain(log_probs, targets, input_lengths, target_lengths,
                                   alphas, nll, g, blank)
    B, T, C, S = _check(log_probs, targets, input_lengths, target_lengths, "ctc_beta_grad")
    build.require(alphas, (T, B, S), "ctc_beta_grad alphas")
    build.require(nll, (B,), "ctc_beta_grad nll")
    build.require(g, (B,), "ctc_beta_grad g")
    grad = torch.empty((B, T, C), device=log_probs.device, dtype=torch.float32)
    occ = torch.empty((T, B, S), device=log_probs.device, dtype=torch.float32)  # scratch
    if B and T:
        fn = build.bind("ctc", "ctc_beta_grad_f32", 9, 5)
        build.check(fn(log_probs.data_ptr(), targets.data_ptr(), input_lengths.data_ptr(),
                       target_lengths.data_ptr(), alphas.data_ptr(), nll.data_ptr(),
                       g.data_ptr(), occ.data_ptr(), grad.data_ptr(), B, T, C,
                       targets.shape[1], blank, build.stream()), "ctc_beta_grad")
        ctc_beta_grad.launches += 1
    return grad


ctc_alpha.launches = 0
ctc_beta_grad.launches = 0
