"""Batched Griffin-Lim waveform reconstruction (counterpart of
`semi_tts_tpu/ops/griffin_lim.py`).

Each round is: forward GEMM with the windowed DFT basis packed as
[C | S] (span, 2F), the K4 phase projection, inverse GEMM with the windowed
inverse basis packed as [A; B] (2F, span), then the K4 overlap-add +
framing pass that hands the next round its frames. The signal itself is
only materialised after the last round. fp32 throughout.
"""

from __future__ import annotations

import math

import torch

from ..kernels.griffin_lim import gl_ola_frame, gl_project
from .features import GFL_ITER, inv_preemphasis
from .stft import dft_basis, inv_dft_basis


def random_phases(shape, generator=None, device=None):
    """Initial phases U(-pi, pi) of ``shape``, drawn from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    return u * (2.0 * math.pi) - math.pi


def griffin_lim(magnitude, generator=None, *, n_fft: int, hop: int, win_length: int,
                n_iter: int = GFL_ITER, phases=None):
    """Reconstruct waveforms from amplitude spectrograms ``(..., T, F)``.

    Initial phases are U(-pi, pi) drawn from ``generator``, or given as
    ``phases`` (same shape as ``magnitude``). The order of rounds is the JAX
    package's: the initial inverse STFT, ``n_iter - 1`` rounds, then the
    final round (``n_iter`` projections in all). Returns ``(..., hop*(T-1))``.
    """
    magnitude = magnitude.abs()
    if phases is None:
        phases = random_phases(magnitude.shape, generator, magnitude.device)
    lead, (T, F_) = magnitude.shape[:-2], magnitude.shape[-2:]
    mag = magnitude.reshape(-1, T, F_).contiguous()
    ph = phases.reshape(-1, T, F_)
    dev = magnitude.device
    fwd = torch.cat(dft_basis(n_fft, win_length, dev), dim=1)         # (span, 2F)
    inv = torch.cat(inv_dft_basis(n_fft, win_length, dev), dim=0)     # (2F, span)
    geo = dict(n_fft=n_fft, hop=hop, win_length=win_length)

    inv_frames = torch.cat([mag * torch.cos(ph), mag * torch.sin(ph)], dim=-1) @ inv
    if n_iter <= 0:  # 0 projections = the raw random-phase inverse STFT
        out = gl_ola_frame(inv_frames, emit_signal=True, **geo)
    else:
        frames = gl_ola_frame(inv_frames, emit_signal=False, **geo)
        for i in range(n_iter):
            reim = gl_project(frames @ fwd, mag)
            frames = gl_ola_frame(reim @ inv, emit_signal=i == n_iter - 1, **geo)
        out = frames
    return out.reshape(lead + (out.shape[-1],))


def specgram_to_waveform(magnitude, generator=None, *, n_fft: int, hop: int, win_length: int,
                         preemphasis_coeff: float = 0.97, n_iter: int = GFL_ITER,
                         apply_inv_preemphasis: bool = True, phases=None):
    """Griffin-Lim + inverse pre-emphasis + clip to [-1, 1]."""
    wav = griffin_lim(magnitude, generator, n_fft=n_fft, hop=hop, win_length=win_length,
                      n_iter=n_iter, phases=phases)
    if apply_inv_preemphasis:
        wav = inv_preemphasis(wav, preemphasis_coeff)
    return torch.clamp(wav, -1.0, 1.0)
