"""K4: the per-round glue of Griffin-Lim around the two DFT GEMMs.

`gl_project` is the phase projection on a packed (re | im) spectrum;
`gl_ola_frame` turns inverse-GEMM frames into the next round's forward-GEMM
frames (overlap-add, envelope divide, trim, reflect pad, framing), or into
the signal on the last round. Each wrapper launches `csrc/griffin_lim.cu`
for CUDA tensors and runs its plain PyTorch version only for CPU tensors.
"""

from __future__ import annotations

import torch

from ..ops.stft import frame_reflect, overlap_add, trimmed_envelope, window_support
from . import build


def gl_project_plain(reim, mag):
    """reim (..., 2F) = [re | im], mag (..., F) -> [mag*re/r | mag*im/r],
    and [mag | 0] where r = |re + i im| == 0 (angle(0) = 0)."""
    F_ = mag.shape[-1]
    re, im = reim[..., :F_], reim[..., F_:]
    r = torch.sqrt(re * re + im * im)
    nz = r > 0
    scale = mag / torch.where(nz, r, torch.ones_like(r))
    y_re = torch.where(nz, re * scale, mag)
    y_im = torch.where(nz, im * scale, torch.zeros_like(im))
    return torch.cat([y_re, y_im], dim=-1)


def gl_project(reim, mag):
    """Phase projection of one Griffin-Lim round; one launch on the card."""
    if not reim.is_cuda:
        return gl_project_plain(reim, mag)
    F_ = mag.shape[-1]
    build.require(mag, mag.shape, "gl_project mag")
    build.require(reim, mag.shape[:-1] + (2 * F_,), "gl_project reim")
    out = torch.empty_like(reim)
    rows = mag.numel() // F_ if F_ else 0
    if rows == 0:
        return out
    fn = build.bind("griffin_lim", "gl_project_f32", 3, 2)
    build.check(fn(reim.data_ptr(), mag.data_ptr(), out.data_ptr(), rows, F_,
                   build.stream()), "gl_project")
    gl_project.launches += 1
    return out


gl_project.launches = 0


def gl_ola_frame_plain(frames, *, n_fft: int, hop: int, win_length: int, emit_signal: bool):
    """frames (B, T, span) -> signal (B, hop*(T-1)) when ``emit_signal``,
    else the frames (B, T, span) of that signal's reflect-padded STFT."""
    sig = overlap_add(frames, n_fft=n_fft, hop=hop, win_length=win_length)
    if emit_signal:
        return sig
    return frame_reflect(sig, n_fft=n_fft, hop=hop, win_length=win_length)


def gl_ola_frame(frames, *, n_fft: int, hop: int, win_length: int, emit_signal: bool):
    """istft tail + next stft head in one pass; one launch on the card."""
    if not frames.is_cuda:
        return gl_ola_frame_plain(frames, n_fft=n_fft, hop=hop, win_length=win_length,
                                  emit_signal=emit_signal)
    B, T, span = frames.shape
    off, want_span = window_support(n_fft, win_length)
    build.require(frames, (B, T, want_span), "gl_ola_frame frames")
    S = hop * (T - 1)
    if S <= n_fft // 2:
        raise ValueError(f"reflect padding by {n_fft // 2} needs more than {n_fft // 2} samples, got {S}")
    env = trimmed_envelope(n_fft, hop, win_length, T, frames.device)
    shape = (B, S) if emit_signal else (B, T, span)
    out = torch.empty(shape, device=frames.device, dtype=torch.float32)
    if B == 0:
        return out
    fn = build.bind("griffin_lim", "gl_ola_frame_f32", 3, 7)
    build.check(fn(frames.data_ptr(), env.data_ptr(), out.data_ptr(), B, T, span, hop, off,
                   n_fft // 2, int(emit_signal), build.stream()), "gl_ola_frame")
    gl_ola_frame.launches += 1
    return out


gl_ola_frame.launches = 0
