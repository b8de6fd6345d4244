"""STFT pieces as GEMMs over the window support (counterpart of
`semi_tts_tpu/ops/stft.py`).

Griffin-Lim (static geometry): the forward STFT is the whole-signal reflect
pad, framing over the nonzero support of the centred Hann window, then two
GEMMs with the windowed DFT basis; the inverse is two GEMMs with the
windowed inverse basis, then overlap-add, the squared-window envelope divide
and the ``n_fft // 2`` trim.

Featurizer (ragged rows): `reflect_pad_ragged` reflects each row around its
own length, `dynamic_hann_window` centres a window of runtime length, and
`frame_signal` cuts frames at a static hop (zero past the end) or a runtime
hop (the start clamped, as ``dynamic_slice`` does); the plain version of
kernel K5 (`kernels/features.py`) is built on these three.
`support_dft_basis` is the ``[cos | -sin]`` basis of the featurizer's DFT
GEMM, which with K5's ``spec_db`` takes the place of the JAX package's
``magnitude_dft``/``stft_magnitude``. Bases and envelopes are built in
float64 with numpy and cast to float32.

Reference forms, which no hot path runs and the tests hold the GEMM forms
to: `hann_window`, `stft_complex` (framing by gathering elements, then
``torch.fft.rfft``), `istft` (``torch.fft.irfft``, then `overlap_add`) and
`nola_check` (numpy).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def window_support(n_fft: int, win_length: int) -> tuple:
    """(offset, span) of the nonzero region of a ``win_length`` window
    centred in an ``n_fft`` frame."""
    return (n_fft - win_length) // 2, win_length


def _centered_hann_np(n_fft: int, win_length: int) -> np.ndarray:
    w = np.zeros(n_fft)
    left = (n_fft - win_length) // 2
    k = np.arange(win_length, dtype=np.float64)
    w[left : left + win_length] = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / win_length)
    return w


@lru_cache(maxsize=8)
def _dft_basis_np(n_fft: int, win_length: int):
    """Windowed forward real-DFT matrices (span, F) for re and im, rows cut
    to the window support."""
    off, span = window_support(n_fft, win_length)
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    w = _centered_hann_np(n_fft, win_length)[:, None]
    C = (w * np.cos(ang)).astype(np.float32)
    S = (w * -np.sin(ang)).astype(np.float32)
    return C[off : off + span], S[off : off + span]


@lru_cache(maxsize=8)
def _inv_dft_basis_np(n_fft: int, win_length: int):
    """Windowed inverse real-DFT matrices (F, span) for re and im:
    x_n w_n = (1/N)[X_0 + 2 sum_k (re_k cos - im_k sin) + re_{N/2} cos(pi n)] w_n."""
    F_ = n_fft // 2 + 1
    off, span = window_support(n_fft, win_length)
    n = np.arange(off, off + span, dtype=np.float64)[None, :]
    k = np.arange(F_, dtype=np.float64)[:, None]
    ang = 2.0 * np.pi * k * n / n_fft
    c = np.full((F_, 1), 2.0)
    c[0] = c[-1] = 1.0
    wn = _centered_hann_np(n_fft, win_length)[off : off + span][None, :]
    A = (c * np.cos(ang) * wn / n_fft).astype(np.float32)
    B = (-c * np.sin(ang) * wn / n_fft).astype(np.float32)
    return A, B


@lru_cache(maxsize=8)
def _static_ola_envelope(n_fft: int, hop: int, win_length: int, num_frames: int) -> np.ndarray:
    """Squared-window overlap-add envelope, float64."""
    w2 = _centered_hann_np(n_fft, win_length) ** 2
    expected = n_fft + hop * (num_frames - 1)
    env = np.zeros(expected)
    for t in range(num_frames):
        env[t * hop : t * hop + n_fft] += w2
    return env


@lru_cache(maxsize=16)
def dft_basis(n_fft: int, win_length: int, device) -> tuple:
    """(C, S) windowed forward basis on ``device``, each (span, F)."""
    return tuple(torch.from_numpy(m).to(device) for m in _dft_basis_np(n_fft, win_length))


@lru_cache(maxsize=16)
def inv_dft_basis(n_fft: int, win_length: int, device) -> tuple:
    """(A, B) windowed inverse basis on ``device``, each (F, span)."""
    return tuple(torch.from_numpy(m).to(device) for m in _inv_dft_basis_np(n_fft, win_length))


@lru_cache(maxsize=16)
def trimmed_envelope(n_fft: int, hop: int, win_length: int, num_frames: int, device,
                     length: int | None = None):
    """The envelope over the trimmed signal, float32, floored at 1e-11:
    the divisor of `overlap_add`, shape (hop * (num_frames - 1),), or the
    ``length`` samples past the first ``n_fft // 2``."""
    env = _static_ola_envelope(n_fft, hop, win_length, num_frames).astype(np.float32)
    half = n_fft // 2
    end = len(env) - half if length is None else half + length
    env = np.maximum(env[half:end], np.float32(1e-11))
    return torch.from_numpy(env).to(device)


def frame_reflect(x, *, n_fft: int, hop: int, win_length: int):
    """Reflect-pad ``(..., S)`` by ``n_fft // 2`` on both sides and cut
    ``1 + S // hop`` frames over the window support -> ``(..., T, span)``."""
    pad = n_fft // 2
    S = x.shape[-1]
    if S <= pad:
        raise ValueError(f"reflect padding by {pad} needs more than {pad} samples, got {S}")
    T = 1 + S // hop
    off, span = window_support(n_fft, win_length)
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, S), (pad, pad), mode="reflect")[:, 0]
    frames = xp[:, off:].unfold(-1, span, hop)[:, :T]
    return frames.reshape(lead + (T, span))


def overlap_add(frames, *, n_fft: int, hop: int, win_length: int, length: int | None = None):
    """Overlap-add windowed frames ``(..., T, span)`` (support-cut), divide
    by the squared-window envelope and trim ``n_fft // 2`` per side ->
    ``(..., hop * (T - 1))``; with ``length``, the ``length`` samples past
    the first ``n_fft // 2``. Frames are summed in the order of the JAX
    package's shifted-chunk adds."""
    T = frames.shape[-2]
    off, span = window_support(n_fft, win_length)
    lead = frames.shape[:-2]
    flat = frames.reshape(-1, T, span)
    B = flat.shape[0]
    expected = n_fft + hop * (T - 1)
    K = -(-(off + span) // hop)
    rows = T + K - 1
    acc = flat.new_zeros((B, rows, hop))
    for k in range(K):
        lo = max(k * hop, off)
        hi = min((k + 1) * hop, off + span)
        if hi <= lo:
            continue
        acc[:, k : k + T, lo - k * hop : hi - k * hop] += flat[:, :, lo - off : hi - off]
    half = n_fft // 2
    end = expected - half if length is None else half + length
    sig = acc.reshape(B, rows * hop)[:, half:end]
    sig = sig / trimmed_envelope(n_fft, hop, win_length, T, frames.device, length)
    return sig.reshape(lead + (sig.shape[-1],))


def stft_reim(x, *, n_fft: int, hop: int, win_length: int):
    """Complex STFT of ``(..., S)`` as (re, im), each ``(..., T, F)``."""
    frames = frame_reflect(x, n_fft=n_fft, hop=hop, win_length=win_length)
    C, S = dft_basis(n_fft, win_length, x.device)
    return frames @ C, frames @ S


def istft_reim(re, im, *, n_fft: int, hop: int, win_length: int):
    """Inverse STFT of (re, im), each ``(..., T, F)`` -> ``(..., hop*(T-1))``."""
    A, B = inv_dft_basis(n_fft, win_length, re.device)
    frames = re @ A + im @ B
    return overlap_add(frames, n_fft=n_fft, hop=hop, win_length=win_length)


# ---------------- reference forms ----------------

def hann_window(win_length: int, dtype=torch.float32, device=None):
    """Periodic Hann window (``torch.hann_window``'s default)."""
    n = torch.arange(win_length, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)


def stft_complex(x, *, n_fft: int, hop: int, win_length: int):
    """Complex STFT of ``(..., S)`` with whole-array reflect padding ->
    ``(..., 1 + S // hop, n_fft // 2 + 1)``: frames gathered element by
    element from the padded signal, windowed, then ``torch.fft.rfft``."""
    pad = n_fft // 2
    S = x.shape[-1]
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, S), (pad, pad), mode="reflect")[:, 0]
    num_frames = 1 + S // hop
    t = torch.arange(num_frames, device=x.device)[:, None]
    i = torch.arange(n_fft, device=x.device)[None, :]
    frames = xp[:, t * hop + i]                                      # (B, T, n_fft)
    frames = frames * dynamic_hann_window(n_fft, win_length, x.device)
    y = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return y.reshape(lead + y.shape[1:])


def istft(y, *, n_fft: int, hop: int, win_length: int, length: int | None = None):
    """Inverse STFT of complex ``(..., T, n_fft // 2 + 1)`` by windowed
    overlap-add (`overlap_add`) -> ``(..., hop * (T - 1))``, or ``(...,
    length)``; the envelope floored at 1e-11."""
    frames = torch.fft.irfft(y, n=n_fft, dim=-1) * dynamic_hann_window(n_fft, win_length, y.device)
    off, span = window_support(n_fft, win_length)
    return overlap_add(frames[..., off:off + span], n_fft=n_fft, hop=hop, win_length=win_length,
                       length=length)


def nola_check(n_fft: int, hop: int, win_length: int, num_frames: int = 16) -> float:
    """Minimum of the squared-window overlap-add envelope over the trimmed
    region (the reference asserts it exceeds 1e-11): the float32 window's
    squares summed in float64."""
    window = dynamic_hann_window(n_fft, win_length).numpy()
    expected = n_fft + hop * (num_frames - 1)
    env = np.zeros(expected)
    for t in range(num_frames):
        env[t * hop: t * hop + n_fft] += window ** 2
    half = n_fft // 2
    return float(np.abs(env[half: len(env) - half]).min())


# ---------------- featurizer pieces (ragged rows, runtime hop) ----------------

def dynamic_hann_window(n_fft: int, win_length, device=None):
    """Periodic Hann of ``win_length`` (an int or a 0-d integer tensor),
    centred in ``n_fft`` zeros, float32 ``(n_fft,)``."""
    win = torch.as_tensor(win_length, dtype=torch.int32, device=device)
    left = (n_fft - win) // 2
    k = torch.arange(n_fft, dtype=torch.int32, device=win.device) - left
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * k.to(torch.float32) / win.to(torch.float32))
    return torch.where((k >= 0) & (k < win), w, 0.0)


def reflect_pad_ragged(x, lengths, pad: int):
    """Reflect-pad each row of a right-zero-padded ``(B, S)`` batch around 0
    and around its own end ``lengths[b]`` -> ``(B, S + 2*pad)``. Samples at
    or past a row's length are zeroed first. Needs ``lengths > pad``; below
    that the right mirror's start is clamped to 0 as ``dynamic_slice`` does."""
    B, S = x.shape
    L = lengths.to(torch.int64)
    xm = torch.where(torch.arange(S, device=x.device)[None, :] < L[:, None], x, 0.0)
    y = torch.cat([xm[:, 1:pad + 1].flip(-1), xm, xm.new_zeros((B, pad))], dim=1)
    k = torch.arange(pad, device=x.device)[None, :]
    start = (L - (pad + 1)).clamp(0, S - pad)[:, None]
    tails = xm.gather(1, start + pad - 1 - k)                  # xm[L-2-k]
    at = (L + pad).clamp(0, S + pad)[:, None]
    return y.scatter(1, at + k, tails)


def frame_signal_static(x_padded, hop: int, num_frames: int, *, support: tuple):
    """Frames at a static ``hop`` over ``support`` = (offset, span) of each
    nominal frame -> ``(B, T, span)``. A frame whose tail runs past the
    padded signal is zero-padded."""
    off, span = support
    B, S_pad = x_padded.shape
    need = off + (num_frames - 1) * hop + span
    if S_pad < need:
        x_padded = F.pad(x_padded, (0, need - S_pad))
    return x_padded[:, off:].unfold(-1, span, hop)[:, :num_frames]


def frame_signal(x_padded, n_fft: int, hop, num_frames: int, *, support: tuple | None = None):
    """Frames of a padded batch ``(B, S_pad)`` -> ``(B, T, span)``. An int
    ``hop`` takes `frame_signal_static` (zeros past the end); a tensor hop
    clamps each frame's start to ``S_pad - span``, as ``dynamic_slice``
    does, so an overrunning frame repeats the final samples."""
    off, span = support if support is not None else (0, n_fft)
    if isinstance(hop, int):
        return frame_signal_static(x_padded, hop, num_frames, support=(off, span))
    B, S_pad = x_padded.shape
    t = torch.arange(num_frames, device=x_padded.device)
    start = (t * hop.to(torch.int64) + off).clamp(0, S_pad - span)
    idx = start[:, None] + torch.arange(span, device=x_padded.device)[None, :]
    return x_padded[:, idx]


@lru_cache(maxsize=16)
def support_dft_basis(n_fft: int, off: int, span: int, device) -> torch.Tensor:
    """Unwindowed ``[cos | -sin]`` real-DFT rows ``off .. off + span`` of an
    ``n_fft`` frame, ``(span, 2F)``: one GEMM gives ``[re | im]`` of windowed
    frames. Float64 with the phase reduced exactly, cast to float32."""
    n = np.arange(off, off + span, dtype=np.int64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.int64)[None, :]
    ang = 2.0 * np.pi * ((n * k) % n_fft) / n_fft
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)
    return torch.from_numpy(basis).to(device)
