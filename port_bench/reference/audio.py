"""Plain audio pieces of the reference: the Slaney mel filterbank, the
ragged-row featurizer (pre-emphasis, reflect padding about each row's own
end, a centred Hann window, the real DFT as one product over the window's
support, normalized dB), the noise and stretch augmentation, and
Griffin-Lim with the DFT as products over the window's support, then the
inverse pre-emphasis in float64 (scipy's ``lfilter``).

Every table is built here in float64 with NumPy and cast to float32."""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

MIN_DB, REF_DB = -100.0, 20.0
GL_ITERS = 30


class Audio:
    """The ``audio`` block of a configuration file."""

    def __init__(self, a: dict):
        self.sr = int(a["sample_rate"])
        self.n_fft = (int(a["num_freq"]) - 1) * 2
        self.n_freq = int(a["num_freq"])
        self.n_mels = int(a["num_mels"])
        self.frame_length_ms = float(a["frame_length_ms"])
        self.frame_shift_ms = float(a["frame_shift_ms"])
        self.hop = int(self.frame_shift_ms / 1000 * self.sr)
        self.win = int(self.frame_length_ms / 1000 * self.sr)
        self.coeff = float(a["preemphasis_coeff"])
        self.snr_range = tuple(a["snr_range"])
        self.stretch = tuple(a["time_stretch_range"])
        lo, hi = min(self.stretch), max(self.stretch)
        self.min_hop = int(self.frame_shift_ms / 1000 * int(self.sr * lo))
        self.max_win = int(self.frame_length_ms / 1000 * int(self.sr * hi))

    @property
    def use_noise(self):
        return -1 not in self.snr_range


def mel_filterbank(sr, n_fft, n_mels):
    """librosa's Slaney filterbank with area normalization, (n_mels, F)."""
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0

    def to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-20) / min_log_hz) / logstep, f / f_sp)

    def to_hz(m):
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)

    fft_f = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = to_hz(np.linspace(to_mel(0.0), to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return (w * (2.0 / (mel_f[2:] - mel_f[:-2]))[:, None]).astype(np.float32)


def support(n_fft, win):
    """(offset, span) of a ``win``-long window centred in ``n_fft``."""
    return (n_fft - win) // 2, win


@lru_cache(maxsize=16)
def _dft(n_fft, off, span, device):
    n = np.arange(off, off + span, dtype=np.int64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.int64)[None, :]
    ang = 2.0 * np.pi * ((n * k) % n_fft) / n_fft
    return torch.from_numpy(np.concatenate([np.cos(ang), -np.sin(ang)], 1).astype(np.float32)).to(device)


@lru_cache(maxsize=8)
def _mel_t(sr, n_fft, n_mels, device):
    return torch.from_numpy(np.ascontiguousarray(mel_filterbank(sr, n_fft, n_mels).T)).to(device)


def hann(n_fft, win, device):
    """Periodic Hann of ``win`` (an int or a 0-d int tensor) centred in
    ``n_fft`` zeros."""
    win = torch.as_tensor(win, dtype=torch.int32, device=device)
    k = torch.arange(n_fft, dtype=torch.int32, device=device) - (n_fft - win) // 2
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * k.to(torch.float32) / win.to(torch.float32))
    return torch.where((k >= 0) & (k < win), w, 0.0)


def reflect_ragged(x, lengths, pad):
    """Each row reflected about 0 and about its own end."""
    B, S = x.shape
    L = lengths.to(torch.int64)
    y = torch.cat([x[:, 1:pad + 1].flip(-1), x, x.new_zeros((B, pad))], 1)
    k = torch.arange(pad, device=x.device)[None, :]
    start = (L - (pad + 1)).clamp(0, S - pad)[:, None]
    tails = x.gather(1, start + pad - 1 - k)
    at = (L + pad).clamp(0, S + pad)[:, None]
    return y.scatter(1, at + k, tails)


def frames_of(xp, hop, T, off, span, tensor_hop):
    """Frames over the support: a static hop pads past the end with zeros, a
    device hop clamps each start to the last full span."""
    B, S = xp.shape
    if not tensor_hop:
        need = off + (T - 1) * hop + span
        if S < need:
            xp = F.pad(xp, (0, need - S))
        return xp[:, off:].unfold(-1, span, hop)[:, :T]
    t = torch.arange(T, device=xp.device)
    start = (t * hop.to(torch.int64) + off).clamp(0, S - span)
    return xp[:, start[:, None] + torch.arange(span, device=xp.device)[None, :]]


def _db(amp, flen):
    keep = (torch.arange(amp.shape[1], device=amp.device)[None, :] < flen[:, None])[:, :, None]
    level = 20.0 * torch.log10(torch.clamp(amp, min=1e-5)) - REF_DB
    return torch.where(keep, torch.clamp((level - MIN_DB) / -MIN_DB, 0.0, 1.0), 0.0)


def _spectra(a: Audio, waves, lengths, hop, win, T, sup, tensor_hop, linear):
    S = waves.shape[1]
    in_range = torch.arange(S, device=waves.device)[None, :] < lengths[:, None]
    pre = torch.cat([waves[:, :1], waves[:, 1:] - a.coeff * waves[:, :-1]], 1)
    xp = reflect_ragged(torch.where(in_range, pre, 0.0), lengths, a.n_fft // 2)
    off, span = sup
    fr = frames_of(xp, hop, T, off, span, tensor_hop) * hann(a.n_fft, win, waves.device)[off:off + span]
    h = hop.to(torch.int64) if tensor_hop else hop
    flen = 1 + lengths.to(torch.int64) // h
    fr = torch.where((torch.arange(T, device=waves.device)[None, :] < flen[:, None])[:, :, None], fr, 0.0)
    reim = fr @ _dft(a.n_fft, off, span, waves.device)
    Fq = reim.shape[-1] // 2
    mag = torch.sqrt(reim[..., :Fq] ** 2 + reim[..., Fq:] ** 2)
    mel = _db(mag @ _mel_t(a.sr, a.n_fft, a.n_mels, waves.device), flen)
    return mel, (_db(mag, flen) if linear else None), flen


def featurize(a: Audio, waves, lengths):
    """Clean features -> (mel, linear, frame lengths), ``1 + S // hop`` frames."""
    T = 1 + waves.shape[1] // a.hop
    return _spectra(a, waves, lengths, a.hop, a.win, T, support(a.n_fft, a.win), False, True)


def augment_draws(a: Audio, B, S, g, device):
    """(snrs, rate, noise) of one batch, in the order the program draws them."""
    lo, hi = a.snr_range if a.use_noise else (0.0, 0.0)
    snrs = lo + (hi - lo) * torch.rand((B,), generator=g, device=device)
    rlo, rhi = a.stretch
    rate = rlo + (rhi - rlo) * torch.rand((), generator=g, device=device)
    noise = torch.randn((B, S), generator=g, device=device) if a.use_noise else None
    return snrs, rate, noise


def featurize_augmented(a: Audio, waves, lengths, snrs, rate, noise):
    """Noise at each row's SNR and one stretch rate -> (mel, frame lengths),
    ``1 + S // min_hop`` frames."""
    B, S = waves.shape
    if noise is not None:
        in_range = torch.arange(S, device=waves.device)[None, :] < lengths[:, None]
        p_sig = torch.where(in_range, waves, 0.0).pow(2).sum(1)
        p_noise = torch.where(in_range, noise, 0.0).pow(2).sum(1)
        mix = torch.sqrt(p_sig / p_noise * 10.0 ** (-snrs / 10.0))
        waves = torch.where(in_range, waves + mix[:, None] * noise, 0.0)
    sr = torch.floor(a.sr * torch.as_tensor(rate, dtype=torch.float32)).to(torch.int32).to(torch.float32)
    win = torch.floor(a.frame_length_ms / 1000.0 * sr).to(torch.int32)
    hop = torch.floor(a.frame_shift_ms / 1000.0 * sr).to(torch.int32)
    T = 1 + S // a.min_hop
    mel, _, flen = _spectra(a, waves, lengths, hop, win, T, support(a.n_fft, a.max_win), True, False)
    return mel, flen


# ---------------- Griffin-Lim ----------------

def _centred_hann_np(n_fft, win):
    w = np.zeros(n_fft)
    off = (n_fft - win) // 2
    w[off:off + win] = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win) / win)
    return w


@lru_cache(maxsize=8)
def _gl_bases(n_fft, win, device):
    """Windowed forward (span, 2F) and inverse (2F, span) real-DFT bases."""
    off, span = support(n_fft, win)
    w = _centred_hann_np(n_fft, win)[off:off + span]
    n = np.arange(off, off + span, dtype=np.float64)
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    ang = 2.0 * np.pi * n[:, None] * k[None, :] / n_fft
    fwd = np.concatenate([w[:, None] * np.cos(ang), w[:, None] * -np.sin(ang)], 1)
    c = np.full(len(k), 2.0)
    c[0] = c[-1] = 1.0
    inv = np.concatenate([c[:, None] * np.cos(ang.T) * w[None, :] / n_fft,
                          -c[:, None] * np.sin(ang.T) * w[None, :] / n_fft], 0)
    return (torch.from_numpy(fwd.astype(np.float32)).to(device),
            torch.from_numpy(inv.astype(np.float32)).to(device))


@lru_cache(maxsize=32)
def _envelope(n_fft, hop, win, T, device):
    w2 = _centred_hann_np(n_fft, win) ** 2
    env = np.zeros(n_fft + hop * (T - 1))
    for t in range(T):
        env[t * hop:t * hop + n_fft] += w2
    half = n_fft // 2
    env = np.maximum(env[half:len(env) - half].astype(np.float32), np.float32(1e-11))
    return torch.from_numpy(env).to(device)


def _istft(frames, n_fft, hop, win):
    """Windowed frames over the support (B, T, span) -> (B, hop*(T-1))."""
    B, T, span = frames.shape
    off = (n_fft - win) // 2
    ola = F.fold(frames.transpose(1, 2), (1, hop * (T - 1) + span), (1, span), stride=(1, hop))
    sig = F.pad(ola.reshape(B, -1), (off, n_fft - off - span))
    half = n_fft // 2
    return sig[:, half:sig.shape[1] - half] / _envelope(n_fft, hop, win, T, frames.device)


def _stft_frames(x, n_fft, hop, win):
    pad = n_fft // 2
    off, span = support(n_fft, win)
    T = 1 + x.shape[-1] // hop
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    return xp[:, off:].unfold(-1, span, hop)[:, :T]


def griffin_lim(mag, phases, n_fft, hop, win, n_iter=GL_ITERS):
    """Amplitude (B, T, F) and initial phases -> signal (B, hop*(T-1)):
    the inverse of the random-phase spectrum, then ``n_iter`` rounds of
    STFT, magnitude projection (angle 0 where the spectrum is 0), inverse."""
    fwd, inv = _gl_bases(n_fft, win, mag.device)
    Fq = mag.shape[-1]
    x = _istft(torch.cat([mag * torch.cos(phases), mag * torch.sin(phases)], -1) @ inv, n_fft, hop, win)
    for _ in range(n_iter):
        reim = _stft_frames(x, n_fft, hop, win) @ fwd
        re, im = reim[..., :Fq], reim[..., Fq:]
        r = torch.sqrt(re * re + im * im)
        nz = r > 0
        s = mag / torch.where(nz, r, torch.ones_like(r))
        proj = torch.cat([torch.where(nz, re * s, mag), torch.where(nz, im * s, 0.0)], -1)
        x = _istft(proj @ inv, n_fft, hop, win)
    return x


def random_phases(shape, g, device):
    return torch.rand(shape, generator=g, device=device) * (2.0 * math.pi) - math.pi


def inv_preemphasis(wav, coeff):
    """y[n] = x[n] + coeff * y[n-1], in float64 on the host."""
    from scipy.signal import lfilter

    y = lfilter([1.0], [1.0, -coeff], wav.detach().cpu().double().numpy(), axis=-1)
    return torch.from_numpy(y).to(torch.float32)


def linear_to_amp(lin):
    return torch.pow(10.0, 0.05 * (MIN_DB + torch.clamp(lin, 0.0, 1.0) * -MIN_DB + REF_DB))
