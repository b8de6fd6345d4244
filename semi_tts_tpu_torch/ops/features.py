"""Audio configuration, the batched featurizer and the spectrogram-domain
transforms (counterpart of `semi_tts_tpu/ops/features.py`).

`AudioFeaturizer` takes a right-zero-padded batch of waves to normalized
mel (and linear) spectrograms: kernel K5 `stft_frames` makes windowed
frames, one fp32 GEMM with the ``[cos | -sin]`` support basis gives
``[re | im]``, K5 `spec_db` the magnitude and the normalized dB, and a
second GEMM the mel projection. The clean path frames at the static hop
and window; the augmented path mixes in noise at a per-row SNR and frames
at the hop and window of one stretch rate per batch, computed on the device.
The window is multiplied in `stft_frames` on both paths (the basis is
unwindowed). `featurize_program` runs ``featurize`` as a compiled program
for the callers that featurize outside a train or eval step.

`AudioFeaturizer.mfcc`, `cmvn`, `segment_features` and `compute_len_ratio`
are the JAX package's MFCC and segment utilities, a path no trainer runs
(dormant upstream).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..device import resolve_device
from ..graphs import NoGradProgram
from ..kernels import features as K5
from ..parallel.mesh import draw_rows
from .mel import dct_matrix, mel_filterbank, mel_pinv
from .stft import support_dft_basis, window_support

GFL_ITER = 30  # Griffin-Lim iterations
MIN_LEVEL_DB = -100  # dB floor of the normalized range
REF_LEVEL_DB = 20    # reference level subtracted before normalizing
N_MFCC_NO_DELTA = 13  # cepstra before the deltas


def preemphasis(x, coeff: float):
    """y[0] = x[0]; y[n] = x[n] - coeff * x[n-1], along the last axis."""
    return torch.cat([x[..., :1], x[..., 1:] - coeff * x[..., :-1]], dim=-1)


def amp_to_db(x, minimum: float = 1e-5):
    return 20.0 * torch.log10(torch.clamp(x, min=minimum))


def db_to_amp(x):
    return torch.pow(10.0, 0.05 * x)


def normalize_db(feat):
    return torch.clamp((feat - MIN_LEVEL_DB) / -MIN_LEVEL_DB, 0.0, 1.0)


def denormalize_db(feat):
    return MIN_LEVEL_DB + torch.clamp(feat, 0.0, 1.0) * -MIN_LEVEL_DB


def linear_to_amp(linear_norm, power: float = 1.0):
    """Normalized linear spectrogram -> linear amplitude."""
    return db_to_amp(denormalize_db(linear_norm) + REF_LEVEL_DB) ** power


_SCAN_BLOCK = 256


@lru_cache(maxsize=16)
def _power_matrix(coeff: float, n: int, device):
    """(n, n) lower-triangular P[i, j] = coeff**(i - j), float64 then cast."""
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    p = np.where(i >= j, np.power(float(coeff), np.maximum(i - j, 0).astype(np.float64)), 0.0)
    return torch.from_numpy(p.astype(np.float32)).to(device)


@lru_cache(maxsize=16)
def _decay(coeff: float, n: int, device):
    """(n,) coeff**(i + 1), float64 then cast: made once, so that a step
    body copies no table from the host."""
    return torch.from_numpy(
        np.power(float(coeff), np.arange(1, n + 1, dtype=np.float64)).astype(np.float32)
    ).to(device)


def _linear_recurrence(x, coeff: float):
    """y[n] = x[n] + coeff * y[n-1] along the last axis of a 2-D (R, S) x.

    Blocked scan: within each block of `_SCAN_BLOCK` samples the zero-carry
    recurrence is one GEMM with the power matrix; the carry from one block
    to the next is the same recurrence over the blocks' last values with
    coefficient ``coeff ** block``, solved by recursion on that shorter
    sequence, then added back scaled by ``coeff ** (i + 1)``."""
    R, S = x.shape
    n = _SCAN_BLOCK
    nb = -(-S // n)
    xb = torch.nn.functional.pad(x, (0, nb * n - S)).reshape(R, nb, n)
    local = xb @ _power_matrix(coeff, n, x.device).T                  # (R, nb, n)
    if nb > 1:
        ends = _linear_recurrence(local[:, :, -1].contiguous(), coeff ** n)  # (R, nb)
        decay = _decay(coeff, n, x.device)
        carry = torch.nn.functional.pad(ends[:, :-1], (1, 0))          # block k gets end of k-1
        local = local + carry[:, :, None] * decay
    return local.reshape(R, nb * n)[:, :S]


def inv_preemphasis(wav, coeff: float = 0.97):
    """IIR y[n] = x[n] + coeff * y[n-1] (``lfilter([1], [1, -coeff])``)."""
    lead = wav.shape[:-1]
    y = _linear_recurrence(wav.reshape(-1, wav.shape[-1]), coeff)
    return y.reshape(lead + (wav.shape[-1],))


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Mirror of the YAML `data.audio` block."""

    num_freq: int = 1025
    num_mels: int = 80
    frame_length_ms: float = 50.0
    frame_shift_ms: float = 12.5
    preemphasis_coeff: float = 0.97
    sample_rate: int = 22050
    use_linear: bool = True
    snr_range: tuple = (10, 100)
    time_stretch_range: tuple = (0.9, 1.1)

    @property
    def n_fft(self) -> int:
        return (self.num_freq - 1) * 2

    @property
    def hop_length(self) -> int:
        return int(self.frame_shift_ms / 1000 * self.sample_rate)

    @property
    def win_length(self) -> int:
        return int(self.frame_length_ms / 1000 * self.sample_rate)

    @property
    def use_noise(self) -> bool:
        return -1 not in tuple(self.snr_range)

    @property
    def min_stretch_hop(self) -> int:
        """Smallest augmented hop (most frames), at the lowest stretch rate."""
        sr_min = int(self.sample_rate * min(self.time_stretch_range))
        return int(self.frame_shift_ms / 1000 * sr_min)

    @property
    def max_stretch_hop(self) -> int:
        """Largest augmented hop (fewest frames), at the highest stretch
        rate: the bound on the hop that sizes K5's staging buffers."""
        sr_max = int(self.sample_rate * max(self.time_stretch_range))
        return int(self.frame_shift_ms / 1000 * sr_max)

    @property
    def max_stretch_win(self) -> int:
        """Largest augmented window, at the highest stretch rate; every
        smaller centred window's support nests inside its support."""
        sr_max = int(self.sample_rate * max(self.time_stretch_range))
        return int(self.frame_length_ms / 1000 * sr_max)


class AudioFeaturizer:
    """Batched featurizer whose tables live on ``device``: the card unless
    the caller passes ``device="cpu"`` (see `resolve_device`).

    ``featurize(waves, lengths)`` -> (mel (B, T, M), linear (B, T, F),
    frame_lengths (B,)) with ``T = 1 + S // hop``; padded frames are zero.
    ``featurize_augmented(waves, lengths, generator)`` draws per-row SNRs,
    one stretch rate and the noise from ``generator`` and calls
    ``featurize_augmented_at``, which takes them explicitly ->
    (mel (B, T_max, M), frame_lengths (B,)), ``T_max = 1 + S //
    min_stretch_hop``. ``lengths`` must exceed ``n_fft // 2``."""

    def __init__(self, config: AudioConfig, device=None):
        self.cfg = c = config
        self.device = resolve_device(device)
        fb = mel_filterbank(c.sample_rate, c.n_fft, n_mels=c.num_mels)          # (M, F)
        self.mel_fb_t = torch.from_numpy(np.ascontiguousarray(fb.T)).to(self.device)  # (F, M)
        self.mel_fb_pinv_t = torch.from_numpy(np.ascontiguousarray(mel_pinv(fb).T)).to(
            self.device)  # (M, F)
        self._clean_geom = torch.tensor([c.hop_length, c.win_length], dtype=torch.int32,
                                        device=self.device)
        self.dct_t = torch.from_numpy(np.ascontiguousarray(
            dct_matrix(N_MFCC_NO_DELTA, c.num_mels).T)).to(self.device)  # (M, 13)

    def mel_to_linear_amp(self, mel_norm):
        """Normalized mel (..., T, M) -> linear amplitude (..., T, F): back to
        dB and to amplitude, then the mel filterbank's pseudo-inverse."""
        amp = db_to_amp(denormalize_db(mel_norm) + REF_LEVEL_DB)
        return amp @ self.mel_fb_pinv_t

    def _spectra(self, frames, frame_lengths, support, *, linear: bool):
        """Windowed frames -> (normalized mel, normalized linear or None)."""
        c = self.cfg
        reim = frames @ support_dft_basis(c.n_fft, *support, frames.device)
        levels = dict(min_db=MIN_LEVEL_DB, ref_db=REF_LEVEL_DB)
        mag, lin = K5.spec_db(reim, frame_lengths, reim=True, db=linear, **levels)
        _, mel = K5.spec_db(mag @ self.mel_fb_t, frame_lengths, reim=False, **levels)
        return mel, lin

    def featurize(self, waves, lengths):
        c = self.cfg
        lengths = lengths.to(torch.int32)
        T = 1 + waves.shape[1] // c.hop_length
        frame_lengths = 1 + lengths // c.hop_length
        support = window_support(c.n_fft, c.win_length)
        frames = K5.stft_frames(waves, lengths, self._clean_geom, n_fft=c.n_fft, support=support,
                                num_frames=T, clamp=False, coeff=c.preemphasis_coeff,
                                max_hop=c.hop_length)
        mel, lin = self._spectra(frames, frame_lengths, support, linear=True)
        return mel, lin, frame_lengths

    def stretch_geometry(self, rate, device=None):
        """int32 ``[hop, win]`` of a stretch rate (a float or 0-d tensor), on
        the rate's device: both int-truncated from the stretched sample rate,
        in float32 as the JAX package computes them. A train step gives a
        device tensor (`graphs.StepProgram` makes a float one), so that its
        body copies nothing from the host."""
        c = self.cfg
        rate = torch.as_tensor(rate, dtype=torch.float32, device=device)
        stretch_sr = torch.floor(c.sample_rate * rate).to(torch.int32).to(torch.float32)
        win = torch.floor(c.frame_length_ms / 1000.0 * stretch_sr)
        hop = torch.floor(c.frame_shift_ms / 1000.0 * stretch_sr)
        return torch.stack([hop, win]).to(torch.int32)

    def featurize_augmented_at(self, waves, lengths, snrs, rate, noise=None):
        """``snrs`` (B,) in dB, ``rate`` a scalar stretch rate, ``noise``
        (B, S) standard-normal draws (unused when the config has no noise)."""
        c = self.cfg
        B, S = waves.shape
        lengths = lengths.to(torch.int32)
        mix = None
        if c.use_noise:
            in_range = torch.arange(S, device=waves.device)[None, :] < lengths[:, None]
            pwr_sig = torch.where(in_range, waves, 0.0).pow(2).sum(1)
            pwr_noise = torch.where(in_range, noise, 0.0).pow(2).sum(1)
            mix = torch.sqrt(pwr_sig / pwr_noise * 10.0 ** (-snrs / 10.0))
        else:
            noise = None
        geom = self.stretch_geometry(rate, waves.device)
        T_max = 1 + S // c.min_stretch_hop
        frame_lengths = 1 + lengths // geom[0]
        support = window_support(c.n_fft, c.max_stretch_win)
        frames = K5.stft_frames(waves, lengths, geom, n_fft=c.n_fft,
                                support=support, num_frames=T_max, clamp=True,
                                coeff=c.preemphasis_coeff, noise=noise, mix=mix,
                                max_hop=c.max_stretch_hop)
        mel, _ = self._spectra(frames, frame_lengths, support, linear=False)
        return mel, frame_lengths

    def mfcc(self, mel_norm):
        """13 MFCC, their deltas and delta-deltas of a normalized log-mel
        ``(..., T, M)`` -> ``(..., T, 39)``: the ortho DCT-II as one GEMM,
        then regression deltas of window 2 (the edge frames repeated,
        divided by 2 * (1 + 4))."""
        mf = mel_norm @ self.dct_t

        def delta(x):
            xp = torch.cat([x[..., :1, :]] * 2 + [x] + [x[..., -1:, :]] * 2, dim=-2)
            T = x.shape[-2]
            return sum(n * (xp[..., 2 + n:2 + n + T, :] - xp[..., 2 - n:2 - n + T, :])
                       for n in (1, 2)) / 10.0

        d1 = delta(mf)
        return torch.cat([mf, d1, delta(d1)], dim=-1)

    def featurize_augmented(self, waves, lengths, generator=None):
        c = self.cfg
        B, S = waves.shape
        dev = waves.device
        lo, hi = c.snr_range if c.use_noise else (0.0, 0.0)
        snrs = lo + (hi - lo) * draw_rows(
            lambda s: torch.rand(s, generator=generator, device=dev), (B,))
        rlo, rhi = c.time_stretch_range
        rate = rlo + (rhi - rlo) * torch.rand((), generator=generator, device=dev)
        noise = (draw_rows(lambda s: torch.randn(s, generator=generator, device=dev), (B, S))
                 if c.use_noise else None)
        return self.featurize_augmented_at(waves, lengths, snrs, rate, noise)


def cmvn(x, axis: int = -2, eps: float = 1e-10):
    """Global cepstral mean and variance normalization over the time axis
    (the standard deviation unbiased)."""
    mean = x.mean(dim=axis, keepdim=True)
    n = x.shape[axis]
    var = x.var(dim=axis, unbiased=False, keepdim=True) * (n / max(n - 1, 1))
    return (x - mean) / (eps + torch.sqrt(var))


def segment_features(feat, boundary_ratios, min_segment_len: int = 2):
    """A (T, D) feature cut into per-phone segments (S, T_seg_max, D),
    zero-padded, at the boundary ratios; a segment shorter than
    ``min_segment_len`` frames joins the next one. Host numpy."""
    feat = np.asarray(feat)
    T, D = feat.shape
    points, prev, max_len = [], 0, 0
    for b in boundary_ratios:
        sp = round(b * T)
        if sp - prev >= min_segment_len:
            points.append((prev, sp))
            max_len = max(max_len, sp - prev)
            prev = sp
    out = np.zeros((len(points), max_len, D), feat.dtype)
    for i, (lo, hi) in enumerate(points):
        out[i, : hi - lo] = feat[lo:hi]
    return out


def compute_len_ratio(v: str):
    """A '12_34_56' boundary string -> its values over the last one."""
    vals = list(map(float, v.split("_")))
    return [t / vals[-1] for t in vals]


def featurize_program(feat: AudioFeaturizer, owner=None):
    """``feat.featurize`` as a `graphs.NoGradProgram` (the counterpart of
    the JAX featurizer's jitted ``featurize``): ``prog(waves, lengths)`` ->
    (mel, linear, frame_lengths), one program a batch shape. ``owner``: the
    caller's `GraphOwner` of a device (by default the program's own)."""
    return NoGradProgram(lambda waves, lengths, *, generator: feat.featurize(waves, lengths),
                         owner)
