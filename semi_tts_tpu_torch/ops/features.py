"""Audio configuration and the spectrogram-domain transforms that serving
needs (counterpart of `semi_tts_tpu/ops/features.py`)."""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

GFL_ITER = 30  # Griffin-Lim iterations
MIN_LEVEL_DB = -100
REF_LEVEL_DB = 20


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
        decay = torch.from_numpy(
            np.power(float(coeff), np.arange(1, n + 1, dtype=np.float64)).astype(np.float32)
        ).to(x.device)
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
