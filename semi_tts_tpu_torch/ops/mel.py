"""Slaney-style mel filterbank, its pseudo-inverse and the DCT-II matrix
(port copy of `semi_tts_tpu/ops/mel.py`; numpy only, built once at set-up).

``mel_filterbank`` is the librosa Slaney filterbank with ``norm=1`` area
normalization; ``mel_pinv`` its Moore-Penrose pseudo-inverse (mel -> linear).
"""

from __future__ import annotations

import numpy as np

# Slaney auditory-toolbox mel scale constants: linear below 1 kHz
# (mel = f / (200/3)), logarithmic above with 27 steps per factor 6.4.
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies, htk: bool = False):
    """Convert Hz to mels (Slaney by default, HTK optional)."""
    f = np.asanyarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    mels = f / _F_SP
    if f.ndim:
        hi = f >= _MIN_LOG_HZ
        mels = np.where(hi, _MIN_LOG_MEL + np.log(np.maximum(f, 1e-20) / _MIN_LOG_HZ) / _LOGSTEP, mels)
    elif f >= _MIN_LOG_HZ:
        mels = _MIN_LOG_MEL + np.log(f / _MIN_LOG_HZ) / _LOGSTEP
    return mels


def mel_to_hz(mels, htk: bool = False):
    """Convert mels to Hz (inverse of :func:`hz_to_mel`)."""
    m = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    freqs = _F_SP * m
    if m.ndim:
        hi = m >= _MIN_LOG_MEL
        freqs = np.where(hi, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), freqs)
    elif m >= _MIN_LOG_MEL:
        freqs = _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL))
    return freqs


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    """Center frequency of each rFFT bin: 0 .. sr/2 inclusive."""
    return np.linspace(0.0, float(sr) / 2.0, 1 + n_fft // 2, endpoint=True)


def mel_frequencies(n_mels: int, fmin: float, fmax: float, htk: bool = False) -> np.ndarray:
    """``n_mels`` frequencies uniformly spaced on the mel axis, in Hz."""
    return mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels), htk)


def mel_filterbank(
    sr: float,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: int | None = 1,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank of shape ``(n_mels, 1 + n_fft // 2)``.

    With ``norm=1`` each triangle is scaled by ``2 / width`` (Slaney area
    normalization), matching the reference's vendored librosa fork.
    """
    if fmax is None:
        fmax = float(sr) / 2.0
    fftfreqs = fft_frequencies(sr, n_fft)                     # (F,)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk)      # (n_mels+2,)

    fdiff = np.diff(mel_f)                                    # (n_mels+1,)
    ramps = mel_f[:, None] - fftfreqs[None, :]                # (n_mels+2, F)

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == 1:
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights = weights * enorm[:, None]
    elif norm not in (None, np.inf):
        raise ValueError(f"Unsupported norm: {norm!r}")

    return weights.astype(dtype)


def mel_pinv(fb: np.ndarray) -> np.ndarray:
    """Moore-Penrose pseudo-inverse used to approximately invert the mel
    projection (mel amplitude -> linear amplitude).

    The reference builds ``pinverse(fb.T).T`` where its stored ``fb`` is the
    transposed basis (`src/audio.py:202`); net effect is ``pinv`` of the
    ``(n_mels, F)`` basis, shape ``(F, n_mels)``.
    """
    return np.linalg.pinv(fb.astype(np.float64)).astype(np.float32)


def dct_matrix(n_out: int, n_in: int, ortho: bool = True) -> np.ndarray:
    """Type-II DCT matrix (scipy/librosa `norm='ortho'` convention), used for
    MFCC extraction as a single matmul (reference: librosa.feature.mfcc via
    `src/audio.py:151`)."""
    n = np.arange(n_in, dtype=np.float64)
    k = np.arange(n_out, dtype=np.float64)[:, None]
    mat = 2.0 * np.cos(np.pi * k * (2.0 * n[None, :] + 1.0) / (2.0 * n_in))
    if ortho:
        mat[0] *= np.sqrt(1.0 / (4.0 * n_in))
        mat[1:] *= np.sqrt(1.0 / (2.0 * n_in))
    return mat.astype(np.float32)
