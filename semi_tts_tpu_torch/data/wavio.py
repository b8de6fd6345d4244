"""Minimal RIFF/WAVE reader and writer, numpy only (counterpart of
`semi_tts_tpu/data/wavio.py`, whose formats and rounding it keeps).

Supports PCM 16/24/32-bit and IEEE float32, the formats LJSpeech and VCTK
ship in. :func:`read` returns float32 in [-1, 1], shape (channels,
samples); :func:`write` writes PCM 16-bit (default) or float32.
"""

from __future__ import annotations

import struct

import numpy as np

_WAVE_FORMAT_PCM = 1
_WAVE_FORMAT_IEEE_FLOAT = 3
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read(path):
    """Returns (waveform float32 (channels, samples), sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_ch, sr, _, _, bits = fmt
    if audio_format == _WAVE_FORMAT_EXTENSIBLE:
        audio_format = _WAVE_FORMAT_PCM  # subformat GUID's first bytes; PCM assumed

    if audio_format == _WAVE_FORMAT_IEEE_FLOAT and bits == 32:
        x = np.frombuffer(raw, "<f4").astype(np.float32)
    elif audio_format == _WAVE_FORMAT_PCM and bits == 16:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif audio_format == _WAVE_FORMAT_PCM and bits == 32:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif audio_format == _WAVE_FORMAT_PCM and bits == 24:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int8).astype(np.int32) << 16)
        ).astype(np.float32) / 8388608.0
    else:
        raise NotImplementedError(f"{path}: wav format {audio_format}/{bits}bit")

    n = (len(x) // n_ch) * n_ch
    return x[:n].reshape(-1, n_ch).T.copy(), sr


def write(path, wav, sr: int, *, subtype: str = "PCM_16"):
    """wav: (samples,) or (channels, samples), float in [-1, 1]."""
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 1:
        wav = wav[None]
    n_ch, n = wav.shape
    inter = np.ascontiguousarray(wav.T)
    if subtype == "PCM_16":
        body = (np.clip(inter, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
        bits, afmt = 16, _WAVE_FORMAT_PCM
    elif subtype == "FLOAT":
        body = inter.astype("<f4").tobytes()
        bits, afmt = 32, _WAVE_FORMAT_IEEE_FLOAT
    else:
        raise NotImplementedError(subtype)
    block = n_ch * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, afmt, n_ch, sr, sr * block, block, bits)
    hdr += b"data" + struct.pack("<I", len(body))
    with open(path, "wb") as f:
        f.write(hdr + body)


def duration(path) -> float:
    """Seconds of audio (`src/util.py:247-249` used soundfile)."""
    wav, sr = read(path)
    return wav.shape[1] / sr
