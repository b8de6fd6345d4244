"""K5: the featurizer glue around the DFT and mel GEMMs (`csrc/features.cu`).

`stft_frames` takes padded waves to windowed frames in one pass: optional
noise mixing, pre-emphasis, the mask at each row's length, the reflect pad
around each row's own length (indexed, never written out), framing at a
runtime hop over the window support, and the centred Hann of a runtime
``win``; frames at ``t >= 1 + length // hop`` are zero. `spec_db` is the
epilogue: ``[re | im]`` -> magnitude, or an amplitude, then the normalized
dB ``clamp((amp_to_db(x) - ref_db - min_db) / -min_db, 0, 1)`` with the
frame-length mask; the caller passes the two dB levels.

The hop and window length come in ``geom``, a 2-element int32 tensor
``[hop, win]`` on the waves' device, so a rate drawn on the card sets them
without a host round trip. Each wrapper launches its kernel for CUDA tensors
and runs its plain PyTorch version only for CPU tensors. The plain version
frames with `ops/stft.py`: `reflect_pad_ragged`, then `frame_signal` at a
static hop (clean path) or a tensor hop (augmented path).
"""

from __future__ import annotations

import torch

from ..ops.stft import dynamic_hann_window, frame_signal, reflect_pad_ragged
from . import build


def stft_frames_plain(waves, lengths, geom, *, n_fft: int, support: tuple, num_frames: int,
                      clamp: bool, coeff: float, noise=None, mix=None):
    S = waves.shape[1]
    dev = waves.device
    hop, win = geom[0].to(torch.int64), geom[1]
    in_range = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    if noise is not None:
        waves = torch.where(in_range, waves + mix[:, None] * noise, 0.0)
    pre = torch.cat([waves[:, :1], waves[:, 1:] - coeff * waves[:, :-1]], dim=1)
    xp = reflect_pad_ragged(torch.where(in_range, pre, 0.0), lengths, n_fft // 2)
    # A kept frame (t <= length // hop) never reaches past the padded signal,
    # so the static hop's zeros and the tensor hop's clamped start agree on it.
    frames = frame_signal(xp, n_fft, hop if clamp else int(hop), num_frames, support=support)
    off, span = support
    frames = frames * dynamic_hann_window(n_fft, win, dev)[off:off + span]
    t = torch.arange(num_frames, device=dev)
    keep = t[None, :] < (1 + lengths.to(torch.int64) // hop)[:, None]
    return torch.where(keep[:, :, None], frames, 0.0)


def stft_frames(waves, lengths, geom, *, n_fft: int, support: tuple, num_frames: int,
                clamp: bool, coeff: float, noise=None, mix=None):
    """Windowed frames ``(B, num_frames, span)`` of padded waves ``(B, S)``.

    ``lengths``: (B,) int32 valid samples (each > n_fft // 2); ``geom``:
    int32 ``[hop, win]``; ``support``: (offset, span) of the frame rows kept;
    ``clamp``: clamp a frame's start to ``S_pad - n_fft`` (augmented path)
    instead of zero-padding past the end (clean path); ``noise``/``mix``:
    mix ``mix[b] * noise[b]`` into the waves first."""
    if not waves.is_cuda:
        return stft_frames_plain(waves, lengths, geom, n_fft=n_fft, support=support,
                                 num_frames=num_frames, clamp=clamp, coeff=coeff,
                                 noise=noise, mix=mix)
    B, S = waves.shape
    off, span = support
    build.require(waves, (B, S), "stft_frames waves")
    build.require_int(lengths, (B,), "stft_frames lengths")
    build.require_int(geom, (2,), "stft_frames geom")
    if (noise is None) != (mix is None):
        raise ValueError("stft_frames: noise and mix go together")
    if noise is not None:
        build.require(noise, (B, S), "stft_frames noise")
        build.require(mix, (B,), "stft_frames mix")
    if off < 0 or off + span > n_fft:
        raise ValueError(f"stft_frames: support {support} outside a frame of {n_fft}")
    frames = torch.empty((B, num_frames, span), device=waves.device, dtype=torch.float32)
    if frames.numel():
        fn = build.bind("features", "stft_frames_f32", 6, 7, floats=1)
        build.check(fn(waves.data_ptr(), lengths.data_ptr(), geom.data_ptr(),
                       0 if noise is None else noise.data_ptr(),
                       0 if mix is None else mix.data_ptr(), frames.data_ptr(),
                       B, S, num_frames, n_fft, off, span, int(clamp), coeff,
                       build.stream()), "stft_frames")
        stft_frames.launches += 1
    return frames


stft_frames.launches = 0


def spec_db_plain(x, frame_lengths, *, reim: bool, db: bool = True, min_db: float, ref_db: float):
    if reim:
        F_ = x.shape[-1] // 2
        re, im = x[..., :F_], x[..., F_:]
        amp = torch.sqrt(re * re + im * im)
    else:
        amp = x
    if not db:
        return amp, None
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    keep = (t < frame_lengths[:, None])[:, :, None]
    level = 20.0 * torch.log10(torch.clamp(amp, min=1e-5)) - ref_db
    out = torch.clamp((level - min_db) / -min_db, 0.0, 1.0)
    return (amp if reim else None), torch.where(keep, out, 0.0)


def spec_db(x, frame_lengths, *, reim: bool, db: bool = True, min_db: float, ref_db: float):
    """The spectrogram epilogue over ``(B, T, *)``: returns (magnitude, dB).

    ``reim``: ``x`` is ``[re | im]`` (B, T, 2F); the magnitude (B, T, F) is
    returned for the mel GEMM, and the dB output only when ``db``. Otherwise
    ``x`` is an amplitude (B, T, F) and the magnitude slot is None. The dB
    output is ``normalize_db(amp_to_db(amp) - ref_db)`` over the floor
    ``min_db``, zero at ``t >= frame_lengths[b]``."""
    if not x.is_cuda:
        return spec_db_plain(x, frame_lengths, reim=reim, db=db, min_db=min_db, ref_db=ref_db)
    B, T, W = x.shape
    F_ = W // 2 if reim else W
    build.require(x, (B, T, 2 * F_ if reim else F_), "spec_db x")
    build.require_int(frame_lengths, (B,), "spec_db frame_lengths")
    if not reim and not db:
        raise ValueError("spec_db: an amplitude input needs the dB output")
    mag = torch.empty((B, T, F_), device=x.device, dtype=torch.float32) if reim else None
    out = torch.empty((B, T, F_), device=x.device, dtype=torch.float32) if db else None
    if B * T * F_:
        fn = build.bind("features", "spec_db_f32", 4, 4, floats=2)
        build.check(fn(x.data_ptr(), frame_lengths.data_ptr(),
                       0 if mag is None else mag.data_ptr(), 0 if out is None else out.data_ptr(),
                       B, T, F_, int(reim), min_db, ref_db, build.stream()), "spec_db")
        spec_db.launches += 1
    return mag, out


spec_db.launches = 0
