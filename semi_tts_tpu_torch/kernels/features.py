"""K5: the featurizer glue around the DFT and mel GEMMs (`csrc/features.cu`).

`stft_frames` takes padded waves to windowed frames in one pass, a CTA a
tile of consecutive frames whose samples it stages once: optional
noise mixing, pre-emphasis, the mask at each row's length, the reflect pad
around each row's own length (indexed, never written out), framing at a
runtime hop over the window support, and the centred Hann of a runtime
``win``; frames at ``t >= 1 + length // hop`` are zero. `spec_db` is the
epilogue: ``[re | im]`` -> magnitude, or an amplitude, then the normalized
dB ``clamp((amp_to_db(x) - ref_db - min_db) / -min_db, 0, 1)`` with the
frame-length mask; the caller passes the two dB levels.

The hop and window length come in ``geom``, a 2-element int32 tensor
``[hop, win]`` on the waves' device, so a rate drawn on the card sets them
without a host round trip; ``max_hop``, a host-side bound on that hop,
sizes the kernel's shared memory (`frames_plan`), and a hop past it traps
on the device. Each wrapper launches its kernel for CUDA tensors and runs
its plain PyTorch version only for CPU tensors. The plain version frames
with `ops/stft.py`: `reflect_pad_ragged`, then `frame_signal` at a static
hop (clean path) or a tensor hop (augmented path).
"""

from __future__ import annotations

import functools

import torch

from ..ops.stft import dynamic_hann_window, frame_signal, reflect_pad_ragged
from ..utils.flops import counted, no_dots
from . import build

FRAMES_TILES = range(2, 9)  # frames a CTA of stft_frames that its plan picks from
FRAMES_THREADS = 256


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def frames_plan(B: int, T: int, span: int, max_hop: int, *, noise: bool, sms: int = 132,
                tile: int | None = None) -> dict:
    """`stft_frames`' launch plan: a CTA a tile of ``tile`` consecutive
    frames of one row, ``grid`` = B * ceil(T / tile) CTAs (no limit on
    B * T), ``threads`` a CTA, and ``smem_bytes`` of shared memory: the
    window row (span), the tile's padded signal (W = (tile - 1) * max_hop
    + span positions), then the staged waves (and noise: W + 8 samples
    each, one before the first and the 16-byte alignment shift). The C
    dispatch recomputes it.

    ``tile`` (unless given) is the one of `FRAMES_TILES` that gives the
    busiest of ``sms`` SMs the least work, ceil(grid / sms) * (tile + 1):
    its CTAs' frames and one frame's worth for each CTA's own window and
    staging; the largest on a tie. That is 6 at the flagship augmented
    shape (8, 267) and 8 at the clean one (8, 241). Raises ValueError past
    the card's shared memory."""
    def smem_of(G):
        W = (G - 1) * max_hop + span
        return 4 * (_round4(span) + _round4(W) + (2 if noise else 1) * _round4(W + 8))

    if max_hop < 1 or span < 1 or (tile is not None and tile < 1):
        raise ValueError(f"stft_frames plan: tile {tile}, max_hop {max_hop}, span {span}")
    if tile is None:
        fits = [G for G in FRAMES_TILES if smem_of(G) <= build.SMEM_PER_BLOCK] or [1]
        tile = min(fits, key=lambda G: (-(-B * -(-T // G) // sms) * (G + 1), -G))
    smem = smem_of(tile)
    if smem > build.SMEM_PER_BLOCK:
        raise ValueError(f"stft_frames: a tile of {tile} frames of {span} at hop <= {max_hop} "
                         f"needs {smem} bytes of shared memory, past {build.SMEM_PER_BLOCK}")
    tiles = -(-T // tile)
    return dict(tile=tile, threads=FRAMES_THREADS, smem_bytes=smem, tiles_per_row=tiles,
                grid=B * tiles, staged=(tile - 1) * max_hop + span)


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


@counted(no_dots)
def stft_frames(waves, lengths, geom, *, n_fft: int, support: tuple, num_frames: int,
                clamp: bool, coeff: float, noise=None, mix=None, max_hop: int | None = None,
                tile: int | None = None):
    """Windowed frames ``(B, num_frames, span)`` of padded waves ``(B, S)``.

    ``lengths``: (B,) int32 valid samples (each > n_fft // 2, at most S);
    ``geom``: int32 ``[hop, win]``; ``support``: (offset, span) of the frame
    rows kept; ``clamp``: clamp a frame's start to ``S_pad - n_fft``
    (augmented path) instead of zero-padding past the end (clean path): a
    kept frame never reaches either; ``noise``/``mix``: mix ``mix[b] *
    noise[b]`` into the waves first. On the card ``max_hop`` (an upper
    bound on ``geom[0]``, the hop at the highest stretch rate) is required:
    it sizes the kernel's staging buffers; ``tile``: frames a CTA in place
    of `frames_plan`'s."""
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
    if max_hop is None:
        raise ValueError("stft_frames: the kernel needs max_hop, an upper bound on geom[0]")
    frames = torch.empty((B, num_frames, span), device=waves.device, dtype=torch.float32)
    if frames.numel():
        plan = frames_plan(B, num_frames, span, max_hop, noise=noise is not None,
                           sms=_sm_count(waves.device.index), tile=tile)
        fn = build.bind("features", "stft_frames_f32", 6, 10, floats=1)
        build.check(fn(waves.data_ptr(), lengths.data_ptr(), geom.data_ptr(),
                       0 if noise is None else noise.data_ptr(),
                       0 if mix is None else mix.data_ptr(), frames.data_ptr(),
                       B, S, num_frames, n_fft, off, span, max_hop, plan["tile"],
                       plan["threads"], plan["smem_bytes"], coeff, build.stream()), "stft_frames")
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


@counted(no_dots)
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
