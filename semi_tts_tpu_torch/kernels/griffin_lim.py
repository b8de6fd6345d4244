"""K4: the per-round glue of Griffin-Lim around the two DFT GEMMs.

`gl_project` is the phase projection on a packed (re | im) spectrum;
`gl_ola_frame` turns inverse-GEMM frames into the next round's forward-GEMM
frames (overlap-add, envelope divide, trim, reflect pad, framing), or into
the signal on the last round. Each wrapper launches `csrc/griffin_lim.cu`
for CUDA tensors and runs its plain PyTorch version only for CPU tensors.
`ola_plan` cuts `gl_ola_frame`'s output frames into tiles and gives each
tile's segment of the signal, as the kernel computes them.
"""

from __future__ import annotations

import functools

import torch

from ..ops.stft import frame_reflect, overlap_add, trimmed_envelope, window_support
from ..utils.flops import counted, no_dots
from . import build

OLA_TILE = 8                # gl_ola_frame: output frames per CTA (chip_smoke ms_by_tile)


def _reflect(x: int, S: int) -> int:
    """Index into a signal of S samples of position x of its reflect-padded form."""
    x = -x if x < 0 else x
    return 2 * (S - 1) - x if x >= S else x


@functools.lru_cache(maxsize=64)
def ola_plan(T: int, span: int, hop: int, off: int, half: int, tile: int | None = None) -> dict:
    """`gl_ola_frame`'s tiles for T frames of ``span`` samples at ``hop``,
    window offset ``off`` and reflect padding ``half`` (n_fft // 2).

    Tile k makes output frames [t0, t1) = [k*tile, min(T, (k+1)*tile)).
    They read the signal samples [seg_lo, seg_hi] (reflected at both ends),
    whose overlap-add sums come from the inverse frames [f_lo, f_hi]. On the
    last round the tile writes the signal samples [sig_lo, sig_hi) itself.
    ``smem_bytes`` holds the largest segment. Raises ValueError when the
    signal is too short to reflect-pad by ``half``. Cached: the wrapper asks
    for it on every call; do not mutate it."""
    S = hop * (T - 1)
    if S <= half:
        raise ValueError(f"reflect padding by {half} needs more than {half} samples, got {S}")
    tile = OLA_TILE if tile is None else tile
    if tile < 1:
        raise ValueError(f"gl_ola_frame tile must be >= 1, got {tile}")
    tiles = []
    for t0 in range(0, T, tile):
        t1 = min(T, t0 + tile)
        x_lo = t0 * hop + off - half                    # unreflected positions read
        x_hi = (t1 - 1) * hop + off + span - 1 - half
        a, b = _reflect(x_lo, S), _reflect(x_hi, S)
        seg_lo = 0 if x_lo <= 0 <= x_hi else min(a, b)
        seg_hi = S - 1 if x_lo <= S - 1 <= x_hi else max(a, b)
        f_lo = max(0, -(-(seg_lo + half - off - span + 1) // hop))
        f_hi = min(T - 1, (seg_hi + half - off) // hop)
        tiles.append(dict(t0=t0, t1=t1, seg_lo=seg_lo, seg_hi=seg_hi, f_lo=f_lo, f_hi=f_hi,
                          sig_lo=t0 * hop, sig_hi=min(t1 * hop, S)))
    seg_max = max(t["seg_hi"] - t["seg_lo"] + 1 for t in tiles)
    return dict(tile=tile, tiles=tiles, grid_x=len(tiles), smem_bytes=4 * seg_max)


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


@counted(no_dots)
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


@counted(no_dots)
def gl_ola_frame(frames, *, n_fft: int, hop: int, win_length: int, emit_signal: bool,
                 tile: int | None = None):
    """istft tail + next stft head in one pass; one launch on the card.
    ``tile`` overrides the output frames per CTA (for measuring)."""
    if not frames.is_cuda:
        return gl_ola_frame_plain(frames, n_fft=n_fft, hop=hop, win_length=win_length,
                                  emit_signal=emit_signal)
    B, T, span = frames.shape
    off, want_span = window_support(n_fft, win_length)
    build.require(frames, (B, T, want_span), "gl_ola_frame frames")
    S = hop * (T - 1)
    plan = ola_plan(T, span, hop, off, n_fft // 2, tile)
    if not emit_signal and plan["smem_bytes"] > build.SMEM_PER_BLOCK:
        raise ValueError(f"gl_ola_frame: a tile of {plan['tile']} frames needs "
                         f"{plan['smem_bytes']} bytes of shared memory; a block may use "
                         f"{build.SMEM_PER_BLOCK}")
    env = trimmed_envelope(n_fft, hop, win_length, T, frames.device)
    shape = (B, S) if emit_signal else (B, T, span)
    out = torch.empty(shape, device=frames.device, dtype=torch.float32)
    if B == 0:
        return out
    fn = build.bind("griffin_lim", "gl_ola_frame_f32", 3, 9)
    build.check(fn(frames.data_ptr(), env.data_ptr(), out.data_ptr(), B, T, span, hop, off,
                   n_fft // 2, int(emit_signal), plan["tile"],
                   0 if emit_signal else plan["smem_bytes"], build.stream()), "gl_ola_frame")
    gl_ola_frame.launches += 1
    return out


gl_ola_frame.launches = 0
