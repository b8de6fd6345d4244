"""B6 `trim_merge` and `trim_merge_bwd` (`csrc/quantize.cu`): the unpaired
speech cycle's segment trim/merge (`semi_tts_tpu/ops/quantize.py`
`trim_merge_segments`) and its backward. `trim_merge_plan` picks the
route: one CTA a row for short rows that fit its shared memory (the row's
p_code and latent bulk-copied in at entry, warp-ballot scans carried
across warps and chunks), else three launches (the argmax over the whole
card, the scans a CTA a row, the means over the whole card): any T and C.

`trim_merge` takes each frame's argmax token (or the ``tokens`` given),
cuts the frames into segments where the token changes or a run grows past
``max_frames_per_phn`` frames, drops the blank (token 0) segments and
writes each kept segment's mean latent, compacted left and zero-filled to
T. It also returns each frame's output slot (-1 where dropped) and its
segment's frame count, from which `trim_merge_bwd` gathers the gradient
(`trim_merge_bwd_plan`: a group of lanes a frame, float4 where the rows
allow, a programmatic dependent launch).
The wrappers launch the kernels for CUDA tensors and run their plain
PyTorch versions only for CPU tensors.
"""

from __future__ import annotations

import torch

from ..utils.flops import counted, no_dots
from . import build

TRIM_THREADS = 1024
_HEADER = 512           # bytes: 2 mbarriers, two warp arrays of 32 ints
GROUP_THREADS = 256     # the split route's tokens and means kernels, and the backward
TOKEN_LOADS = 8         # the split route's tokens: about this many loads a lane
# the split route from rows of this many frames on: the least T of
# chip_ablate.py --b6-long's sweep (64, 133, 200, ..., 20,000 frames) at
# which the split route beat the row route (0.0060 against 0.0067 ms at B=8;
# the row route 0.0052 against 0.0059 at T=64; NVIDIA H100 80GB HBM3, 700 W)
SPLIT_FRAMES = 133


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _trim_smem(T: int, C: int, D: int, pcode: bool, stage_latent: bool) -> int:
    """The row route's shared memory (csrc/quantize.cu `trim_smem_bytes`):
    the header, the tokens, slot starts and slot counts (T ints each), the
    row's p_code where it is read (T*C floats, 8 of slack) and the staged
    latent (T*D floats, 8 of slack)."""
    return _HEADER + 4 * (3 * _round4(T) + (_round4(T * C + 8) if pcode else 0)
                          + (_round4(T * D + 8) if stage_latent else 0))


def _lanes(loads: int, per: int) -> int:
    """Lanes of a group (`group_lanes`): ``loads`` loads of ``per`` a lane,
    rounded up to a power of two, at least 1, at most 32."""
    lanes = 1
    while lanes * per < loads and lanes < 32:
        lanes *= 2
    return lanes


def trim_merge_plan(T: int, C: int, D: int, *, tokens: bool = False, aligned: bool = True,
                    limit: int = build.SMEM_PER_BLOCK) -> dict:
    """`trim_merge`'s launch plan for rows of T frames, C classes and D
    latent channels within ``limit`` bytes of shared memory a block.
    ``route`` "row" below `SPLIT_FRAMES` frames where a CTA of ``threads``
    holds the row's p_code (none with ``tokens`` given) and its tokens,
    slot starts and slot counts (T ints each) in shared memory,
    ``stage_latent`` the row's latent too where it fits beside them (else
    read from L2), in ``smem_bytes``. Else ``route`` "split", three
    launches: the tokens over the whole card (none with ``tokens``),
    ``tok_lanes`` a frame (about `TOKEN_LOADS`
    loads a lane) of ``tok_vec`` floats a load (4 where C % 4 == 0 and the
    rows are ``aligned``); the scans a CTA of ``threads`` a row, the slot
    starts and counts in a device-memory scratch of
    ``scratch_ints`` a row (``token_ints`` more for the tokens); the means
    over the whole card, ``lanes`` an output row of ``vec`` floats a load
    (4 where D % 4 == 0 and the rows are ``aligned``), ``rows`` a CTA of
    `GROUP_THREADS`. The C dispatch checks it. Raises ValueError only for
    T < 1."""
    if T < 1:
        raise ValueError(f"trim_merge kernel: T={T} frames, it takes T >= 1")
    if T < SPLIT_FRAMES and _trim_smem(T, C, D, not tokens, False) <= limit:
        stage = _trim_smem(T, C, D, not tokens, True) <= limit
        return dict(route="row", threads=TRIM_THREADS, stage_latent=stage,
                    smem_bytes=_trim_smem(T, C, D, not tokens, stage))
    tok_vec = 4 if C % 4 == 0 and aligned else 1
    vec = 4 if D % 4 == 0 and aligned else 1
    lanes = _lanes(D // vec, 1)
    return dict(route="split", threads=TRIM_THREADS, tok_vec=tok_vec,
                tok_lanes=0 if tokens else _lanes(C // tok_vec, TOKEN_LOADS),
                scratch_ints=2 * _round4(T), token_ints=0 if tokens else T, vec=vec, lanes=lanes,
                rows=GROUP_THREADS // lanes)


BWD_THREADS = GROUP_THREADS


def trim_merge_bwd_plan(B: int, T: int, D: int, aligned: bool = True) -> dict:
    """`trim_merge_bwd`'s launch plan: ``vec`` floats a load (4 where D % 4
    == 0 and the rows are 16-byte aligned, else 1), ``lanes`` a frame (its
    D / vec loads rounded up to a power of two, at most 32), ``frames`` a
    CTA of `BWD_THREADS` threads and the ``grid`` (frame groups, B). The C
    dispatch checks it."""
    vec = 4 if D % 4 == 0 and aligned else 1
    lanes = _lanes(-(-D // vec), 1)
    frames = BWD_THREADS // lanes
    return dict(vec=vec, lanes=lanes, frames=frames, threads=BWD_THREADS,
                grid=(-(-T // frames), B))


def _tokens(p_code, tokens):
    return p_code.argmax(-1) if tokens is None else tokens.long()


def trim_merge_plain(p_code, latent, max_frames_per_phn: int, tokens=None):
    """p_code (B, T, C), latent (B, T, D), tokens (B, T) or None -> (trimmed
    (B, T, D), lengths (B,) int32, slot (B, T) int32, count (B, T))."""
    B, T, D = latent.shape
    tok = _tokens(p_code, tokens)
    t = torch.arange(T, device=latent.device)
    change = torch.ones((B, T), dtype=torch.bool, device=latent.device)
    change[:, 1:] = tok[:, 1:] != tok[:, :-1]
    run_start = torch.cummax(torch.where(change, t, 0), dim=1).values
    start = (t - run_start) % (max_frames_per_phn + 1) == 0
    seg = torch.cumsum(start, 1) - 1                                  # segment id of each frame
    kept_before = torch.cumsum(start & (tok != 0), 1)
    lengths = kept_before[:, -1].to(torch.int32)
    slot = torch.where(tok != 0, kept_before - 1, -1)
    ones = torch.ones((B, T), dtype=latent.dtype, device=latent.device)
    seg_cnt = torch.zeros_like(ones).scatter_add_(1, seg, ones)
    seg_sum = torch.zeros_like(latent).scatter_add_(1, seg[..., None].expand(B, T, D), latent)
    seg_mean = seg_sum / seg_cnt.clamp(min=1.0)[..., None]
    count = seg_cnt.gather(1, seg)
    first = start & (tok != 0)                                        # one frame per kept segment
    dest = torch.where(first, slot, T)                                # others into a discard row
    means = seg_mean.gather(1, seg[..., None].expand(B, T, D))
    out = latent.new_zeros((B, T + 1, D)).scatter_(1, dest[..., None].expand(B, T, D), means)
    return out[:, :T], lengths, slot.to(torch.int32), count


def trim_merge_bwd_plain(d_out, slot, count):
    """d_trimmed (B, T, D), slot and count of the forward -> d_latent."""
    B, T, D = d_out.shape
    g = d_out.gather(1, slot.clamp(min=0).long()[..., None].expand(B, T, D))
    return torch.where(slot[..., None] >= 0, g / count[..., None], 0.0)


@counted(no_dots)
def trim_merge(p_code, latent, max_frames_per_phn: int, tokens=None):
    """`trim_merge_plain`'s outputs; one launch per call on the card."""
    if not latent.is_cuda:
        return trim_merge_plain(p_code, latent, max_frames_per_phn, tokens)
    B, T, D = latent.shape
    build.require(latent, (B, T, D), "trim_merge latent")
    if tokens is None:
        build.require(p_code, (B, T, p_code.shape[-1]), "trim_merge p_code")
        C, p_ptr, tok_ptr = p_code.shape[-1], p_code.data_ptr(), None
    else:
        build.require_int(tokens, (B, T), "trim_merge tokens")
        C, p_ptr, tok_ptr = 1, None, tokens.data_ptr()
    if max_frames_per_phn < 0:
        raise ValueError(f"trim_merge: max_frames_per_phn must be >= 0, got {max_frames_per_phn}")
    p_aligned = tokens is not None or p_code.data_ptr() % 16 == 0
    dev = latent.device
    out = torch.empty((B, T, D), device=dev, dtype=torch.float32)
    lengths = torch.empty((B,), device=dev, dtype=torch.int32)
    slot = torch.empty((B, T), device=dev, dtype=torch.int32)
    count = torch.empty((B, T), device=dev, dtype=torch.float32)
    plan = trim_merge_plan(T, C, D, tokens=tokens is not None,
                           aligned=p_aligned and (latent.data_ptr() | out.data_ptr()) % 16 == 0)
    if B:
        ptrs = (p_ptr, tok_ptr, latent.data_ptr(), out.data_ptr(), lengths.data_ptr(),
                slot.data_ptr(), count.data_ptr())
        if plan["route"] == "row":
            fn = build.bind("quantize", "trim_merge_f32", 7, 8)
            build.check(fn(*ptrs, B, T, C, D, max_frames_per_phn, plan["threads"],
                           int(plan["stage_latent"]), plan["smem_bytes"], build.stream()),
                        "trim_merge")
        else:
            # scratch: the tokens kernel's tokens; the slot starts and counts
            toks = (torch.empty((B * plan["token_ints"],), device=dev, dtype=torch.int32)
                    if plan["token_ints"] else None)
            ints = torch.empty((B * plan["scratch_ints"],), device=dev, dtype=torch.int32)
            fn = build.bind("quantize", "trim_merge_split_f32", 9, 9)
            build.check(fn(*ptrs, None if toks is None else toks.data_ptr(), ints.data_ptr(), B, T,
                           C, D, max_frames_per_phn, plan["tok_vec"], plan["tok_lanes"],
                           plan["vec"], plan["lanes"], build.stream()), "trim_merge")
        trim_merge.launches += 1
    return out, lengths, slot, count


def trim_merge_tokens(p_code):
    """The split route's tokens kernel alone (for measuring it beside
    ``torch.argmax``): p_code (B, T, C) on the card -> its argmax (B, T)
    int32, the first maximum, NaN the largest; one launch a call."""
    B, T, C = p_code.shape
    build.require(p_code, (B, T, C), "trim_merge_tokens p_code")
    plan = trim_merge_plan(T, C, 1, aligned=p_code.data_ptr() % 16 == 0, limit=0)
    toks = torch.empty((B, T), device=p_code.device, dtype=torch.int32)
    if toks.numel():
        fn = build.bind("quantize", "trim_merge_tokens_f32", 2, 5)
        build.check(fn(p_code.data_ptr(), toks.data_ptr(), B, T, C, plan["tok_vec"],
                       plan["tok_lanes"], build.stream()), "trim_merge_tokens")
        trim_merge_tokens.launches += 1
    return toks


@counted(no_dots)
def trim_merge_bwd(d_out, slot, count):
    """`trim_merge_bwd_plain`; one launch per call on the card."""
    if not d_out.is_cuda:
        return trim_merge_bwd_plain(d_out, slot, count)
    B, T, D = d_out.shape
    build.require(d_out, (B, T, D), "trim_merge_bwd d_out")
    build.require_int(slot, (B, T), "trim_merge_bwd slot")
    build.require(count, (B, T), "trim_merge_bwd count")
    d_latent = torch.empty_like(d_out)
    if d_out.numel():
        plan = trim_merge_bwd_plan(B, T, D, (d_out.data_ptr() | d_latent.data_ptr()) % 16 == 0)
        fn = build.bind("quantize", "trim_merge_bwd_f32", 4, 5)
        build.check(fn(d_out.data_ptr(), slot.data_ptr(), count.data_ptr(), d_latent.data_ptr(),
                       B, T, D, plan["vec"], plan["lanes"], build.stream()), "trim_merge_bwd")
        trim_merge_bwd.launches += 1
    return d_latent


trim_merge.launches = 0
trim_merge_tokens.launches = 0
trim_merge_bwd.launches = 0
