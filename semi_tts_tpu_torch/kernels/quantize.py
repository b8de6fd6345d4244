"""B6 `trim_merge` and `trim_merge_bwd` (`csrc/quantize.cu`): the unpaired
speech cycle's segment trim/merge (`semi_tts_tpu/ops/quantize.py`
`trim_merge_segments`) and its backward, one CTA per batch row
(`trim_merge_plan`: the row's p_code and latent bulk-copied into shared
memory at entry, warp-ballot scans carried across warps and chunks; on
rows too long for shared memory the per-frame ints in a device-memory
scratch and, where not one frame of p_code fits, the argmax taken first
by a kernel over the whole card: any T and C).

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
_HEADER = 512           # bytes: 3 mbarriers, two warp arrays of 32 ints


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _trim_smem(T: int, C: int, D: int, chunk: int, depth: int, stage_latent: bool,
               ints_global: bool = False) -> int:
    return _HEADER + 4 * ((0 if ints_global else 3 * _round4(T)) + depth * _round4(chunk * C + 8)
                          + (_round4(T * D + 8) if stage_latent else 0))


def trim_merge_plan(T: int, C: int, D: int, *, tokens: bool = False) -> dict:
    """`trim_merge`'s launch plan for rows of T frames, C classes and D
    latent channels: ``threads`` a CTA (one CTA a row); ``ints_global``:
    the tokens, slot starts and slot frame counts (T ints each) in a
    device-memory scratch of ``scratch_ints`` a row where they do not fit
    in shared memory; the row's p_code in shared memory as one slot of T
    frames (``depth`` 1) where it fits, else a ring of two slots of
    ``chunk`` frames (``depth`` 2), else, where not one frame fits,
    ``argmax_pass``: a first kernel takes the tokens, a warp a frame over
    the whole card, and the row's kernel reads them as given tokens
    (``depth`` 0, as when the tokens are given); ``stage_latent``: the
    row's latent in shared memory too where it fits beside them, else read
    from L2; and ``smem_bytes``: the header, the ints, the ring and the
    latent. The C dispatch recomputes it. Raises ValueError only for T <
    1."""
    if T < 1:
        raise ValueError(f"trim_merge kernel: T={T} frames, it takes T >= 1")
    limit = build.SMEM_PER_BLOCK
    ints_global = _trim_smem(T, C, D, 0, 0, False) > limit
    smem = lambda chunk, depth, stage=False: _trim_smem(T, C, D, chunk, depth, stage, ints_global)
    chunk, depth = 0, 0
    if tokens:
        pass
    elif smem(T, 1) <= limit:
        chunk, depth = T, 1
    else:
        chunk = ((limit - smem(0, 0)) // 8 - 8) // C
        while chunk > 0 and smem(chunk, 2) > limit:
            chunk -= 1
        depth = 2 if chunk > 0 else 0
        chunk = max(chunk, 0)
    stage = smem(chunk, depth, True) <= limit
    return dict(threads=TRIM_THREADS, chunk=chunk, depth=depth, stage_latent=stage,
                ints_global=ints_global, scratch_ints=3 * _round4(T) if ints_global else 0,
                argmax_pass=not tokens and depth == 0, smem_bytes=smem(chunk, depth, stage))


BWD_THREADS = 256


def trim_merge_bwd_plan(B: int, T: int, D: int, aligned: bool = True) -> dict:
    """`trim_merge_bwd`'s launch plan: ``vec`` floats a load (4 where D % 4
    == 0 and the rows are 16-byte aligned, else 1), ``lanes`` a frame (its
    D / vec loads rounded up to a power of two, at most 32), ``frames`` a
    CTA of `BWD_THREADS` threads and the ``grid`` (frame groups, B). The C
    dispatch checks it."""
    vec = 4 if D % 4 == 0 and aligned else 1
    lanes = 1
    while lanes < -(-D // vec) and lanes < 32:
        lanes *= 2
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
    plan = trim_merge_plan(T, C, D, tokens=tokens is not None)
    dev = latent.device
    out = torch.empty((B, T, D), device=dev, dtype=torch.float32)
    lengths = torch.empty((B,), device=dev, dtype=torch.int32)
    slot = torch.empty((B, T), device=dev, dtype=torch.int32)
    count = torch.empty((B, T), device=dev, dtype=torch.float32)
    if B:
        # scratch: the per-frame ints in device memory; the argmax pass's tokens
        ints, toks = (torch.empty((n,), device=dev, dtype=torch.int32) if on else None
                      for n, on in ((B * plan["scratch_ints"], plan["ints_global"]),
                                    (B * T, plan["argmax_pass"])))
        ptr = lambda t: None if t is None else t.data_ptr()
        fn = build.bind("quantize", "trim_merge_f32", 9, 10)
        build.check(fn(p_ptr, tok_ptr, latent.data_ptr(), out.data_ptr(), lengths.data_ptr(),
                       slot.data_ptr(), count.data_ptr(), ptr(ints), ptr(toks), B, T, C, D,
                       max_frames_per_phn, plan["threads"], plan["chunk"], plan["depth"],
                       int(plan["stage_latent"]), plan["smem_bytes"], build.stream()),
                    "trim_merge")
        trim_merge.launches += 1
    return out, lengths, slot, count


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
trim_merge_bwd.launches = 0
