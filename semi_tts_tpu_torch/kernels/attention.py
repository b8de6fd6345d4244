"""K3 `attention_step`: location features, energies, softmax and context of
one location-sensitive attention step, given the projected query; K9
`attention_step_bwd`: its backward, from the forward's inputs and weights.

The wrappers launch `csrc/attention.cu` for CUDA tensors and run their plain
PyTorch versions only for CPU tensors. `attention_plan` and
`attention_bwd_plan` compute the launch plans (K3: one thread-block cluster
per batch row where the row fits its shared memory, else a cluster per
chunk of positions, its positions split over the cluster's CTAs, the last
cluster of a row combining the chunks: the split route; K9: a CTA per
span of positions and batch row) and name the shapes the kernels take:
any memory length L, any widths A, D >= 1 whose smallest chunk fits.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..utils.flops import counted
from . import build

CLUSTER = 8                 # CTAs per batch row (kCluster in csrc/attention.cu)
THREADS = 256
LOC_TILE = 64               # location-feature rows computed per tile
CONV_L = 4                  # location-feature positions a thread computes together


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _smem_floats(L, Ac, Dc, C, F_, K, tile, stage_memory) -> int:
    """Floats of the CTA's shared memory, region by region as `Layout` in
    csrc/attention.cu lays them out."""
    fs = _round4(F_) + (4 if _round4(F_) % 8 == 0 else 0)  # float4 row stride, odd in float4s
    regions = (L * Ac, L * Dc if stage_memory else 0, CLUSTER * _round4(L), L, L,
               C * (L + K - 1 + CONV_L - 1), tile * fs, Ac * fs, F_ * (C * K + 1), Ac, Ac,
               max(Dc, THREADS))
    return sum(_round4(n) for n in regions)


# The split route's chunks: a cluster of CLUSTER CTAs a chunk, CTA r of it
# ``span`` of the chunk's positions, at most SPLIT_SPAN where the batch's
# chunks then fit in SPLIT_CLUSTERS clusters (one wave of a CTA an SM), else
# at most SPLIT_SPAN_WAVES (whose CTAs fit two an SM: 102,656 bytes of shared
# memory at flagship widths), and what one CTA holds; a row at least
# SPLIT_CLUSTERS // B chunks of at least SPLIT_MIN_SPAN positions a CTA, so
# that a short batch still fills the card. From chip_ablate.py --k3-split's
# sweep at phase 13's shapes (NVIDIA H100 80GB HBM3, 700 W): span 24 took
# 18.40 us at B=2 L=1,334 (16 and 20: 19.05, 21.18), span 16 105.94 us at
# B=16 L=1,500 masked (24: 139.57, the plain version 135.74) and 46.57 at
# B=1 L=8,000 (24: 49.22); 8 or 30 clusters were slower than 15 at B=1.
SPLIT_SPAN = 24
SPLIT_SPAN_WAVES = 16
SPLIT_CLUSTERS = 15
SPLIT_MIN_SPAN = 4


def _cta_smem(n, Ac, Dc, C, F_, K, stage) -> int:
    """Bytes of shared memory a K3 CTA needs for n positions."""
    return 4 * _smem_floats(n, Ac, Dc, C, F_, K, min(n, LOC_TILE) if F_ else 0, stage)


def _split_smem(span, A, D, C, F_, K, stage_mem, lin_rows) -> int:
    """Bytes of shared memory a split-route CTA of ``span`` positions needs
    with ``lin_rows`` rows of loc_lin, region by region as `SplitLayout` in
    csrc/attention.cu lays them out."""
    fs = _round4(F_) + (4 if _round4(F_) % 8 == 0 else 0)
    sr = _round4(span)
    regions = (span * A, span * D if stage_mem else 0, lin_rows * fs if F_ else 0,
               C * (span + K - 1 + CONV_L - 1), span * fs if F_ else 0, F_ * (C * K + 1), A, A,
               sr, sr, (THREADS // 32) * sr, D, THREADS, 4 + 2 * CLUSTER + THREADS // 32)
    return 4 * sum(_round4(n) for n in regions)


def _most(fits) -> int:
    """The largest n in [0, 2**20] with fits(n), which holds up to some n."""
    lo, hi = 0, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def _most_positions(Ac, Dc, C, F_, K, stage) -> int:
    """The most positions one cluster holds (0 if not one)."""
    return _most(lambda n: _cta_smem(n, Ac, Dc, C, F_, K, stage) <= build.SMEM_PER_BLOCK)


@functools.lru_cache(maxsize=64)
def attention_plan(B: int, L: int, A: int, D: int, C: int, F_: int, K: int) -> dict:
    """K3's launch plan. Where one CTA's shared memory holds the row's L
    positions, B clusters of CLUSTER CTAs, one a row (``chunks`` 0): CTA r
    owns the ``a_per_cta`` = ceil(A/CLUSTER) attention columns and the
    ``d_per_cta`` = ceil(D/CLUSTER) context columns from r times those, cut
    at A and D. Any A, D >= 1 is taken by these uneven slices inside the
    kernel (its loops guarded; the last CTAs' slices short or empty), not by
    padding: a pad or slice around the kernel would add launches to every
    decode step, whose launches already bound the decoder. Else the
    split route: ``chunks`` clusters a row, each over ``chunk`` = CLUSTER x
    ``span`` positions, CTA r of it ``span`` of them over every column;
    ``scratch_floats`` of the chunks' partials, which the cluster of the
    last CTA of a row to finish combines. A CTA takes at most SPLIT_SPAN
    positions where the batch's chunks then fit SPLIT_CLUSTERS clusters,
    else at most SPLIT_SPAN_WAVES, and what its shared memory holds; a row
    at least SPLIT_CLUSTERS // B chunks of at least SPLIT_MIN_SPAN positions
    a CTA (the constants' sweep: above). ``memory`` is staged in shared memory when it fits and read
    from L2 otherwise; on the split route each CTA stages loc_lin, whole
    where it fits and else in tiles of ``lin_rows`` rows (0 where F_ = 0).
    F_ = 0 is the location-free attention.
    Raises ValueError when A < 1, D < 1, L < 1, or not one position fits a
    block's shared memory. Cached: the wrapper asks for it on every call; do
    not mutate it."""
    if A < 1 or D < 1:
        raise ValueError(f"attention_step kernel needs A, D >= 1, got A={A}, D={D}")
    if L < 1:
        raise ValueError(f"attention_step kernel needs L >= 1, got L={L}")
    Ac, Dc = -(-A // CLUSTER), -(-D // CLUSTER)
    common = dict(cluster=CLUSTER, threads=THREADS, a_per_cta=Ac, d_per_cta=Dc)
    if _cta_smem(L, Ac, Dc, C, F_, K, False) <= build.SMEM_PER_BLOCK:
        stage = _cta_smem(L, Ac, Dc, C, F_, K, True) <= build.SMEM_PER_BLOCK
        return dict(common, grid=(CLUSTER * B,), smem_bytes=_cta_smem(L, Ac, Dc, C, F_, K, stage),
                    loc_tile=min(L, LOC_TILE) if F_ else 0, stage_memory=stage, lin_rows=0,
                    chunk=L, span=L, chunks=0, scratch_floats=0)
    fits = lambda n, mem, rows: _split_smem(n, A, D, C, F_, K, mem, rows) <= build.SMEM_PER_BLOCK
    most = _most(lambda n: fits(n, False, A if fits(1, False, A) else min(A, 32)))
    if most < 1:
        raise ValueError(f"attention_step kernel: one position needs "
                         f"{_split_smem(1, A, D, C, F_, K, False, False)} bytes of shared memory "
                         f"at A={A}, D={D}, F={F_}; a block may use {build.SMEM_PER_BLOCK}")
    top = min(most, SPLIT_SPAN)
    if B * -(-L // (CLUSTER * top)) > SPLIT_CLUSTERS:  # past one wave: two CTAs an SM
        top = min(most, SPLIT_SPAN_WAVES)
    chunks = max(-(-L // (CLUSTER * top)),
                 min(SPLIT_CLUSTERS // B, -(-L // (CLUSTER * SPLIT_MIN_SPAN))))
    span = -(-L // (CLUSTER * chunks))
    chunks = -(-L // (CLUSTER * span))
    # loc_lin whole where it fits beside the span's positions, else in tiles
    # of as many rows (a multiple of 32) as fit
    rows = 0 if not F_ else A if fits(span, False, A) else 32 * _most(
        lambda m: 32 * m <= A and fits(span, False, 32 * m))
    stage = fits(span, True, rows)
    return dict(common, grid=(CLUSTER * chunks, B),
                smem_bytes=_split_smem(span, A, D, C, F_, K, stage, rows), loc_tile=0,
                stage_memory=stage, lin_rows=rows, chunk=CLUSTER * span, span=span,
                chunks=chunks, scratch_floats=B * chunks * (2 + D))


def attention_step_plain(pq, processed_memory, memory, attn_hist, loc_w, loc_lin, v, mask=None):
    """pq (B, A), processed_memory (B, L, A), memory (B, L, D), attn_hist
    (B, C, L), loc_w (F, C, K) or None, loc_lin (A, F), v (A), mask (B, L)
    bool (True = padded) -> (context (B, D), weights (B, L))."""
    energy_in = pq[:, None, :]
    if loc_w is not None:
        k = loc_w.shape[2]
        loc = F.conv1d(attn_hist, loc_w, padding=(k - 1) // 2)      # (B, F, L)
        energy_in = energy_in + loc.transpose(1, 2) @ loc_lin.T     # (B, L, A)
    energy = torch.tanh(energy_in + processed_memory) @ v           # (B, L)
    if mask is not None:
        energy = energy.masked_fill(mask, float("-inf"))
    weights = torch.softmax(energy, dim=1)
    context = torch.einsum("bl,bld->bd", weights, memory)
    return context, weights


def _step_flops(pq, processed_memory, memory, attn_hist, loc_w, *_, **__):
    """The dot and convolution FLOPs of `semi_tts_tpu.models.attention.
    attention_step` after its query projection: the location conv and its
    linear layer, the energy's product with v and the context."""
    B, L, A = processed_memory.shape
    per = A + memory.shape[2]
    if loc_w is not None:
        n_filt, C, K = loc_w.shape
        per += n_filt * C * K + n_filt * A
    return 2 * B * L * per


@counted(_step_flops)
def attention_step(pq, processed_memory, memory, attn_hist, loc_w, loc_lin, v, mask=None):
    """Counterpart of `semi_tts_tpu.models.attention.attention_step` after its
    query projection; one launch per call on the card."""
    if not pq.is_cuda:
        return attention_step_plain(pq, processed_memory, memory, attn_hist,
                                    loc_w, loc_lin, v, mask)
    B, L, A = processed_memory.shape
    D = memory.shape[2]
    C = attn_hist.shape[1]
    build.require(pq, (B, A), "attention pq")
    build.require(processed_memory, (B, L, A), "attention processed_memory")
    build.require(memory, (B, L, D), "attention memory")
    build.require(attn_hist, (B, C, L), "attention attn_hist")
    build.require(v, (A,), "attention v")
    if loc_w is None:
        n_filt, K, loc_ptr, lin_ptr = 0, 1, None, None
    else:
        n_filt, K = loc_w.shape[0], loc_w.shape[2]
        build.require(loc_w, (n_filt, C, K), "attention loc_w")
        build.require(loc_lin, (A, n_filt), "attention loc_lin")
        loc_ptr, lin_ptr = loc_w.data_ptr(), loc_lin.data_ptr()
    mask_ptr = None
    if mask is not None:
        if not (mask.is_cuda and mask.dtype == torch.bool and mask.is_contiguous()
                and tuple(mask.shape) == (B, L)):
            raise ValueError("attention mask: expected a contiguous CUDA bool tensor (B, L)")
        mask_ptr = mask.data_ptr()  # torch.bool is one byte per element
    plan = attention_plan(B, L, A, D, C, n_filt, K)
    context = torch.empty((B, D), device=pq.device, dtype=torch.float32)
    weights = torch.empty((B, L), device=pq.device, dtype=torch.float32)
    if B == 0:
        return context, weights
    vec = (A % 4 == 0 and D % 4 == 0 and plan["a_per_cta"] % 4 == 0 and plan["d_per_cta"] % 4 == 0
           and processed_memory.data_ptr() % 16 == 0 and memory.data_ptr() % 16 == 0
           and (loc_lin is None or loc_lin.data_ptr() % 16 == 0))
    scratch = (torch.empty((plan["scratch_floats"],), device=pq.device, dtype=torch.float32)
               if plan["chunks"] else None)
    fn = build.bind("attention", "attention_step_f32", 11, 13)
    build.check(fn(pq.data_ptr(), processed_memory.data_ptr(), memory.data_ptr(),
                   attn_hist.data_ptr(), loc_ptr, lin_ptr, v.data_ptr(), mask_ptr,
                   context.data_ptr(), weights.data_ptr(),
                   None if scratch is None else scratch.data_ptr(),
                   B, L, A, D, C, n_filt, K, plan["loc_tile"], int(plan["stage_memory"]),
                   int(vec), plan["chunk"], plan["chunks"], plan["lin_rows"],
                   build.stream()), "attention_step")
    attention_step.launches += 1
    return context, weights


attention_step.launches = 0


SPANS = (4, 8, 12, 16, 20, 24, 28, 32)  # positions a K9 CTA takes (csrc/attention.cu)
SMS = 132                   # H100 SXM
SPAN_COST = 8               # a K9 CTA's fixed work, in positions (chip_ablate.py's span sweep)


def _bwd_smem_floats(P, A, C, F_, K, stage_lin) -> int:
    """Floats of a K9 CTA's shared memory, region by region as `BwdLayout` in
    csrc/attention.cu lays them out."""
    fs = _round4(F_) + (4 if _round4(F_) % 8 == 0 else 0)  # loc_lin's float4 row stride
    ps = P if (P // 4) % 2 else P + 4                       # dpre's row stride
    return (A * fs if stage_lin else 0) + sum(_round4(n) for n in (
        F_ * C * K, C * (P + K - 1), A, A, 12 * THREADS, P, P * A, A * ps,
        _round4(F_) * P, F_ * ps, P * C * K))


def _bwd_part_floats(P, A, C, F_, K) -> int:
    """Floats of one (row, span)'s partials, as `PartLayout` lays them out."""
    return sum(_round4(n) for n in (F_ * C * K, F_ * A, A, A, C * (P + K - 1) if F_ else 0))


@functools.lru_cache(maxsize=64)
def attention_bwd_plan(B: int, L: int, A: int, D: int, C: int, F_: int, K: int) -> dict:
    """K9's launch plan: a CTA of THREADS threads for each (span of ``span``
    positions, batch row), ``spans`` spans a row. The span is the one of
    `SPANS` with the least (CTAs an SM) x (span + SPAN_COST), the smaller on
    a tie, among those whose shared memory fits; where none does, span 4
    with loc_lin read from L2 (``stage_lin`` False). ``part_floats``: the
    buffer of per-(row, span) partials the wrapper allocates for the second
    kernel, which sums them. Its shared memory does not grow with L, so it
    takes any L >= 1 and any A, D >= 1 (a thread a column, guarded, as K3's
    uneven slices); raises ValueError where A < 1, D < 1 or L < 1."""
    if A < 1 or D < 1:
        raise ValueError(f"attention_step_bwd kernel needs A, D >= 1, got A={A}, D={D}")
    if L < 1:
        raise ValueError(f"attention_step_bwd kernel needs L >= 1, got L={L}")
    cost = lambda P: (-(-B * -(-L // P) // SMS) * (P + SPAN_COST), P)
    choices = [(P, True) for P in sorted(SPANS, key=cost)] if F_ else []
    for P, stage_lin in choices + [(SPANS[0], False)]:
        smem = 4 * _bwd_smem_floats(P, A, C, F_, K, stage_lin)
        if smem <= build.SMEM_PER_BLOCK:
            S = -(-L // P)
            return dict(span=P, spans=S, grid=(S, B), threads=THREADS, smem_bytes=smem,
                        stage_lin=stage_lin,
                        part_floats=B * S * _bwd_part_floats(P, A, C, F_, K))
    raise ValueError(f"attention_step_bwd kernel: A={A}, D={D}, F={F_} need {smem} bytes of "
                     f"shared memory at the smallest span; a block may use {build.SMEM_PER_BLOCK}")


def attention_step_bwd_plain(pq, processed_memory, memory, attn_hist, loc_w, loc_lin, v, weights,
                             context, d_context, d_weights):
    """The backward of `attention_step_plain` in closed form, from the
    forward's inputs, its ``weights`` and ``context`` (unused here: the
    kernel uses it) and the cotangents ``d_context`` (B, D) and ``d_weights``
    (B, L) -> (d_pq, d_processed_memory, d_memory, d_attn_hist, d_loc_w,
    d_loc_lin, d_v); the location terms are None when ``loc_w`` is None. A
    masked position has weight 0, so it gets zero gradient without the
    mask."""
    energy_in = pq[:, None, :]
    if loc_w is not None:
        pad = (loc_w.shape[2] - 1) // 2
        loc = F.conv1d(attn_hist, loc_w, padding=pad)               # (B, F, L)
        energy_in = energy_in + loc.transpose(1, 2) @ loc_lin.T
    th = torch.tanh(energy_in + processed_memory)                   # (B, L, A)
    dw = d_weights + torch.einsum("bld,bd->bl", memory, d_context)
    de = weights * (dw - (weights * dw).sum(1, keepdim=True))
    dpre = de[:, :, None] * v * (1.0 - th * th)
    d_memory = weights[:, :, None] * d_context[:, None, :]
    d_v = torch.einsum("bl,bla->a", de, th)
    if loc_w is None:
        return dpre.sum(1), dpre, d_memory, torch.zeros_like(attn_hist), None, None, d_v
    d_loc = (dpre @ loc_lin).transpose(1, 2)                        # (B, F, L)
    return (dpre.sum(1), dpre, d_memory,
            torch.nn.grad.conv1d_input(attn_hist.shape, loc_w, d_loc, padding=pad),
            torch.nn.grad.conv1d_weight(attn_hist, loc_w.shape, d_loc, padding=pad),
            torch.einsum("bla,bfl->af", dpre, loc), d_v)


@counted(lambda *args: 2 * _step_flops(*args))  # the autodiff: both operands' cotangents
def attention_step_bwd(pq, processed_memory, memory, attn_hist, loc_w, loc_lin, v, weights,
                       context, d_context, d_weights):
    """K9: the backward of one attention step (`attention_step_bwd_plain`'s
    outputs), given the forward's ``context`` as K3 returned it; on the card
    one call launches the per-span kernel and the kernel that sums its
    partials."""
    if not pq.is_cuda:
        return attention_step_bwd_plain(pq, processed_memory, memory, attn_hist, loc_w, loc_lin,
                                        v, weights, context, d_context, d_weights)
    B, L, A = processed_memory.shape
    D = memory.shape[2]
    C = attn_hist.shape[1]
    for t, shape, what in ((pq, (B, A), "pq"), (processed_memory, (B, L, A), "processed_memory"),
                           (memory, (B, L, D), "memory"), (attn_hist, (B, C, L), "attn_hist"),
                           (v, (A,), "v"), (weights, (B, L), "weights"),
                           (context, (B, D), "context"), (d_context, (B, D), "d_context"),
                           (d_weights, (B, L), "d_weights")):
        build.require(t, shape, f"attention_step_bwd {what}")
    if loc_w is None:
        n_filt, K = 0, 1
    else:
        n_filt, K = loc_w.shape[0], loc_w.shape[2]
        build.require(loc_w, (n_filt, C, K), "attention_step_bwd loc_w")
        build.require(loc_lin, (A, n_filt), "attention_step_bwd loc_lin")
    plan = attention_bwd_plan(B, L, A, D, C, n_filt, K)
    empty = functools.partial(torch.empty, device=pq.device, dtype=torch.float32)
    d_pq, d_pm, d_mem, d_v = empty((B, A)), empty((B, L, A)), empty((B, L, D)), empty((A,))
    d_hist = torch.zeros_like(attn_hist) if loc_w is None else empty((B, C, L))
    d_lw, d_ll = (empty((n_filt, C, K)), empty((A, n_filt))) if n_filt else (None, None)
    part = empty((plan["part_floats"],))
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = build.bind("attention", "attention_step_bwd_f32", 19, 10)
    build.check(fn(pq.data_ptr(), processed_memory.data_ptr(), memory.data_ptr(),
                   attn_hist.data_ptr(), ptr(loc_w), ptr(loc_lin), v.data_ptr(), weights.data_ptr(),
                   context.data_ptr(), d_context.data_ptr(), d_weights.data_ptr(), d_pq.data_ptr(),
                   d_pm.data_ptr(), d_mem.data_ptr(), None if loc_w is None else d_hist.data_ptr(),
                   ptr(d_lw), ptr(d_ll), d_v.data_ptr(), part.data_ptr(), B, L, A, D, C, n_filt, K,
                   plan["span"], int(plan["stage_lin"]), plan["part_floats"], build.stream()),
                "attention_step_bwd")
    attention_step_bwd.launches += 1
    return d_pq, d_pm, d_mem, d_hist, d_lw, d_ll, d_v


attention_step_bwd.launches = 0
