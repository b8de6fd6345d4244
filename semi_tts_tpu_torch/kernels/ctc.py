"""K6: CTC over the log-semiring lattice (`csrc/ctc.cu`), a CTA of chain
warps for each utterance (past 1,024 states a cluster of them, past a
cluster's a chain of clusters).

`ctc_alpha` is the forward recursion: alphas (T, B, S) and the negative log
likelihood (B,), S = 2U + 1. `ctc_beta_grad` runs the backward recursion and
turns the occupancies ``exp(min(alpha + beta + nll, 0))`` into the gradient
of ``sum_b g[b] * nll[b]`` with respect to the log-probabilities, (B, T, C),
in one kernel. Both reproduce `semi_tts_tpu/ops/ctc.py` edge for edge: the
``NEG_INF`` sentinel and the ``1e-37`` clamp of the three-way log-add, rows
frozen past their input length, target length 0, T = 1, and an impossible
alignment (nll ~ 1e30) with a zero gradient. Each wrapper launches its
kernel for CUDA tensors and runs its plain PyTorch version only for CPU
tensors.

What bounds K6 on the card is the latency of its chain: T dependent steps,
each a three-way log-add (three accurate ``expf``, a ``logf``) per state,
over ~1 MB of data; the log-adds alone take ~0.13 us a step on the card
(`chip_ablate.py`, "the log-add alone"). So a row's states are
spread a state a thread over `ctc_plan`'s ``chain_warps`` warps (two states
a thread past 512), which exchange their neighbours through the lattice of
the last two steps in shared memory under one named barrier a step, and
everything else is kept off the step: the emissions (and, backward, the
alphas) are gathered per state, S values a step and not C, in chunks of
`CHUNK` steps (backward `CHUNK` // K) loaded a chunk ahead, and the
backward's log occupancies go through a ring of `DEPTH` chunks to
`CONSUMER_WARPS` more warps that take their exp and sum them into the
gradient: a warp a block of 32 of the valid states sorted by (class, s), a
lane a state, sums each segment of at most `SEG` states of one class by
shuffles in a fixed order at each of the chunk's steps; then a thread a
class and a step adds its segments' sums in order of s (no scratch in
device memory, no second launch, no atomics). K states a lane, K in
`STATES_PER_LANE`, take up to 1,024 states; past that, the cluster route
(``lattice`` "cluster" in `ctc_plan`): a
thread-block cluster of ``cluster`` CTAs a row, each running the same chain
on its slice of the row's states at 2, 4 or 8 states a lane
(`CLUSTER_STATES_PER_LANE`), the slices' edge states handed between
neighbouring CTAs through a ring of `EDGE_RING` slots in shared memory (no
cluster barrier a step), the forward's alphas stored by a copy warp from the
lattice at 4 and 8 states a lane, the backward's alphas brought into a ring
beside the occupancies by asynchronous copies, each CTA's class sums added
in rank order into the gradient at the end. Past a cluster's states, the
chained route (``lattice`` "chain"): ``clusters`` Q clusters of P CTAs a
row at `CHAIN_K` states a lane, each the cluster route's CTAs on its
slices, taken in the order of tickets the clusters draw as they start
(`chain_ticket`: forward the clusters of every row's first slice first,
backward the last first), so that a cluster waits only on one that runs or
has run and the grid may run in waves; consecutive clusters of a row hand
on their edge through device memory a step (a link with a flag released
every `LINK_EVERY` steps), a link warp of the receiving CTA copying it into
an edge ring; a cluster wholly past the row's valid states (`chain_live`)
runs no chain; the row's last cluster adds the CTAs' class sums in slice
order. Its ticket counter, per-row counts and links' flags are each call's
own scratch, zeroed by the wrapper. Any S >= 1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.flops import counted, no_dots
from . import build

NEG_INF = -1e30
STATES_PER_LANE = (1, 2)  # the shared-memory lattice's instantiations
MAX_CHAIN_WARPS = 16  # warps that carry a row's chain
# 1,024: the shared-memory lattice's states; past them the cluster route, which
# beats this route at 4 and 8 states a lane (retired) over their whole band,
# 1,025-4,096 states, at B = 2, 8 and 16 (chip_ablate.py --ctc-long's sweep,
# NVIDIA H100 80GB HBM3, 700 W: at B=16 S=1,025 0.2425 against 0.4645 ms
# forward, 0.33 against 0.7116 backward; at S=513 this route is faster)
MAX_STATES = 32 * STATES_PER_LANE[-1] * MAX_CHAIN_WARPS
CHUNK = 8             # values a register chunk holds a state: min(CHUNK, 16 // K) steps
                      # forward, CHUNK // K backward (csrc/ctc.cu kChunk)
DEPTH = 4             # occupancy ring slots, chunks (csrc/ctc.cu kDepth)
SEG = 8               # sorted states a class-sum segment adds at most (csrc/ctc.cu kSeg)
CONSUMER_WARPS = 8    # ctc_beta_grad's class-sum warps beside the chain's
CLUSTER_STATES_PER_LANE = (2, 4, 8)  # the cluster route's instantiations
MAX_CLUSTER = 16      # its CTAs a row at most (csrc/ctc.cu kMaxCluster)
MAX_CLUSTER_WARPS = 12  # its chain warps a CTA at most (kMaxClusterWarps)
PORTABLE_CLUSTER = 8  # past this, a non-portable cluster (kPortableCluster)
EDGE_RING = 8         # edge slots between neighbouring CTAs (kEdgeRing)
EDGE_BYTES = 28 * EDGE_RING  # their mbarriers, slots and acknowledgements (kEdgeBytes)
LINK_BYTES = EDGE_BYTES + 16  # the chained route's link ring and ticket word (kLinkBytes)
LINK_EVERY = 8        # steps between the link's flag releases (kLinkEvery)
# the chained route's states a lane (kChainK): chip_ablate.py --ctc-long
# --wide's sweep at S = 49,153, T = 700, B = 2, 8, 16 (NVIDIA H100 80GB HBM3,
# 700 W) found 2 fastest, or within 18% of the fastest (8, at B = 16 with
# targets of all U labels: every cluster live), and 4 and 8 up to 3x slower
# with the rows' targets (B=2: 2.84 ms forward + backward at 8 against 0.92)
CHAIN_K = 2


def _lattice_floats(K: int, W: int) -> int:
    """Floats of the lattice of the last two steps, with four guard cells each."""
    return 2 * (32 * K * W + 4)


def _ring_floats(W: int) -> int:
    """Floats of a ring of `DEPTH` chunks of a value a state a step: the
    occupancies' (and, on the cluster route, the alphas')."""
    return 32 * W * DEPTH * CHUNK


def _alpha_smem(K: int, W: int) -> int:
    """ctc_alpha's shared bytes: the lattice."""
    return 4 * _lattice_floats(K, W)


def _beta_smem(K: int, W: int) -> int:
    """ctc_beta_grad's shared bytes: the occupancy ring slots' mbarriers and
    the count of class runs, the lattice, the occupancy ring, the class
    sums' four lists and a chunk's segment sums (first the sort's keys, 8
    bytes each, 32 K W rounded up to a power of two: more than the sums at
    K = 4 and 8)."""
    part = max(32 * W * CHUNK, 2 * (1 << (32 * K * W - 1).bit_length()))
    return 16 * DEPTH + 16 + 4 * (_lattice_floats(K, W) + 32 * W * DEPTH * CHUNK + part
                                  + 4 * 32 * K * W)


def _shared_plan(B: int, S: int) -> dict:
    """The shared-memory lattice's plan, S <= `MAX_STATES`."""
    K = next(k for k in STATES_PER_LANE if S <= 32 * k * MAX_CHAIN_WARPS)
    W = -(-S // (32 * K))
    return dict(lattice="shared", states_per_lane=K, chain_warps=W, chunk=min(CHUNK, 16 // K),
                beta_chunk=CHUNK // K, grid=(B,), alpha_threads=32 * W,
                beta_threads=32 * (W + CONSUMER_WARPS), alpha_smem_bytes=_alpha_smem(K, W),
                beta_smem_bytes=_beta_smem(K, W))


def _cluster_plan(B: int, S: int, max_cluster: int) -> dict | None:
    """The cluster lattice's plan (None past its states): the fewest states
    a lane of `CLUSTER_STATES_PER_LANE` whose `MAX_CLUSTER_WARPS` warps hold
    S in ``max_cluster`` CTAs, the fewest warps that do, the fewest CTAs."""
    for K in CLUSTER_STATES_PER_LANE:
        W = -(-S // (max_cluster * 32 * K))
        if W <= MAX_CLUSTER_WARPS:
            P = -(-S // (32 * K * W))
            return dict(lattice="cluster", states_per_lane=K, chain_warps=W, cluster=P,
                        non_portable=P > PORTABLE_CLUSTER, chunk=min(CHUNK, 16 // K),
                        beta_chunk=CHUNK // K, grid=(B * P,),
                        alpha_threads=32 * (W + (K >= 4)),  # a copy warp at 4 and 8
                        beta_threads=32 * (W + CONSUMER_WARPS),
                        alpha_smem_bytes=_alpha_smem(K, W) + EDGE_BYTES,
                        beta_smem_bytes=_beta_smem(K, W) + 4 * _ring_floats(W) + EDGE_BYTES)
    return None


def _chain_plan(B: int, S: int, max_cluster: int) -> dict:
    """The chained route's plan at `CHAIN_K` states a lane: the fewest
    slices of at most `MAX_CLUSTER_WARPS` warps that hold S, in the fewest
    ``clusters`` Q of at most ``max_cluster`` CTAs, P = ceil(slices / Q)
    CTAs a cluster and the fewest warps W that hold S in Q P slices. Every
    cluster holds some of the S states; the last cluster's top CTAs may hold
    none (they run as the CTAs past a row's valid states do). Scratch: the
    links (``link_floats``), each CTA's class sums (``partial_floats``
    rows of (T, C)) and the ticket counter, per-row counts and link flags
    (``sync_ints``)."""
    K = CHAIN_K
    slices = -(-S // (32 * K * MAX_CLUSTER_WARPS))
    Q = -(-slices // max_cluster)
    P = -(-slices // Q)
    W = -(-S // (Q * P * 32 * K))
    return dict(lattice="chain", states_per_lane=K, chain_warps=W, cluster=P, clusters=Q,
                slice_states=32 * K * W, non_portable=P > PORTABLE_CLUSTER,
                chunk=min(CHUNK, 16 // K), beta_chunk=CHUNK // K, grid=(B * Q * P,),
                alpha_threads=32 * (W + 1),  # a link warp beside the chain's
                beta_threads=32 * (W + CONSUMER_WARPS + 1),
                alpha_smem_bytes=_alpha_smem(K, W) + EDGE_BYTES + LINK_BYTES,
                beta_smem_bytes=(_beta_smem(K, W) + 4 * _ring_floats(W) + EDGE_BYTES
                                 + LINK_BYTES),
                link_floats=2 * B * (Q - 1), partial_floats=B * Q * P, sync_ints=1 + B * Q)


def chain_ticket(i: int, B: int, Q: int, backward: bool = False) -> tuple:
    """(cluster q of its row, row b) that the chained route's cluster with
    ticket i runs (csrc/ctc.cu `alpha_chain`, `beta_grad`): forward every
    row's cluster 0 first, then their clusters 1, ...; backward the clusters
    in reverse order. A cluster waits only on its row's cluster below
    (forward; backward: above), which holds a lower ticket."""
    q, b = divmod(i, B)
    return (Q - 1 - q if backward else q), b


def chain_live(target_length: int, plan: dict) -> int:
    """The chained route's clusters of a row that hold some of its 2 tl + 1
    valid states; the rest run no chain (forward: write -inf alphas)."""
    per = plan["cluster"] * plan["slice_states"]
    return -(-(2 * target_length + 1) // per)


def ctc_plan(B: int, T: int, S: int, max_cluster: int = MAX_CLUSTER) -> dict:
    """K6's launch plan for B rows of T steps and S lattice states. Up to
    `MAX_STATES` (``lattice`` "shared"): a CTA a row, whose
    ``chain_warps`` warps carry the chain with ``states_per_lane`` states a
    lane (the fewest of `STATES_PER_LANE` that hold S in `MAX_CHAIN_WARPS`
    warps: one up to 512 states, two to 1,024) and, in ctc_beta_grad,
    `CONSUMER_WARPS` more sum the gradient from a ring of `DEPTH` chunks. A
    register chunk holds ``chunk`` = min(`CHUNK`, 16 // K) steps, backward
    ``beta_chunk`` = `CHUNK` // K (a ring chunk too). Nothing depends on T or
    C. Past it (``lattice`` "cluster"): the same CTAs, a ``cluster`` of P
    of them a row (``grid`` B P), each holding a slice of 32 K W states, K
    the fewest of `CLUSTER_STATES_PER_LANE` (2, then 4, then 8 states a
    lane) whose `MAX_CLUSTER_WARPS` warps hold S in ``max_cluster`` CTAs
    (the most the card fits in a cluster, `max_cluster` on the card; past
    `PORTABLE_CLUSTER` ``non_portable``), the fewest warps that do, and P
    the fewest slices that hold S, so none is empty. Past ``max_cluster`` x
    3,072 states (49,152 at 16 CTAs, a row of more than 24,575 labels) the
    chained route (``lattice`` "chain", `_chain_plan`): ``clusters`` Q
    clusters of P CTAs a row at `CHAIN_K` states a lane, with no upper
    limit on S. Raises ValueError for S < 1."""
    if S < 1:
        raise ValueError(f"ctc kernels: {S} lattice states, they take S >= 1")
    if S <= MAX_STATES:
        return _shared_plan(B, S)
    plan = _cluster_plan(B, S, max_cluster)
    if plan is not None:
        return plan
    return _chain_plan(B, S, max_cluster)


@functools.lru_cache(maxsize=None)
def max_cluster() -> int:
    """The most CTAs a row's cluster may take on the current card:
    `MAX_CLUSTER` where ``cudaOccupancyMaxActiveClusters`` fits one cluster
    of that many of the cluster route's largest CTAs (`MAX_CLUSTER_WARPS`
    warps at each of `CLUSTER_STATES_PER_LANE`; the chained route's, with
    its link warp, at `CHAIN_K`), forward and backward, else
    `PORTABLE_CLUSTER`."""
    lib = build.load("ctc")
    fits = True
    for name, ks in (("ctc_cluster_max_clusters", CLUSTER_STATES_PER_LANE),
                     ("ctc_chain_max_clusters", (CHAIN_K,))):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_int
        fits = fits and all(fn(K, MAX_CLUSTER_WARPS, MAX_CLUSTER, bwd) >= 1
                            for K in ks for bwd in (0, 1))
    return MAX_CLUSTER if fits else PORTABLE_CLUSTER


@functools.lru_cache(maxsize=None)
def chain_fits(W: int, P: int) -> int:
    """How many clusters of the chained route at W chain warps and P CTAs,
    forward and backward alike, the current card runs at once (the route
    needs none at once: its B Q clusters run in ceil(B Q / this) waves)."""
    fn = build.load("ctc").ctc_chain_max_clusters
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    n = min(fn(CHAIN_K, W, P, 0), fn(CHAIN_K, W, P, 1))
    if n < 1:
        raise RuntimeError(f"ctc_chain_max_clusters({CHAIN_K}, {W}, {P}): {n}")
    return n


def _logaddexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    dead = m <= NEG_INF / 2
    m_safe = torch.where(dead, 0.0, m)
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe) + torch.exp(c - m_safe)
    out = m_safe + torch.log(torch.clamp(s, min=1e-37))
    return torch.where(dead, NEG_INF, out)


def _logaddexp(a, b):
    m = torch.maximum(a, b)
    return m + torch.log1p(torch.exp(-torch.abs(a - b)))


def _lattice(targets, target_lengths, blank: int):
    """Extended labels z (B, S), the skip mask (into odd states whose label
    differs from the one two back) and the valid-state mask."""
    B, U = targets.shape
    S = 2 * U + 1
    z = torch.full((B, S), blank, dtype=targets.dtype, device=targets.device)
    z[:, 1::2] = targets
    s = torch.arange(S, device=targets.device)
    z2 = torch.roll(z, 2, dims=1)
    can_skip = (s % 2 == 1)[None, :] & (z != z2) & (s >= 2)[None, :]
    valid = s[None, :] < (2 * target_lengths[:, None] + 1)
    return z, can_skip, valid


def _neg(shape, like):
    return torch.full(shape, NEG_INF, dtype=like.dtype, device=like.device)


def ctc_alpha_plain(log_probs, targets, input_lengths, target_lengths, blank: int = 0):
    B, T, C = log_probs.shape
    z, can_skip, valid = _lattice(targets.long(), target_lengths.long(), blank)
    S = z.shape[1]
    lp0 = log_probs[:, 0, :]
    alpha = _neg((B, S), log_probs)
    alpha[:, 0] = lp0[:, blank]
    if S > 1:
        alpha[:, 1] = torch.where(target_lengths > 0, lp0.gather(1, z[:, 1:2])[:, 0], NEG_INF)
    alpha = torch.where(valid, alpha, NEG_INF)
    alphas = [alpha]
    for t in range(1, T):
        a1 = torch.cat([_neg((B, 1), alpha), alpha[:, :-1]], 1)
        a2 = torch.cat([_neg((B, 2), alpha), alpha[:, :-2]], 1)[:, :S]
        a2 = torch.where(can_skip, a2, NEG_INF)
        new = _logaddexp3(alpha, a1, a2) + log_probs[:, t, :].gather(1, z)
        new = torch.where(valid, new, NEG_INF)
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
        alphas.append(alpha)
    end = 2 * target_lengths.long()
    a_end = alpha.gather(1, end[:, None])[:, 0]
    a_last = torch.where(target_lengths > 0,
                         alpha.gather(1, torch.clamp(end - 1, min=0)[:, None])[:, 0], NEG_INF)
    return torch.stack(alphas), -_logaddexp(a_end, a_last)


def ctc_beta_grad_plain(log_probs, targets, input_lengths, target_lengths, alphas, nll, g,
                        blank: int = 0):
    B, T, C = log_probs.shape
    z, can_skip, valid = _lattice(targets.long(), target_lengths.long(), blank)
    S = z.shape[1]
    s = torch.arange(S, device=z.device)[None, :]
    end = 2 * target_lengths.long()[:, None]
    term = torch.where((s == end) | ((s == end - 1) & (target_lengths[:, None] > 0)), 0.0, NEG_INF)
    term = torch.where(valid, term, NEG_INF).to(log_probs.dtype)
    skip_from = torch.cat([can_skip[:, 2:], torch.zeros_like(can_skip[:, :2])], 1)[:, :S]
    betas = [term]
    beta = term
    for t in range(T - 2, -1, -1):
        x = torch.where(valid, beta + log_probs[:, t + 1, :].gather(1, z), NEG_INF)
        x1 = torch.cat([x[:, 1:], _neg((B, 1), x)], 1)
        x2 = torch.cat([x[:, 2:], _neg((B, 2), x)], 1)[:, :S]
        x2 = torch.where(skip_from, x2, NEG_INF)
        beta = torch.where((t >= input_lengths - 1)[:, None], term, _logaddexp3(x, x1, x2))
        betas.append(beta)
    betas = torch.stack(betas[::-1])                                     # (T, B, S)
    occ = torch.exp(torch.clamp(alphas + betas + nll[None, :, None], max=0.0))
    onehot = ((z[:, :, None] == torch.arange(C, device=z.device)[None, None, :])
              & valid[:, :, None]).to(occ.dtype)
    grad = -torch.einsum("tbs,bsc->btc", occ, onehot)
    tmask = torch.arange(T, device=z.device)[None, :] < input_lengths[:, None]
    finite = nll < -NEG_INF / 2
    return grad * (g * finite)[:, None, None] * tmask[:, :, None].to(occ.dtype)


def _check(log_probs, targets, input_lengths, target_lengths, what):
    B, T, C = log_probs.shape
    build.require(log_probs, (B, T, C), f"{what} log_probs")
    build.require_int(targets, (B, targets.shape[1]), f"{what} targets")
    build.require_int(input_lengths, (B,), f"{what} input_lengths")
    build.require_int(target_lengths, (B,), f"{what} target_lengths")
    S = 2 * targets.shape[1] + 1
    return B, T, C, S, ctc_plan(B, T, S, max_cluster())


@counted(no_dots)
def ctc_alpha(log_probs, targets, input_lengths, target_lengths, blank: int = 0):
    """Forward recursion: (alphas (T, B, S), nll (B,)). ``targets`` (B, U)
    and the lengths are int32 (pad == blank)."""
    if not log_probs.is_cuda:
        return ctc_alpha_plain(log_probs, targets, input_lengths, target_lengths, blank)
    B, T, C, S, plan = _check(log_probs, targets, input_lengths, target_lengths, "ctc_alpha")
    alphas = torch.empty((T, B, S), device=log_probs.device, dtype=torch.float32)
    nll = torch.empty((B,), device=log_probs.device, dtype=torch.float32)
    if B and T:
        ptrs = (log_probs.data_ptr(), targets.data_ptr(), input_lengths.data_ptr(),
                target_lengths.data_ptr(), alphas.data_ptr(), nll.data_ptr(),
                B, T, C, targets.shape[1], blank)
        if plan["lattice"] == "chain":
            # scratch: the links between a row's clusters (B, Q - 1, T) float2;
            # the ticket counter, row counts and link flags, zero
            link = torch.empty((max(1, plan["link_floats"] * T),), device=log_probs.device,
                               dtype=torch.float32)
            sync = torch.zeros((plan["sync_ints"],), device=log_probs.device, dtype=torch.int32)
            err = build.bind("ctc", "ctc_alpha_chain_f32", 8, 9)(
                *ptrs[:6], link.data_ptr(), sync.data_ptr(), *ptrs[6:], plan["states_per_lane"],
                plan["chain_warps"], plan["cluster"], plan["clusters"], build.stream())
        elif plan["lattice"] == "cluster":
            err = build.bind("ctc", "ctc_alpha_cluster_f32", 6, 8)(
                *ptrs, plan["states_per_lane"], plan["chain_warps"], plan["cluster"],
                build.stream())
        else:
            err = build.bind("ctc", "ctc_alpha_f32", 6, 7)(
                *ptrs, plan["states_per_lane"], plan["chain_warps"], build.stream())
        build.check(err, "ctc_alpha")
        ctc_alpha.launches += 1
    return alphas, nll


def _occupancy_flops(log_probs, targets, *_, **__):
    """The one-hot product of `_ctc_nll_bwd` (``semi_tts_tpu/ops/ctc.py:167``):
    occupancies (T, B, S) against the labels' one-hots (B, S, C)."""
    B, T, C = log_probs.shape
    return 2 * B * T * (2 * targets.shape[1] + 1) * C


@counted(_occupancy_flops)
def ctc_beta_grad(log_probs, targets, input_lengths, target_lengths, alphas, nll, g,
                  blank: int = 0):
    """Backward recursion and gradient: d(sum_b g[b] nll[b]) / d log_probs,
    (B, T, C); zero at t >= input_lengths[b] and for impossible rows."""
    if not log_probs.is_cuda:
        return ctc_beta_grad_plain(log_probs, targets, input_lengths, target_lengths,
                                   alphas, nll, g, blank)
    B, T, C, S, plan = _check(log_probs, targets, input_lengths, target_lengths,
                              "ctc_beta_grad")
    build.require(alphas, (T, B, S), "ctc_beta_grad alphas")
    build.require(nll, (B,), "ctc_beta_grad nll")
    build.require(g, (B,), "ctc_beta_grad g")
    grad = torch.empty((B, T, C), device=log_probs.device, dtype=torch.float32)
    if B and T:
        ptrs = (log_probs.data_ptr(), targets.data_ptr(), input_lengths.data_ptr(),
                target_lengths.data_ptr(), alphas.data_ptr(), nll.data_ptr(), g.data_ptr(),
                grad.data_ptr())
        ints = (B, T, C, targets.shape[1], blank)
        if plan["lattice"] == "chain":
            # scratch: each CTA's class sums (B, Q P, T, C); the links (B, Q - 1, T)
            # float2; the ticket counter, row counts and link flags, zero
            partials = torch.empty((plan["partial_floats"] * T * C,), device=log_probs.device,
                                   dtype=torch.float32)
            link = torch.empty((max(1, plan["link_floats"] * T),), device=log_probs.device,
                               dtype=torch.float32)
            sync = torch.zeros((plan["sync_ints"],), device=log_probs.device, dtype=torch.int32)
            err = build.bind("ctc", "ctc_beta_grad_chain_f32", 11, 9)(
                *ptrs, partials.data_ptr(), link.data_ptr(), sync.data_ptr(), *ints,
                plan["states_per_lane"],
                plan["chain_warps"], plan["cluster"], plan["clusters"], build.stream())
        elif plan["lattice"] == "cluster":
            # scratch: each CTA's class sums (B, P, T, C)
            partials = torch.empty((B * plan["cluster"] * T * C,), device=log_probs.device,
                                   dtype=torch.float32)
            err = build.bind("ctc", "ctc_beta_grad_cluster_f32", 9, 8)(
                *ptrs, partials.data_ptr(), *ints, plan["states_per_lane"], plan["chain_warps"],
                plan["cluster"], build.stream())
        else:
            err = build.bind("ctc", "ctc_beta_grad_f32", 8, 7)(
                *ptrs, *ints, plan["states_per_lane"], plan["chain_warps"], build.stream())
        build.check(err, "ctc_beta_grad")
        ctc_beta_grad.launches += 1
    return grad


ctc_alpha.launches = 0
ctc_beta_grad.launches = 0
