"""K1 `lstm_rec`, K2 `gru_rec`, K7 `lstm_rec_bwd` and K8 `gru_rec_bwd`:
the sequence recurrences over pre-projected inputs and their backward
recurrences, in the JAX layout (x_proj (T, B, G*H), W_hh (G*H, H)).

`lstm_rec`/`gru_rec` run one direction, as `semi_tts_tpu.ops.rnn._lstm_rec`
and `_gru_rec` do; `bilstm_rec`/`bigru_rec` run a forward and a reversed
direction in one launch and return (T, B, 2H), forward first (`bigru_rec`
also the forward one alone).
`bilstm_rec_cs` is K1 for training: it also returns the cell states
(T, B, nH) that the backward needs, for one or two directions.
`bilstm_rec_bwd` is K7, the backward recurrence of `_lstm_rec_bwd`: from the
recomputed gate pre-activations, the cell states and the incoming gradient
of hs it returns the gate gradients (T, B, 4H) of each direction. `bigru_rec_bwd` is K8, the backward recurrence of
`_gru_rec_bwd`: from the update gates, the hidden-side coefficients and the
incoming gradient of hs it returns dh2 (T, B, H) of each direction (of
one or two, as K7). Each
wrapper launches `csrc/rnn.cu` for CUDA tensors and runs its plain PyTorch
version only for CPU tensors. `lstm_plan`, `lstm_bwd_plan`, `gru_plan` and
`gru_bwd_plan` compute the narrow kernels' launch plans and name the hidden
sizes each takes (K7 takes K1's, K8 K2's).

Past those sizes the wrappers launch the wide routes of `csrc/rnn_wide.cu`
(K1w, K7w, K2w, K8w), which take any H >= 1: `lstm_route` and `gru_route`
pick the route, `wide_design_plan` plans a wide launch (the cluster
designs of each where they fit, else `wide_plan`'s first design), and each
wide launch is
counted on its own wrapper (`lstm_rec_wide`, `lstm_rec_bwd_wide`,
`gru_rec_wide`, `gru_rec_bwd_wide`), not on the narrow one. Every public
wrapper reports the dot FLOPs of the JAX scan it replaces to
`utils.flops.matmul_flops`, whatever route ran.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils.flops import counted
from . import build

CLUSTER = 8                 # K1 CTAs per thread-block cluster
LANES = 8                   # lanes per hidden unit
LSTM_MAX_H = 288            # K1: 4*U gate rows of W_hh per CTA in shared memory
LSTM_ROWS = (1, 2, 4, 8)    # K1: batch rows per cluster
AHEAD = 4                   # x_proj steps staged in shared memory
GRU_MAX_H = 128             # K2: 8 lanes per hidden unit, at most 1024 threads
SMEM_PER_BLOCK = build.SMEM_PER_BLOCK
WIDE_THREADS = 256          # K1w, K7w, K2w, K8w: threads of a CTA
WIDE_CHUNK = 8              # batch rows of a staged vector chunk, at most
WIDE_ROWS = 4               # rows of W a warp accumulates at once
WIDE_CLUSTER = 8            # the cluster designs: CTAs a thread-block cluster (kCl)
WIDE_ONE_CTA_SMEM = 116 * 1024  # its shared memory at least: one CTA an SM (kOneCtaSmem)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check_lstm_h(H: int) -> None:
    if H % 4 or not 4 <= H <= LSTM_MAX_H:
        raise ValueError(f"lstm_rec kernel takes 4 <= H <= {LSTM_MAX_H} with H % 4 == 0, got H={H}")


def lstm_route(H: int) -> str:
    """The LSTM recurrences' route at hidden size H: "narrow" (K1, K7) where
    their plans fit, 4 <= H <= 288 with H % 4 == 0 (at any batch and either
    number of directions), else "wide" (K1w, K7w)."""
    return "narrow" if H % 4 == 0 and 4 <= H <= LSTM_MAX_H else "wide"


def gru_route(H: int) -> str:
    """The GRU recurrences' route: "narrow" (K2, K8) at 1 <= H <= 128, else
    "wide" (K2w, K8w)."""
    return "narrow" if 1 <= H <= GRU_MAX_H else "wide"


WIDE_GATES = {"lstm": 4, "lstm_bwd": 4, "gru": 3, "gru_bwd": 3}


def wide_plan(kernel: str, B: int, H: int, ndir: int, sms: int) -> dict:
    """The launch plan of a wide route (``kernel`` "lstm" K1w, "lstm_bwd"
    K7w, "gru" K2w, "gru_bwd" K8w) for B >= 1 rows, hidden size H >= 1 and
    ``ndir`` directions on a card of ``sms`` SMs: one cooperative launch of
    ``grid`` = (CTAs a direction, ndir), at most one CTA an SM, CTA p owning
    the units [p*U, p*U + U). A forward CTA's rows are its G*U gate rows of
    W_hh (``k`` = H values each), a backward CTA's its U columns of W_hh
    (``k`` = G*H); ``rows_smem`` of them sit in shared memory beside the
    partial sums, the forward's gate pre-activations and a chunk of
    ``chunk`` staged batch rows, and the rest are read from L2. Raises
    ValueError at H < 1 and where not even one staged row of ``k`` values
    fits (k past ~58,000: the LSTM's backward past H ~ 14,500)."""
    if H < 1:
        raise ValueError(f"{kernel} wide route takes H >= 1, got H={H}")
    G, fwd = WIDE_GATES[kernel], not kernel.endswith("_bwd")
    units = math.ceil(H / max(1, min(sms // ndir, H)))
    ctas = math.ceil(H / units)
    rows = G * units if fwd else units
    k = H if fwd else G * H
    red = max(WIDE_THREADS // 32, math.ceil(rows / WIDE_ROWS)) * 32
    room = SMEM_PER_BLOCK // 4 - red
    chunk = min(WIDE_CHUNK, B, room // (k + (rows if fwd else 0)))
    if chunk < 1:
        raise ValueError(f"{kernel} wide route: a staged row of {k} values does not fit "
                         f"shared memory (H={H})")
    fixed = red + chunk * (k + (rows if fwd else 0))
    rows_smem = min(rows, (SMEM_PER_BLOCK // 4 - fixed) // k)
    return dict(grid=(ctas, ndir), ctas=ctas * ndir, threads=WIDE_THREADS, units_per_cta=units,
                rows=rows, k=k, chunk=chunk, rows_smem=rows_smem,
                smem_bytes=4 * (fixed + rows_smem * k))


def _cluster_smem(G: int, B: int, H: int, U: int, rows: int) -> int:
    """Bytes of shared memory of a cluster-design K7w (``G`` 4) or K8w (3)
    CTA (csrc/rnn_wide.cu `cluster_smem_bytes`): its part of the step's
    vector (ceil(B / 8), G*U, 8), its dh_rec and carried values (B, U each,
    each rounded up to 4 floats), its G*U rows of W_hh, the partials of
    ``rows`` batch rows at a time (2, rows, H); at least
    `WIDE_ONE_CTA_SMEM`, so that one CTA takes an SM."""
    return max(4 * (_cluster_fixed(G, B, H, U) + 2 * rows * H), WIDE_ONE_CTA_SMEM)


def _cluster_fixed(G: int, B: int, H: int, U: int) -> int:
    """Floats of a cluster-design backward CTA's shared memory but its partials."""
    return -(-B // WIDE_CHUNK) * WIDE_CHUNK * G * U + 2 * _round_up(B * U, 4) + G * U * H


def _cluster_widths(H: int, ndir: int, sms: int, unit: int = 1):
    """(N, U) of a cluster design, most CTAs first: N CTAs a direction, the
    fewest multiple of `WIDE_CLUSTER` that hold H at U = ceil(H / n) units a
    CTA (rounded up to a multiple of ``unit``), for each multiple n of 8 up
    to ``sms`` / ndir."""
    for n in range(WIDE_CLUSTER * (sms // (WIDE_CLUSTER * ndir)), 0, -WIDE_CLUSTER):
        U = _round_up(math.ceil(H / n), unit)
        yield WIDE_CLUSTER * math.ceil(math.ceil(H / U) / WIDE_CLUSTER), U


def wide_bwd_plan(B: int, H: int, ndir: int, sms: int, max_clusters, kernel: str) -> dict:
    """K7w's (``kernel`` "lstm_bwd") or K8w's ("gru_bwd") launch plan: the
    cluster design (``design`` "cluster": each CTA's part of the step's
    vector times its own G gate rows of W_hh, a reduce-scatter over the
    cluster and the L2) where its CTAs hold all of their G*U gate rows and
    the partials of at least `WIDE_CHUNK` batch rows in shared memory and its
    grid fits the card at once, else the first design (`wide_plan` of
    ``kernel``, ``design`` "grid": a grid barrier a step, the step's vector
    staged into every CTA, W_hh's rows that do not fit read from L2), which
    `chip_ablate.py --k7w` and ``--k8w`` found slower at every shape both
    take (NVIDIA H100 80GB HBM3, 700 W). The cluster design: ``grid`` (N,
    ndir), N CTAs a direction a multiple of `WIDE_CLUSTER`: the most up to
    ``sms`` / ndir whose clusters ``max_clusters(B, H, U, rows)`` (the
    card's count of co-resident clusters at that plan) takes, U = ceil(H /
    N) units a CTA and N the fewest multiple of 8 CTAs that hold H; the
    partials (2, B, H) ``batch_rows`` rows at a time: all B where they fit,
    else the most multiple of `WIDE_CHUNK` that do."""
    G = WIDE_GATES[kernel]
    grid = dict(wide_plan(kernel, B, H, ndir, sms), design="grid")
    for ctas, U in _cluster_widths(H, ndir, sms):
        room = (SMEM_PER_BLOCK // 4 - _cluster_fixed(G, B, H, U)) // (2 * H)  # partial rows
        if room < min(B, WIDE_CHUNK):
            break
        rows = B if room >= B else room // WIDE_CHUNK * WIDE_CHUNK
        if ndir * ctas // WIDE_CLUSTER <= max_clusters(B, H, U, rows):
            return dict(design="cluster", grid=(ctas, ndir), ctas=ctas * ndir,
                        threads=WIDE_THREADS, units_per_cta=U, rows=G * U, k=H,
                        rows_smem=G * U, batch_rows=rows,
                        smem_bytes=_cluster_smem(G, B, H, U, rows), cluster=WIDE_CLUSTER,
                        clusters=ctas // WIDE_CLUSTER,
                        pub_floats=2 * ndir * (ctas // WIDE_CLUSTER) * B * H,
                        flags=ndir * ctas)
    return grid


def _fwd_cluster_smem(G: int, B: int, H: int, U: int) -> int:
    """Bytes of shared memory of a cluster-design K1w (``G`` 4) or K2w (3)
    CTA (csrc/rnn_wide.cu `fwd_cluster_smem_bytes`), R = G*U gate rows: the
    column slices' partial sums (32, 256 + R/4), a chunk's gate
    pre-activations (8, R), a chunk's rows of the other clusters' columns
    (H, 8), the cluster's columns of h (2, ceil(B / 8), 8U, 8), x_proj of
    its units (2, B, R), their cell states or (the GRU) h_{t-1} (B, U,
    rounded up to 4 floats), the GRU's b_hh of its rows (R), its R rows of
    W_hh, two mbarriers; at least `WIDE_ONE_CTA_SMEM`."""
    R = G * U
    floats = (32 * (WIDE_THREADS + R // 4) + WIDE_CHUNK * R + WIDE_CHUNK * H
              + 2 * -(-B // WIDE_CHUNK) * WIDE_CLUSTER * U * WIDE_CHUNK + 2 * B * R
              + _round_up(B * U, 4) + (R if G == 3 else 0) + R * H)
    return max(4 * (_round_up(floats, 2) + 4), WIDE_ONE_CTA_SMEM)


def wide_fwd_plan(B: int, H: int, ndir: int, sms: int, max_clusters,
                  kernel: str = "lstm") -> dict:
    """K1w's (``kernel`` "lstm") or K2w's ("gru") launch plan: the cluster
    design (``design`` "cluster": h all-gathered over each cluster's DSMEM
    and, between clusters, through L2 as ``words`` (2, ndir, B, H) of h and
    its step; no grid barrier) where a CTA's G*U gate rows of W_hh and its
    buffers fit shared memory and its grid fits the card at once (the most
    CTAs up to ``sms`` / ndir whose clusters ``max_clusters(B, H, U, 0)``
    takes, U and N as `wide_bwd_plan`'s; the GRU's U a multiple of 4, so
    that its 3U rows make whole groups of the kernel's 4), else
    the first design (`wide_plan` of ``kernel``, ``design`` "grid"): at H =
    1,024 in both directions."""
    G = WIDE_GATES[kernel]
    grid = dict(wide_plan(kernel, B, H, ndir, sms), design="grid")
    for ctas, U in _cluster_widths(H, ndir, sms, 4 if G == 3 else 1):
        smem = _fwd_cluster_smem(G, B, H, U)
        if smem > SMEM_PER_BLOCK:
            break
        if ndir * ctas // WIDE_CLUSTER <= max_clusters(B, H, U, 0):
            return dict(design="cluster", grid=(ctas, ndir), ctas=ctas * ndir,
                        threads=WIDE_THREADS, units_per_cta=U, rows=G * U, k=H,
                        rows_smem=G * U, smem_bytes=smem, cluster=WIDE_CLUSTER,
                        clusters=ctas // WIDE_CLUSTER, words=2 * ndir * B * H)
    return grid


# the cluster designs' kernel numbers of `wide_cluster_max_clusters`
WIDE_CLUSTER_KERNELS = {"lstm": 0, "lstm_bwd": 1, "gru_bwd": 2, "gru": 3}


@functools.lru_cache(maxsize=None)
def _cluster_fit(kernel: str, B: int, H: int, U: int, rows: int) -> int:
    """The card's co-resident clusters of ``kernel``'s cluster design at that plan."""
    fn = build.load("rnn_wide").wide_cluster_max_clusters
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    n = fn(WIDE_CLUSTER_KERNELS[kernel], B, H, U, rows)
    if n < 0:
        raise RuntimeError(f"wide_cluster_max_clusters({kernel}, {B}, {H}, {U}, {rows}): "
                           f"cudaError {-n}")
    return n


def wide_design_plan(kernel: str, B: int, H: int, ndir: int, device) -> dict:
    """The plan a wide launch of ``kernel`` takes on ``device``'s card, with
    its ``design``: `wide_fwd_plan` (K1w, K2w), `wide_bwd_plan` (K7w, K8w)."""
    sms, fit = _sms(device.index), functools.partial(_cluster_fit, kernel)
    if kernel in ("lstm", "gru"):
        return wide_fwd_plan(B, H, ndir, sms, fit, kernel)
    return wide_bwd_plan(B, H, ndir, sms, fit, kernel)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _barrier(device):
    """The wide kernels' grid barrier: one counter, zeroed for each launch."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def lstm_plan(B: int, H: int, ndir: int, max_clusters: int, rows: int | None = None) -> dict:
    """K1's launch plan for B rows, hidden size H, ``ndir`` directions, given
    how many clusters fit on the card at once. Takes 4 <= H <= 288 with
    H % 4 == 0 and raises ValueError otherwise. ``rows`` (batch rows per
    cluster) defaults to the fewest that let every cluster run at once."""
    _check_lstm_h(H)
    if rows is None:
        rows = next((r for r in LSTM_ROWS if math.ceil(B / r) * ndir <= max_clusters), LSTM_ROWS[-1])
    elif rows not in LSTM_ROWS:
        raise ValueError(f"lstm_rec rows must be one of {LSTM_ROWS}, got {rows}")
    units = _round_up(math.ceil(H / CLUSTER), 4)     # hidden units per CTA
    padded = 64 * math.ceil(H / 64)                  # h and W_hh rows, zero past H
    smem = 4 * ((4 * units + 2 * rows) * padded + AHEAD * rows * 4 * units)
    clusters = math.ceil(B / rows) * ndir
    return dict(cluster=CLUSTER, rows=rows, clusters=clusters,
                grid=(CLUSTER * math.ceil(B / rows), ndir), threads=LANES * units,
                units_per_cta=units, smem_bytes=smem, max_h=LSTM_MAX_H)


def _lstm_bwd_reg_chunks(rows: int, chunks: int) -> int:
    """K7's W_hh chunks in registers: fewer for more rows' accumulators, and
    fewer past 512 threads (5 chunks), where 18 warps leave 96 registers a
    thread (8 rows then run phase B in two passes of 4)."""
    if chunks >= 5:
        return 3 if rows <= 2 else 1
    return min(chunks, 4 if rows <= 2 else 3 if rows == 4 else 2)


def lstm_bwd_plan(B: int, H: int, ndir: int, max_clusters: int, rows: int | None = None) -> dict:
    """K7's launch plan: a cluster of 8 CTAs per ``rows`` batch rows and
    direction; CTA r owns the units [r*U, r*U + U) and their 4*U gate rows of
    W_hh. A group of 8 lanes serves 4 columns of W_hh: lane g holds the gate
    rows 4(8i + g) .. + 3 for i < ``chunks`` (the 4*U rows padded to 32 a
    chunk), the first ``reg_chunks`` of them in registers and the rest in
    shared memory, beside 2 mbarriers, the (2, 8, rows, U) partial-sum slots,
    the rows' gate gradients (2, rows, 32*chunks) and a ring of AHEAD steps of
    6 inputs a (row, unit). Same H limits as K1; ``rows`` defaults as K1's do
    (an explicit value checks one of the kernel's instantiations)."""
    _check_lstm_h(H)
    if rows is None:
        rows = next((r for r in LSTM_ROWS if math.ceil(B / r) * ndir <= max_clusters), LSTM_ROWS[-1])
    elif rows not in LSTM_ROWS:
        raise ValueError(f"lstm_rec_bwd rows must be one of {LSTM_ROWS}, got {rows}")
    units = _round_up(math.ceil(H / CLUSTER), 4)
    chunks = math.ceil(units / LANES)
    reg_chunks = _lstm_bwd_reg_chunks(rows, chunks)
    smem = 4 * (4 + (chunks - reg_chunks) * 128 * (H // 4) + 2 * CLUSTER * rows * units
                + 2 * rows * 32 * chunks + AHEAD * 6 * rows * units)
    clusters = math.ceil(B / rows) * ndir
    return dict(cluster=CLUSTER, rows=rows, clusters=clusters,
                grid=(CLUSTER * math.ceil(B / rows), ndir),
                threads=_round_up(max(2 * H, rows * units), 32), units_per_cta=units,
                chunks=chunks, reg_chunks=reg_chunks, smem_bytes=smem, max_h=LSTM_MAX_H)


def gru_plan(B: int, H: int, ndir: int) -> dict:
    """K2's launch plan: one block per batch row and direction, 8 lanes per
    hidden unit, W_hh in registers. Takes 1 <= H <= 128 and raises
    ValueError otherwise."""
    if not 1 <= H <= GRU_MAX_H:
        raise ValueError(f"gru_rec kernel takes 1 <= H <= {GRU_MAX_H}, got H={H}")
    return dict(grid=(B, ndir), threads=_round_up(LANES * H, 32),
                weights_per_lane=3 * 2 * math.ceil(H / 16), max_h=GRU_MAX_H)


GRU_BWD_LANES = 16          # K8: lanes of a group of 4 units
GRU_BWD_REG_ROWS = 7        # K8: rows of each gate a lane keeps in registers


def gru_bwd_plan(B: int, H: int, ndir: int) -> dict:
    """K8's launch plan: one block per batch row and direction; a group of 16
    lanes serves 4 units, lane l holding the rows l + 16i (i < ``rows_per_lane``)
    of each gate at the group's 4 columns, the first ``reg_rows`` in
    registers and the rest in shared memory, beside the double-buffered
    step vector. Takes K2's H range."""
    if not 1 <= H <= GRU_MAX_H:
        raise ValueError(f"gru_rec_bwd kernel takes 1 <= H <= {GRU_MAX_H}, got H={H}")
    rpl = math.ceil(H / GRU_BWD_LANES)
    reg_rows = min(rpl, GRU_BWD_REG_ROWS)
    w_s = 3 * (rpl - reg_rows) * 64 * rpl if rpl > reg_rows else 1
    return dict(grid=(B, ndir), threads=_round_up(GRU_BWD_LANES * math.ceil(H / 4), 32),
                rows_per_lane=rpl, reg_rows=reg_rows,
                smem_bytes=4 * 2 * 3 * GRU_BWD_LANES * rpl + 16 * w_s, max_h=GRU_MAX_H)


@functools.lru_cache(maxsize=None)
def max_clusters(H: int, kernel: str = "lstm_rec") -> int:
    """How many clusters of K1 (``kernel="lstm_rec"``) or K7
    (``"lstm_rec_bwd"``) fit on the current card at once, from
    ``cudaOccupancyMaxActiveClusters`` (asked with the largest rows)."""
    fn = getattr(build.load("rnn"), f"{kernel}_max_clusters")
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn(H, LSTM_ROWS[-1])
    if n <= 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters for {kernel} failed ({n})")
    return n


def lstm_rec_cs_plain(reverse: bool, w_hh, x_proj):
    """x_proj (T, B, 4H) -> (hs, cs), each (T, B, H); gate order i, f, g, o."""
    T, B, H4 = x_proj.shape
    H = H4 // 4
    h = x_proj.new_zeros((B, H))
    c = x_proj.new_zeros((B, H))
    hs = x_proj.new_empty((T, B, H))
    cs = x_proj.new_empty((T, B, H))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = x_proj[t] + h @ w_hh.T
        i, f, g, o = gates.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs[t] = h
        cs[t] = c
    return hs, cs


def lstm_rec_plain(reverse: bool, w_hh, x_proj):
    """x_proj (T, B, 4H) -> hs (T, B, H); gate order i, f, g, o."""
    return lstm_rec_cs_plain(reverse, w_hh, x_proj)[0]


def bilstm_rec_plain(w_hh_f, w_hh_b, x_proj_f, x_proj_b):
    return torch.cat([lstm_rec_plain(False, w_hh_f, x_proj_f),
                      lstm_rec_plain(True, w_hh_b, x_proj_b)], dim=-1)


def _launch_lstm(wrapper, dirs, rows, with_cs=False):
    """One K1 launch over ``dirs`` = [(reverse, w_hh, x_proj)] (1 or 2),
    counted on ``wrapper``; returns hs, or (hs, cs) ``with_cs``."""
    T, B, H4 = dirs[0][2].shape
    H = H4 // 4
    for _, w_hh, x_proj in dirs:
        build.require(x_proj, (T, B, 4 * H), "lstm_rec x_proj")
        build.require(w_hh, (4 * H, H), "lstm_rec w_hh")
    if lstm_route(H) == "wide":
        return lstm_rec_wide(dirs, with_cs)
    if any(w.data_ptr() % 16 or x.data_ptr() % 16 for _, w, x in dirs):
        raise ValueError("lstm_rec: expected 16-byte aligned w_hh and x_proj")
    plan = lstm_plan(B, H, len(dirs), max_clusters(H), rows)
    hs = torch.empty((T, B, len(dirs) * H), device=dirs[0][2].device, dtype=torch.float32)
    cs = torch.empty_like(hs) if with_cs else None
    if T and B:
        (r0, w0, x0), (r1, w1, x1) = dirs[0], dirs[-1]
        fn = build.bind("rnn", "lstm_rec_f32", 6, 7)
        build.check(fn(x0.data_ptr(), x1.data_ptr(), w0.data_ptr(), w1.data_ptr(), hs.data_ptr(),
                       0 if cs is None else cs.data_ptr(), T, B, H, len(dirs), int(r0), int(r1),
                       plan["rows"], build.stream()), "lstm_rec")
        wrapper.launches += 1
    return (hs, cs) if with_cs else hs


def lstm_rec_wide(dirs, with_cs=False):
    """K1w: one launch over ``dirs`` = [(reverse, w_hh, x_proj)] (1 or 2,
    checked by the caller) at any H, of the design `wide_fwd_plan` picks;
    returns hs, or (hs, cs) ``with_cs``."""
    T, B, H4 = dirs[0][2].shape
    H, n, dev = H4 // 4, len(dirs), dirs[0][2].device
    hs = torch.empty((T, B, n * H), device=dev, dtype=torch.float32)
    cs = torch.empty_like(hs) if with_cs else None
    if T and B:
        plan = wide_design_plan("lstm", B, H, n, dev)
        (r0, w0, x0), (r1, w1, x1) = dirs[0], dirs[-1]
        ptrs = (x0.data_ptr(), x1.data_ptr(), w0.data_ptr(), w1.data_ptr(), hs.data_ptr(),
                0 if cs is None else cs.data_ptr())
        if plan["design"] == "cluster":
            # scratch: h and its step a word, by step parity, zeroed
            words = torch.zeros((plan["words"],), device=dev, dtype=torch.int64)
            fn = build.bind("rnn_wide", "lstm_rec_wide_cluster_f32", 7, 8)
            build.check(fn(*ptrs, words.data_ptr(), T, B, H, n, int(r0), int(r1),
                           plan["units_per_cta"], plan["grid"][0], build.stream()), "lstm_rec_wide")
        else:
            state, bar = torch.empty((n, B, H), device=dev, dtype=torch.float32), _barrier(dev)
            fn = build.bind("rnn_wide", "lstm_rec_wide_f32", 8, 9)
            build.check(fn(*ptrs, state.data_ptr(), bar.data_ptr(), T, B, H, n, int(r0), int(r1),
                           plan["units_per_cta"], plan["chunk"], plan["rows_smem"], build.stream()),
                        "lstm_rec_wide")
        lstm_rec_wide.launches += 1
    return (hs, cs) if with_cs else hs


def _scan_flops(w_f, w_b, xs):
    """The dot FLOPs of the JAX scans a recurrence wrapper replaces: one
    (B, H) x (H, G*H) product a step and direction, over xs (T, B, ...)."""
    T, B = xs.shape[:2]
    return 2 * T * B * w_f.numel() * (1 if w_b is None else 2)


@counted(lambda reverse, w_hh, x_proj: _scan_flops(w_hh, None, x_proj))
def lstm_rec(reverse: bool, w_hh, x_proj):
    """Forward of `semi_tts_tpu.ops.rnn._lstm_rec`: one launch per call."""
    if not x_proj.is_cuda:
        return lstm_rec_plain(reverse, w_hh, x_proj)
    return _launch_lstm(lstm_rec, [(reverse, w_hh, x_proj)], None)


@counted(lambda w_hh_f, w_hh_b, x_proj_f, x_proj_b, rows=None:
         _scan_flops(w_hh_f, w_hh_b, x_proj_f))
def bilstm_rec(w_hh_f, w_hh_b, x_proj_f, x_proj_b, rows: int | None = None):
    """Both directions of a BiLSTM layer in one launch: (T, B, 2H), the
    forward direction in [..., :H] and the reversed one in [..., H:].
    ``rows`` overrides the narrow plan's batch rows per cluster (for
    measuring)."""
    if not x_proj_f.is_cuda:
        return bilstm_rec_plain(w_hh_f, w_hh_b, x_proj_f, x_proj_b)
    return _launch_lstm(bilstm_rec, [(False, w_hh_f, x_proj_f), (True, w_hh_b, x_proj_b)], rows)


def _dirs(*per_dir):
    """[(reverse, *tensors)] of the forward direction and, where its tensors
    are given, the reversed one."""
    fwd, bwd = per_dir[0::2], per_dir[1::2]
    return [(False, *fwd)] + ([] if bwd[0] is None else [(True, *bwd)])


def bilstm_rec_cs_plain(w_hh_f, w_hh_b, x_proj_f, x_proj_b):
    outs = [lstm_rec_cs_plain(r, w, x) for r, w, x in _dirs(w_hh_f, w_hh_b, x_proj_f, x_proj_b)]
    return torch.cat([o[0] for o in outs], -1), torch.cat([o[1] for o in outs], -1)


@counted(lambda w_hh_f, w_hh_b, x_proj_f, x_proj_b: _scan_flops(w_hh_f, w_hh_b, x_proj_f))
def bilstm_rec_cs(w_hh_f, w_hh_b, x_proj_f, x_proj_b):
    """K1 for training: (hs, cs), each (T, B, nH), forward direction first;
    ``w_hh_b``/``x_proj_b`` None runs the forward direction alone."""
    if not x_proj_f.is_cuda:
        return bilstm_rec_cs_plain(w_hh_f, w_hh_b, x_proj_f, x_proj_b)
    return _launch_lstm(bilstm_rec_cs, _dirs(w_hh_f, w_hh_b, x_proj_f, x_proj_b), None,
                        with_cs=True)


lstm_rec.launches = 0
bilstm_rec.launches = 0
bilstm_rec_cs.launches = 0
lstm_rec_wide.launches = 0


def shift_prev(ys, reverse: bool):
    """The carry each step of a (T, B, H) scan consumed: ys[t-1] forward
    (zero at t=0), ys[t+1] reversed (zero at t=T-1)."""
    z = torch.zeros_like(ys[:1])
    return torch.cat([ys[1:], z]) if reverse else torch.cat([z, ys[:-1]])


def lstm_rec_bwd_plain(reverse: bool, w_hh, gates, cs, g_hs):
    """One direction of `_lstm_rec_bwd`'s recurrence: gate pre-activations
    ``gates`` (T, B, 4H), cell states ``cs`` and the gradient ``g_hs`` of hs
    (T, B, H) -> gate gradients (T, B, 4H), the time axis walked opposite to
    the forward."""
    T, B, H4 = gates.shape
    H = H4 // 4
    ia, fa, ga, oa = gates.split(H, dim=-1)
    ia, fa, ga, oa = torch.sigmoid(ia), torch.sigmoid(fa), torch.tanh(ga), torch.sigmoid(oa)
    tc = torch.tanh(cs)
    c_prev = shift_prev(cs, reverse)
    dh_rec = gates.new_zeros((B, H))
    dc_rec = gates.new_zeros((B, H))
    dgates = gates.new_empty((T, B, H4))
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        i, f, g, o = ia[t], fa[t], ga[t], oa[t]
        dh = g_hs[t] + dh_rec
        dc = dc_rec + dh * o * (1.0 - tc[t] * tc[t])
        dg = torch.cat([dc * g * i * (1.0 - i), dc * c_prev[t] * f * (1.0 - f),
                        dc * i * (1.0 - g * g), dh * tc[t] * o * (1.0 - o)], dim=-1)
        dgates[t] = dg
        dh_rec, dc_rec = dg @ w_hh, dc * f
    return dgates


def bilstm_rec_bwd_plain(w_hh_f, w_hh_b, gates_f, gates_b, cs, g_hs):
    dirs = _dirs(w_hh_f, w_hh_b, gates_f, gates_b)
    H = w_hh_f.shape[1]
    out = [lstm_rec_bwd_plain(r, w, g, cs[..., k * H:(k + 1) * H], g_hs[..., k * H:(k + 1) * H])
           for k, (r, w, g) in enumerate(dirs)]
    return out[0], (out[1] if len(out) > 1 else None)


def lstm_rec_bwd_wide(dirs, cs, g_hs):
    """K7w: one launch over ``dirs`` = [(reverse, w_hh, gates)] (checked by
    the caller) at any H; returns (dgates_f, dgates_b or None). The cluster
    design (`wide_bwd_plan`) reads W_hh's gate rows as they are; the first
    design reads its columns as rows of W_hh^T, transposed here."""
    T, B, H4 = dirs[0][2].shape
    H, n, dev = H4 // 4, len(dirs), dirs[0][2].device
    dg = [torch.empty_like(dirs[0][2]) for _ in dirs]
    plan = wide_design_plan("lstm_bwd", B, H, n, dev) if T and B else None
    if plan is not None and plan["design"] == "cluster":
        # scratch: the clusters' published sums; their step flags, zeroed
        pub = torch.empty((plan["pub_floats"],), device=dev, dtype=torch.float32)
        flags = torch.zeros((plan["flags"],), device=dev, dtype=torch.int32)
        (r0, w0, g0), (r1, w1, g1) = dirs[0], dirs[-1]
        fn = build.bind("rnn_wide", "lstm_rec_bwd_wide_cluster_f32", 10, 9)
        build.check(fn(g0.data_ptr(), g1.data_ptr(), w0.data_ptr(), w1.data_ptr(), cs.data_ptr(),
                       g_hs.data_ptr(), dg[0].data_ptr(), dg[-1].data_ptr(), pub.data_ptr(),
                       flags.data_ptr(), T, B, H, n, int(r0), int(r1), plan["units_per_cta"],
                       plan["grid"][0], plan["batch_rows"], build.stream()), "lstm_rec_bwd_wide")
        lstm_rec_bwd_wide.launches += 1
    elif plan is not None:
        ints = plan["units_per_cta"], plan["chunk"], plan["rows_smem"]
        wt = [w.t().contiguous() for _, w, _ in dirs]
        dh, dc = (torch.empty((n, B, H), device=dev, dtype=torch.float32) for _ in range(2))
        bar = _barrier(dev)
        (r0, _, g0), (r1, _, g1) = dirs[0], dirs[-1]
        fn = build.bind("rnn_wide", "lstm_rec_bwd_wide_f32", 11, 9)
        build.check(fn(g0.data_ptr(), g1.data_ptr(), wt[0].data_ptr(), wt[-1].data_ptr(),
                       cs.data_ptr(), g_hs.data_ptr(), dg[0].data_ptr(), dg[-1].data_ptr(),
                       dh.data_ptr(), dc.data_ptr(), bar.data_ptr(), T, B, H, n, int(r0), int(r1),
                       *ints, build.stream()), "lstm_rec_bwd_wide")
        lstm_rec_bwd_wide.launches += 1
    return dg[0], (dg[1] if n > 1 else None)


@counted(lambda w_hh_f, w_hh_b, gates_f, gates_b, cs, g_hs: _scan_flops(w_hh_f, w_hh_b, gates_f))
def bilstm_rec_bwd(w_hh_f, w_hh_b, gates_f, gates_b, cs, g_hs):
    """K7: the LSTM backward recurrence of one or both directions in one
    launch. ``gates_*`` (T, B, 4H) are the gate pre-activations ``x_proj +
    h_prev @ W_hh^T``; ``cs``, ``g_hs`` (T, B, nH) hold the directions side
    by side, forward first. Returns (dgates_f, dgates_b or None)."""
    if not gates_f.is_cuda:
        return bilstm_rec_bwd_plain(w_hh_f, w_hh_b, gates_f, gates_b, cs, g_hs)
    dirs = _dirs(w_hh_f, w_hh_b, gates_f, gates_b)
    T, B, H4 = gates_f.shape
    H = H4 // 4
    for _, w_hh, gates in dirs:
        build.require(gates, (T, B, 4 * H), "lstm_rec_bwd gates")
        build.require(w_hh, (4 * H, H), "lstm_rec_bwd w_hh")
    build.require(cs, (T, B, len(dirs) * H), "lstm_rec_bwd cs")
    build.require(g_hs, (T, B, len(dirs) * H), "lstm_rec_bwd g_hs")
    if lstm_route(H) == "wide":
        return lstm_rec_bwd_wide(dirs, cs, g_hs)
    if any(w.data_ptr() % 16 for _, w, _ in dirs):
        raise ValueError("lstm_rec_bwd: expected a 16-byte aligned w_hh")
    plan = lstm_bwd_plan(B, H, len(dirs), max_clusters(H, "lstm_rec_bwd"))
    dg = [torch.empty_like(gates_f) for _ in dirs]
    if T and B:
        (r0, w0, g0), (r1, w1, g1) = dirs[0], dirs[-1]
        fn = build.bind("rnn", "lstm_rec_bwd_f32", 8, 7)
        build.check(fn(g0.data_ptr(), g1.data_ptr(), w0.data_ptr(), w1.data_ptr(), cs.data_ptr(),
                       g_hs.data_ptr(), dg[0].data_ptr(), dg[-1].data_ptr(), T, B, H, len(dirs),
                       int(r0), int(r1), plan["rows"], build.stream()), "lstm_rec_bwd")
        bilstm_rec_bwd.launches += 1
    return dg[0], (dg[1] if len(dg) > 1 else None)


bilstm_rec_bwd.launches = 0
lstm_rec_bwd_wide.launches = 0


def gru_rec_plain(reverse: bool, w_hh, b_hh, x_proj):
    """x_proj (T, B, 3H) -> hs (T, B, H); gates r, z, n with b_hn inside r."""
    T, B, H3 = x_proj.shape
    H = H3 // 3
    h = x_proj.new_zeros((B, H))
    hs = x_proj.new_empty((T, B, H))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hp = h @ w_hh.T + b_hh
        xr, xz, xn = x_proj[t].split(H, dim=-1)
        hr, hz, hn = hp.split(H, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        hs[t] = h
    return hs


def bigru_rec_plain(w_hh_f, w_hh_b, b_hh_f, b_hh_b, x_proj_f, x_proj_b):
    return torch.cat([gru_rec_plain(*d) for d in _dirs(w_hh_f, w_hh_b, b_hh_f, b_hh_b, x_proj_f,
                                                        x_proj_b)], dim=-1)


def _launch_gru(wrapper, dirs):
    """One K2 launch over ``dirs`` = [(reverse, w_hh, b_hh, x_proj)] (1 or 2),
    counted on ``wrapper``."""
    T, B, H3 = dirs[0][3].shape
    H = H3 // 3
    for _, w_hh, b_hh, x_proj in dirs:
        build.require(x_proj, (T, B, 3 * H), "gru_rec x_proj")
        build.require(w_hh, (3 * H, H), "gru_rec w_hh")
        build.require(b_hh, (3 * H,), "gru_rec b_hh")
    if gru_route(H) == "wide":
        return gru_rec_wide(dirs)
    gru_plan(B, H, len(dirs))
    hs = torch.empty((T, B, len(dirs) * H), device=dirs[0][3].device, dtype=torch.float32)
    if T == 0 or B == 0:
        return hs
    (r0, w0, b0, x0), (r1, w1, b1, x1) = dirs[0], dirs[-1]
    fn = build.bind("rnn", "gru_rec_f32", 7, 6)
    build.check(fn(x0.data_ptr(), x1.data_ptr(), w0.data_ptr(), w1.data_ptr(), b0.data_ptr(),
                   b1.data_ptr(), hs.data_ptr(), T, B, H, len(dirs), int(r0), int(r1),
                   build.stream()), "gru_rec")
    wrapper.launches += 1
    return hs


def gru_rec_wide(dirs):
    """K2w: one launch over ``dirs`` = [(reverse, w_hh, b_hh, x_proj)]
    (checked by the caller) at any H, of the design `wide_fwd_plan` picks;
    returns hs (T, B, nH)."""
    T, B, H3 = dirs[0][3].shape
    H, n, dev = H3 // 3, len(dirs), dirs[0][3].device
    hs = torch.empty((T, B, n * H), device=dev, dtype=torch.float32)
    if T and B:
        plan = wide_design_plan("gru", B, H, n, dev)
        (r0, w0, b0, x0), (r1, w1, b1, x1) = dirs[0], dirs[-1]
        ptrs = (x0.data_ptr(), x1.data_ptr(), w0.data_ptr(), w1.data_ptr(), b0.data_ptr(),
                b1.data_ptr(), hs.data_ptr())
        if plan["design"] == "cluster":
            # scratch: h and its step a word, by step parity, zeroed
            words = torch.zeros((plan["words"],), device=dev, dtype=torch.int64)
            fn = build.bind("rnn_wide", "gru_rec_wide_cluster_f32", 8, 8)
            build.check(fn(*ptrs, words.data_ptr(), T, B, H, n, int(r0), int(r1),
                           plan["units_per_cta"], plan["grid"][0], build.stream()), "gru_rec_wide")
        else:
            fn = build.bind("rnn_wide", "gru_rec_wide_f32", 8, 9)
            build.check(fn(*ptrs, _barrier(dev).data_ptr(), T, B, H, n, int(r0), int(r1),
                           plan["units_per_cta"], plan["chunk"], plan["rows_smem"],
                           build.stream()), "gru_rec_wide")
        gru_rec_wide.launches += 1
    return hs


@counted(lambda reverse, w_hh, b_hh, x_proj: _scan_flops(w_hh, None, x_proj))
def gru_rec(reverse: bool, w_hh, b_hh, x_proj):
    """Forward of `semi_tts_tpu.ops.rnn._gru_rec`: one launch per call."""
    if not x_proj.is_cuda:
        return gru_rec_plain(reverse, w_hh, b_hh, x_proj)
    return _launch_gru(gru_rec, [(reverse, w_hh, b_hh, x_proj)])


@counted(lambda w_hh_f, w_hh_b, b_hh_f, b_hh_b, x_proj_f, x_proj_b:
         _scan_flops(w_hh_f, w_hh_b, x_proj_f))
def bigru_rec(w_hh_f, w_hh_b, b_hh_f, b_hh_b, x_proj_f, x_proj_b):
    """Both directions of a BiGRU in one launch: (T, B, 2H), forward first;
    ``w_hh_b``, ``b_hh_b`` and ``x_proj_b`` None run the forward direction
    alone, (T, B, H)."""
    if not x_proj_f.is_cuda:
        return bigru_rec_plain(w_hh_f, w_hh_b, b_hh_f, b_hh_b, x_proj_f, x_proj_b)
    return _launch_gru(bigru_rec, _dirs(w_hh_f, w_hh_b, b_hh_f, b_hh_b, x_proj_f, x_proj_b))


gru_rec.launches = 0
bigru_rec.launches = 0
gru_rec_wide.launches = 0


def gru_rec_bwd_plain(reverse: bool, w_hh, z, coef_h, g_hs):
    """One direction of `_gru_rec_bwd`'s recurrence: the update gate ``z``
    (T, B, H), the coefficients ``coef_h`` (T, B, 3H) and the gradient
    ``g_hs`` of hs (T, B, H) -> dh2 (T, B, H), the time axis walked opposite
    to the forward."""
    T, B, H = z.shape
    dh_rec = z.new_zeros((B, H))
    dh2 = z.new_empty((T, B, H))
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        d = g_hs[t] + dh_rec
        dh2[t] = d
        dh_rec = d * z[t] + (coef_h[t] * d.repeat(1, 3)) @ w_hh
    return dh2


def bigru_rec_bwd_plain(w_hh_f, w_hh_b, z_f, z_b, coef_f, coef_b, g_hs):
    H = w_hh_f.shape[1]
    out = [gru_rec_bwd_plain(r, w, z, c, g_hs[..., k * H:(k + 1) * H])
           for k, (r, w, z, c) in enumerate(_dirs(w_hh_f, w_hh_b, z_f, z_b, coef_f, coef_b))]
    return out[0], (out[1] if len(out) > 1 else None)


def gru_rec_bwd_wide(dirs, g_hs):
    """K8w: one launch over ``dirs`` = [(reverse, w_hh, z, coef_h)] (checked
    by the caller) at any H, of the design `wide_bwd_plan` picks; returns
    (dh2_f, dh2_b or None). The cluster design reads W_hh's gate rows as
    they are; the first design reads its columns as rows of W_hh^T,
    transposed here."""
    T, B, H = dirs[0][2].shape
    n, dev = len(dirs), dirs[0][2].device
    dh2 = [torch.empty_like(dirs[0][2]) for _ in dirs]
    if T and B:
        plan = wide_design_plan("gru_bwd", B, H, n, dev)
        (r0, w0, z0, c0), (r1, w1, z1, c1) = dirs[0], dirs[-1]
        if plan["design"] == "cluster":
            # scratch: the clusters' published sums; their step flags, zeroed
            pub = torch.empty((plan["pub_floats"],), device=dev, dtype=torch.float32)
            flags = torch.zeros((plan["flags"],), device=dev, dtype=torch.int32)
            fn = build.bind("rnn_wide", "gru_rec_bwd_wide_cluster_f32", 11, 9)
            build.check(fn(z0.data_ptr(), z1.data_ptr(), c0.data_ptr(), c1.data_ptr(),
                           w0.data_ptr(), w1.data_ptr(), g_hs.data_ptr(), dh2[0].data_ptr(),
                           dh2[-1].data_ptr(), pub.data_ptr(), flags.data_ptr(), T, B, H, n,
                           int(r0), int(r1), plan["units_per_cta"], plan["grid"][0],
                           plan["batch_rows"], build.stream()), "gru_rec_bwd_wide")
        else:
            ints = plan["units_per_cta"], plan["chunk"], plan["rows_smem"]
            wt = [w.t().contiguous() for _, w, _, _ in dirs]
            dh = torch.empty((n, B, H), device=dev, dtype=torch.float32)
            v = torch.empty((2, n, B, 3 * H), device=dev, dtype=torch.float32)
            bar = _barrier(dev)
            fn = build.bind("rnn_wide", "gru_rec_bwd_wide_f32", 12, 9)
            build.check(fn(z0.data_ptr(), z1.data_ptr(), c0.data_ptr(), c1.data_ptr(),
                           wt[0].data_ptr(), wt[-1].data_ptr(), g_hs.data_ptr(), dh2[0].data_ptr(),
                           dh2[-1].data_ptr(), dh.data_ptr(), v.data_ptr(), bar.data_ptr(), T, B,
                           H, n, int(r0), int(r1), *ints, build.stream()), "gru_rec_bwd_wide")
        gru_rec_bwd_wide.launches += 1
    return dh2[0], (dh2[1] if n > 1 else None)


@counted(lambda w_hh_f, w_hh_b, z_f, z_b, coef_f, coef_b, g_hs: _scan_flops(w_hh_f, w_hh_b, z_f))
def bigru_rec_bwd(w_hh_f, w_hh_b, z_f, z_b, coef_f, coef_b, g_hs):
    """K8: the GRU backward recurrence of one or both directions in one
    launch. ``z_*`` (T, B, H) and ``coef_*`` (T, B, 3H) are the update gates
    and the hidden-side coefficients ``[cr, cz, dn_c * r]`` that
    `_gru_rec_bwd` recomputes; ``g_hs`` (T, B, nH) holds the directions side
    by side, forward first; ``w_hh_b``, ``z_b`` and ``coef_b`` None run the
    forward direction alone. Returns (dh2_f, dh2_b or None), each (T, B, H)."""
    if not z_f.is_cuda:
        return bigru_rec_bwd_plain(w_hh_f, w_hh_b, z_f, z_b, coef_f, coef_b, g_hs)
    dirs = _dirs(w_hh_f, w_hh_b, z_f, z_b, coef_f, coef_b)
    T, B, H = z_f.shape
    for _, w_hh, z, coef in dirs:
        build.require(z, (T, B, H), "gru_rec_bwd z")
        build.require(coef, (T, B, 3 * H), "gru_rec_bwd coef_h")
        build.require(w_hh, (3 * H, H), "gru_rec_bwd w_hh")
    build.require(g_hs, (T, B, len(dirs) * H), "gru_rec_bwd g_hs")
    if gru_route(H) == "wide":
        return gru_rec_bwd_wide(dirs, g_hs)
    gru_bwd_plan(B, H, len(dirs))
    dh = [torch.empty_like(z_f) for _ in dirs]
    if T and B:
        (r0, w0, z0, c0), (r1, w1, z1, c1) = dirs[0], dirs[-1]
        fn = build.bind("rnn", "gru_rec_bwd_f32", 9, 6)
        build.check(fn(z0.data_ptr(), z1.data_ptr(), c0.data_ptr(), c1.data_ptr(), w0.data_ptr(),
                       w1.data_ptr(), g_hs.data_ptr(), dh[0].data_ptr(), dh[-1].data_ptr(), T, B,
                       H, len(dirs), int(r0), int(r1), build.stream()), "gru_rec_bwd")
        bigru_rec_bwd.launches += 1
    return dh[0], (dh[1] if len(dh) > 1 else None)


bigru_rec_bwd.launches = 0
gru_rec_bwd_wide.launches = 0
