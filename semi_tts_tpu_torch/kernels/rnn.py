"""K1 `lstm_rec` and K2 `gru_rec`: the sequence recurrences over
pre-projected inputs, in the JAX layout (x_proj (T, B, G*H), W_hh (G*H, H)).

`lstm_rec`/`gru_rec` run one direction, as `semi_tts_tpu.ops.rnn._lstm_rec`
and `_gru_rec` do; `bilstm_rec`/`bigru_rec` run a forward and a reversed
direction in one launch and return (T, B, 2H), forward first. Each wrapper
launches `csrc/rnn.cu` for CUDA tensors and runs its plain PyTorch version
only for CPU tensors. `lstm_plan` and `gru_plan` compute the launch plans
and name the hidden sizes each kernel takes.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

CLUSTER = 8                 # K1 CTAs per thread-block cluster
LANES = 8                   # lanes per hidden unit
LSTM_MAX_H = 288            # K1: 4*U gate rows of W_hh per CTA in shared memory
LSTM_ROWS = (1, 2, 4, 8)    # K1: batch rows per cluster
AHEAD = 4                   # x_proj steps staged in shared memory
GRU_MAX_H = 128             # K2: 8 lanes per hidden unit, at most 1024 threads
SMEM_PER_BLOCK = build.SMEM_PER_BLOCK


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check_lstm_h(H: int) -> None:
    if H % 4 or not 4 <= H <= LSTM_MAX_H:
        raise ValueError(f"lstm_rec kernel takes 4 <= H <= {LSTM_MAX_H} with H % 4 == 0, got H={H}")


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


def gru_plan(B: int, H: int, ndir: int) -> dict:
    """K2's launch plan: one block per batch row and direction, 8 lanes per
    hidden unit, W_hh in registers. Takes 1 <= H <= 128 and raises
    ValueError otherwise."""
    if not 1 <= H <= GRU_MAX_H:
        raise ValueError(f"gru_rec kernel takes 1 <= H <= {GRU_MAX_H}, got H={H}")
    return dict(grid=(B, ndir), threads=_round_up(LANES * H, 32),
                weights_per_lane=3 * 2 * math.ceil(H / 16), max_h=GRU_MAX_H)


@functools.lru_cache(maxsize=None)
def max_clusters(H: int) -> int:
    """How many K1 clusters fit on the current card at once, from
    ``cudaOccupancyMaxActiveClusters`` (asked with the largest rows)."""
    fn = build.load("rnn").lstm_rec_max_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn(H, LSTM_ROWS[-1])
    if n <= 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters for lstm_rec failed ({n})")
    return n


def lstm_rec_plain(reverse: bool, w_hh, x_proj):
    """x_proj (T, B, 4H) -> hs (T, B, H); gate order i, f, g, o."""
    T, B, H4 = x_proj.shape
    H = H4 // 4
    h = x_proj.new_zeros((B, H))
    c = x_proj.new_zeros((B, H))
    hs = x_proj.new_empty((T, B, H))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = x_proj[t] + h @ w_hh.T
        i, f, g, o = gates.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs[t] = h
    return hs


def bilstm_rec_plain(w_hh_f, w_hh_b, x_proj_f, x_proj_b):
    return torch.cat([lstm_rec_plain(False, w_hh_f, x_proj_f),
                      lstm_rec_plain(True, w_hh_b, x_proj_b)], dim=-1)


def _launch_lstm(dirs, rows):
    """One K1 launch over ``dirs`` = [(reverse, w_hh, x_proj)] (1 or 2)."""
    T, B, H4 = dirs[0][2].shape
    H = H4 // 4
    for _, w_hh, x_proj in dirs:
        build.require(x_proj, (T, B, 4 * H), "lstm_rec x_proj")
        build.require(w_hh, (4 * H, H), "lstm_rec w_hh")
        if w_hh.data_ptr() % 16 or x_proj.data_ptr() % 16:
            raise ValueError("lstm_rec: expected 16-byte aligned w_hh and x_proj")
    _check_lstm_h(H)
    plan = lstm_plan(B, H, len(dirs), max_clusters(H), rows)
    hs = torch.empty((T, B, len(dirs) * H), device=dirs[0][2].device, dtype=torch.float32)
    if T == 0 or B == 0:
        return hs
    (r0, w0, x0), (r1, w1, x1) = dirs[0], dirs[-1]
    fn = build.bind("rnn", "lstm_rec_f32", 5, 7)
    build.check(fn(x0.data_ptr(), x1.data_ptr(), w0.data_ptr(), w1.data_ptr(), hs.data_ptr(),
                   T, B, H, len(dirs), int(r0), int(r1), plan["rows"], build.stream()),
                "lstm_rec")
    return hs


def lstm_rec(reverse: bool, w_hh, x_proj):
    """Forward of `semi_tts_tpu.ops.rnn._lstm_rec`: one launch per call."""
    if not x_proj.is_cuda:
        return lstm_rec_plain(reverse, w_hh, x_proj)
    hs = _launch_lstm([(reverse, w_hh, x_proj)], None)
    lstm_rec.launches += 1
    return hs


def bilstm_rec(w_hh_f, w_hh_b, x_proj_f, x_proj_b, rows: int | None = None):
    """Both directions of a BiLSTM layer in one launch: (T, B, 2H), the
    forward direction in [..., :H] and the reversed one in [..., H:].
    ``rows`` overrides the plan's batch rows per cluster (for measuring)."""
    if not x_proj_f.is_cuda:
        return bilstm_rec_plain(w_hh_f, w_hh_b, x_proj_f, x_proj_b)
    hs = _launch_lstm([(False, w_hh_f, x_proj_f), (True, w_hh_b, x_proj_b)], rows)
    bilstm_rec.launches += 1
    return hs


lstm_rec.launches = 0
bilstm_rec.launches = 0


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
    return torch.cat([gru_rec_plain(False, w_hh_f, b_hh_f, x_proj_f),
                      gru_rec_plain(True, w_hh_b, b_hh_b, x_proj_b)], dim=-1)


def _launch_gru(dirs):
    """One K2 launch over ``dirs`` = [(reverse, w_hh, b_hh, x_proj)] (1 or 2)."""
    T, B, H3 = dirs[0][3].shape
    H = H3 // 3
    for _, w_hh, b_hh, x_proj in dirs:
        build.require(x_proj, (T, B, 3 * H), "gru_rec x_proj")
        build.require(w_hh, (3 * H, H), "gru_rec w_hh")
        build.require(b_hh, (3 * H,), "gru_rec b_hh")
    gru_plan(B, H, len(dirs))
    hs = torch.empty((T, B, len(dirs) * H), device=dirs[0][3].device, dtype=torch.float32)
    if T == 0 or B == 0:
        return hs
    (r0, w0, b0, x0), (r1, w1, b1, x1) = dirs[0], dirs[-1]
    fn = build.bind("rnn", "gru_rec_f32", 7, 6)
    build.check(fn(x0.data_ptr(), x1.data_ptr(), w0.data_ptr(), w1.data_ptr(), b0.data_ptr(),
                   b1.data_ptr(), hs.data_ptr(), T, B, H, len(dirs), int(r0), int(r1),
                   build.stream()), "gru_rec")
    return hs


def gru_rec(reverse: bool, w_hh, b_hh, x_proj):
    """Forward of `semi_tts_tpu.ops.rnn._gru_rec`: one launch per call."""
    if not x_proj.is_cuda:
        return gru_rec_plain(reverse, w_hh, b_hh, x_proj)
    hs = _launch_gru([(reverse, w_hh, b_hh, x_proj)])
    gru_rec.launches += 1
    return hs


def bigru_rec(w_hh_f, w_hh_b, b_hh_f, b_hh_b, x_proj_f, x_proj_b):
    """Both directions of a BiGRU in one launch: (T, B, 2H), forward first."""
    if not x_proj_f.is_cuda:
        return bigru_rec_plain(w_hh_f, w_hh_b, b_hh_f, b_hh_b, x_proj_f, x_proj_b)
    hs = _launch_gru([(False, w_hh_f, b_hh_f, x_proj_f), (True, w_hh_b, b_hh_b, x_proj_b)])
    bigru_rec.launches += 1
    return hs


gru_rec.launches = 0
bigru_rec.launches = 0
