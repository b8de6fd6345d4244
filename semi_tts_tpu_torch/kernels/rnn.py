"""K1 `lstm_rec` and K2 `gru_rec`: the sequence recurrences over
pre-projected inputs, in the JAX layout (x_proj (T, B, G*H), W_hh (G*H, H)).

Each wrapper launches `csrc/rnn.cu` for CUDA tensors and runs its plain
PyTorch version only for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build


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


def lstm_rec(reverse: bool, w_hh, x_proj):
    """Forward of `semi_tts_tpu.ops.rnn._lstm_rec`: one launch per call."""
    if not x_proj.is_cuda:
        return lstm_rec_plain(reverse, w_hh, x_proj)
    T, B, H4 = x_proj.shape
    H = H4 // 4
    build.require(x_proj, (T, B, 4 * H), "lstm_rec x_proj")
    build.require(w_hh, (4 * H, H), "lstm_rec w_hh")
    hs = torch.empty((T, B, H), device=x_proj.device, dtype=torch.float32)
    if T == 0 or B == 0:
        return hs
    fn = build.bind("rnn", "lstm_rec_f32", 3, 4)
    build.check(fn(x_proj.data_ptr(), w_hh.data_ptr(), hs.data_ptr(), T, B, H,
                   int(reverse), build.stream()), "lstm_rec")
    lstm_rec.launches += 1
    return hs


lstm_rec.launches = 0


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


def gru_rec(reverse: bool, w_hh, b_hh, x_proj):
    """Forward of `semi_tts_tpu.ops.rnn._gru_rec`: one launch per call."""
    if not x_proj.is_cuda:
        return gru_rec_plain(reverse, w_hh, b_hh, x_proj)
    T, B, H3 = x_proj.shape
    H = H3 // 3
    build.require(x_proj, (T, B, 3 * H), "gru_rec x_proj")
    build.require(w_hh, (3 * H, H), "gru_rec w_hh")
    build.require(b_hh, (3 * H,), "gru_rec b_hh")
    hs = torch.empty((T, B, H), device=x_proj.device, dtype=torch.float32)
    if T == 0 or B == 0:
        return hs
    fn = build.bind("rnn", "gru_rec_f32", 4, 4)
    build.check(fn(x_proj.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), hs.data_ptr(),
                   T, B, H, int(reverse), build.stream()), "gru_rec")
    gru_rec.launches += 1
    return hs


gru_rec.launches = 0
