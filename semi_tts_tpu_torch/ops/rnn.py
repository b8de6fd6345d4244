"""Recurrent primitives with torch gate math (counterpart of
`semi_tts_tpu/ops/rnn.py`): LSTM gates i, f, g, o; GRU gates r, z, n with
b_hn inside r. The input projection of a whole sequence is one GEMM outside
the recurrence; the recurrence itself runs in the K1/K2 kernels, both
directions of a bidirectional layer in one launch (past their plans, at
any H, in the wide routes K1w/K2w: the wrappers route, `kernels.rnn`).

When autograd records, an LSTM layer's recurrence is `lstm_rec_fn`, a
`torch.autograd.Function` as `_lstm_rec`'s custom VJP is: its forward runs
K1 with the cell states kept, its backward recomputes the gate
pre-activations with one GEMM per direction, runs the K7 backward
recurrence (K7w past its plan) and forms ``dW_hh = sum_t dgates_t^T
h_prev_t`` as one GEMM.
A GRU layer's recurrence is `gru_rec_fn`, the counterpart of `_gru_rec`'s
custom VJP: K2 forward; backward from the recomputed gates (one GEMM per
direction), the K8 (or K8w) backward recurrence, and dW_hh, db_hh and dx_proj as
one product or sum each. Both run one direction or two: `lstm_layer` and
`gru_layer` are the one-direction layers of the language models, the
counterparts of `_lstm_scan` and `_gru_scan`.

Parameters are `LSTMParams`/`GRUParams` modules named as the JAX pytree
leaves (``w_ih``, ``w_hh``, ``b_ih``, ``b_hh``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.rnn import (bigru_rec, bigru_rec_bwd, bilstm_rec, bilstm_rec_bwd, bilstm_rec_cs,
                           gru_rec, lstm_rec, shift_prev)
from .dropout import dropout as drop
from .init import uniform

__all__ = ["GRUParams", "LSTMParams", "bigru", "bigru_rec", "bilstm_rec", "gru_bwd_coefficients",
           "gru_layer", "gru_rec", "gru_rec_fn", "lstm_cell", "lstm_layer", "lstm_rec",
           "lstm_rec_fn", "multi_lstm", "multi_lstm_init"]


class _RNNParams(nn.Module):
    """torch-style U(-1/sqrt(H), 1/sqrt(H)) init for one direction/layer."""

    gates = 0

    def __init__(self, input_dim: int, hidden_dim: int, generator=None):
        super().__init__()
        s = 1.0 / math.sqrt(hidden_dim)
        G = self.gates * hidden_dim
        self.w_ih = nn.Parameter(uniform((G, input_dim), s, generator))
        self.w_hh = nn.Parameter(uniform((G, hidden_dim), s, generator))
        self.b_ih = nn.Parameter(uniform((G,), s, generator))
        self.b_hh = nn.Parameter(uniform((G,), s, generator))


class LSTMParams(_RNNParams):
    gates = 4


class GRUParams(_RNNParams):
    gates = 3


def lstm_cell(p: LSTMParams, x, h, c, *, probe=None, stop_w: bool = False):
    """One LSTMCell step. x: (B, D); h, c: (B, H). Returns (h', c').

    ``probe``/``stop_w``: the batched weight gradient of an autoregressive
    loop (`models.decoder.decoder_apply`). With the weight matrices detached
    and a zero ``probe`` (B, 4H) added to the gate pre-activations, the
    probe's gradient is the gate gradient, and the caller forms dW outside
    the loop with one product."""
    w_ih, w_hh = (p.w_ih.detach(), p.w_hh.detach()) if stop_w else (p.w_ih, p.w_hh)
    gates = x @ w_ih.T + p.b_ih + h @ w_hh.T + p.b_hh
    if probe is not None:
        gates = gates + probe
    i, f, g, o = gates.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return h2, c2


def _lstm_proj(p: LSTMParams, xs):
    """xs (B, T, D) -> x_proj (T, B, 4H); b_ih + b_hh are folded in."""
    return (xs @ p.w_ih.T + (p.b_ih + p.b_hh)).transpose(0, 1).contiguous()


def multi_lstm_init(input_dim: int, hidden_dim: int, num_layers: int,
                    bidirectional: bool, generator=None) -> nn.ModuleList:
    """Stacked (bi)LSTM parameters: a list of {"fwd"[, "bwd"]} layers."""
    layers = nn.ModuleList()
    d = input_dim
    for _ in range(num_layers):
        layer = nn.ModuleDict({"fwd": LSTMParams(d, hidden_dim, generator)})
        if bidirectional:
            layer["bwd"] = LSTMParams(d, hidden_dim, generator)
        layers.append(layer)
        d = hidden_dim * (2 if bidirectional else 1)
    return layers


class _LSTMRec(torch.autograd.Function):
    """The recurrence of one or two LSTM directions (the reversed one second,
    or None): x_proj (T, B, 4H) each -> hs (T, B, nH)."""

    @staticmethod
    def forward(ctx, w_hh_f, w_hh_b, x_proj_f, x_proj_b):
        hs, cs = bilstm_rec_cs(w_hh_f, w_hh_b, x_proj_f, x_proj_b)
        ctx.save_for_backward(w_hh_f, w_hh_b, x_proj_f, x_proj_b, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, g_hs):
        w_hh_f, w_hh_b, x_proj_f, x_proj_b, hs, cs = ctx.saved_tensors
        H = w_hh_f.shape[1]
        dirs = [(False, w_hh_f, x_proj_f)] + ([] if w_hh_b is None else [(True, w_hh_b, x_proj_b)])
        h_prev = [shift_prev(hs[..., k * H:(k + 1) * H], r) for k, (r, _, _) in enumerate(dirs)]
        gates = [x + hp @ w.T for (_, w, x), hp in zip(dirs, h_prev)]
        dgates = bilstm_rec_bwd(w_hh_f, w_hh_b, gates[0], gates[1] if len(gates) > 1 else None,
                                cs, g_hs.contiguous())
        dw = [dg.reshape(-1, 4 * H).T @ hp.reshape(-1, H) if dg is not None else None
              for dg, hp in zip(dgates, h_prev + [None])]
        return dw[0], dw[1], dgates[0], dgates[1]


def lstm_rec_fn(w_hh_f, w_hh_b, x_proj_f, x_proj_b):
    """Differentiable LSTM recurrence (K1 forward, K7 backward) of the
    forward direction and, unless ``w_hh_b`` is None, the reversed one."""
    return _LSTMRec.apply(w_hh_f, w_hh_b, x_proj_f, x_proj_b)


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def multi_lstm(layers: nn.ModuleList, xs, *, dropout: float = 0.0, train: bool = False,
               generator=None):
    """Stacked (bi)LSTM matching ``nn.LSTM(batch_first=True)``: in train
    mode, dropout at ``dropout`` on every layer's output but the last."""
    h = xs
    for li, layer in enumerate(layers):
        f = layer["fwd"]
        b = layer["bwd"] if "bwd" in layer else None
        x_f = _lstm_proj(f, h)
        x_b = None if b is None else _lstm_proj(b, h)
        if _records(x_f, f.w_hh) or (b is not None and _records(x_b, b.w_hh)):
            hs = lstm_rec_fn(f.w_hh, None if b is None else b.w_hh, x_f, x_b)
        elif b is not None:
            hs = bilstm_rec(f.w_hh, b.w_hh, x_f, x_b)
        else:
            hs = lstm_rec(False, f.w_hh, x_f)
        h = hs.transpose(0, 1)
        if li < len(layers) - 1:
            h = drop(h, dropout, enabled=train, generator=generator)
    return h


def _gru_proj(p: GRUParams, xs):
    """xs (B, T, D) -> x_proj (T, B, 3H); b_hh stays inside the recurrence
    (the b_hn-inside-r quirk)."""
    return (xs @ p.w_ih.T + p.b_ih).transpose(0, 1).contiguous()


def gru_bwd_coefficients(reverse: bool, w_hh, b_hh, x_proj, hs):
    """What `_gru_rec_bwd` recomputes from one direction's saved hs (T, B, H)
    with one GEMM: (h_prev, z, coef_h, coef_x), where every gate gradient is
    a coefficient times dh2: ``coef_h`` (T, B, 3H) the hidden-side ones
    (the reset gate inside, b_hn-inside-r) and ``coef_x`` the input-side."""
    H = hs.shape[-1]
    h_prev = shift_prev(hs, reverse)
    hp = h_prev @ w_hh.T + b_hh
    xr, xz, xn = x_proj.split(H, dim=-1)
    hr, hz, hn = hp.split(H, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    dn_c = (1.0 - z) * (1.0 - n * n)
    cr = dn_c * hn * r * (1.0 - r)
    cz = (h_prev - n) * z * (1.0 - z)
    return (h_prev, z.contiguous(), torch.cat([cr, cz, dn_c * r], dim=-1),
            torch.cat([cr, cz, dn_c], dim=-1))


class _GRURec(torch.autograd.Function):
    """The recurrence of one or two GRU directions (the reversed one second,
    or None): x_proj (T, B, 3H) each -> hs (T, B, nH)."""

    @staticmethod
    def forward(ctx, w_hh_f, w_hh_b, b_hh_f, b_hh_b, x_proj_f, x_proj_b):
        hs = bigru_rec(w_hh_f, w_hh_b, b_hh_f, b_hh_b, x_proj_f, x_proj_b)
        ctx.save_for_backward(w_hh_f, w_hh_b, b_hh_f, b_hh_b, x_proj_f, x_proj_b, hs)
        return hs

    @staticmethod
    def backward(ctx, g_hs):
        w_hh_f, w_hh_b, b_hh_f, b_hh_b, x_proj_f, x_proj_b, hs = ctx.saved_tensors
        H = w_hh_f.shape[1]
        dirs = [(False, w_hh_f, b_hh_f, x_proj_f)]
        if w_hh_b is not None:
            dirs.append((True, w_hh_b, b_hh_b, x_proj_b))
        co = [gru_bwd_coefficients(r, w, b, x, hs[..., k * H:(k + 1) * H])
              for k, (r, w, b, x) in enumerate(dirs)]
        one = len(co) == 1
        dh2 = bigru_rec_bwd(w_hh_f, w_hh_b, co[0][1], None if one else co[1][1], co[0][2],
                            None if one else co[1][2], g_hs.contiguous())
        out = []
        for (h_prev, _, coef_h, coef_x), d in zip(co, dh2):
            d3 = d.repeat(1, 1, 3)
            dhp = coef_h * d3
            out.append((dhp.reshape(-1, 3 * H).T @ h_prev.reshape(-1, H), dhp.sum((0, 1)),
                        coef_x * d3))
        (dw_f, db_f, dx_f), (dw_b, db_b, dx_b) = out[0], out[1] if not one else (None,) * 3
        return dw_f, dw_b, db_f, db_b, dx_f, dx_b


def gru_rec_fn(w_hh_f, w_hh_b, b_hh_f, b_hh_b, x_proj_f, x_proj_b):
    """Differentiable GRU recurrence (K2 forward, K8 backward) of the
    forward direction and, unless ``w_hh_b`` is None, the reversed one."""
    return _GRURec.apply(w_hh_f, w_hh_b, b_hh_f, b_hh_b, x_proj_f, x_proj_b)


def bigru(p: nn.ModuleDict, xs):
    f, b = p["fwd"], p["bwd"]
    args = (f.w_hh, b.w_hh, f.b_hh, b.b_hh, _gru_proj(f, xs), _gru_proj(b, xs))
    hs = gru_rec_fn(*args) if _records(*args) else bigru_rec(*args)
    return hs.transpose(0, 1)


def lstm_layer(p: LSTMParams, xs):
    """One forward LSTM direction over xs (B, T, D) -> (B, T, H), the
    counterpart of `_lstm_scan`: under autograd K1 with cell states and K7
    (`lstm_rec_fn` with no reversed direction), else K1 alone."""
    x = _lstm_proj(p, xs)
    hs = lstm_rec_fn(p.w_hh, None, x, None) if _records(x, p.w_hh) else lstm_rec(False, p.w_hh, x)
    return hs.transpose(0, 1)


def gru_layer(p: GRUParams, xs):
    """One forward GRU direction over xs (B, T, D) -> (B, T, H), the
    counterpart of `_gru_scan`: under autograd K2 and K8 run one direction
    (`gru_rec_fn` with no reversed direction), else K2 alone."""
    args = (p.w_hh, None, p.b_hh, None, _gru_proj(p, xs), None)
    hs = gru_rec_fn(*args) if _records(p.w_hh, p.b_hh, args[4]) else bigru_rec(*args)
    return hs.transpose(0, 1)
