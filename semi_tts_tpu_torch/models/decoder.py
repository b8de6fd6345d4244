"""Tacotron2 autoregressive decoder (counterpart of
`semi_tts_tpu/models/decoder.py` `decoder_apply`), free-running and
teacher-forced.

Each step: prenet of the previous frame group (dropout always on) -> query
LSTMCell -> location-sensitive attention (kernel K3, backward K9) -> speaker
adaIN -> decoder LSTMCell -> mel projection and stop gate -> scheduled
sampling of the next input. The step-invariant work (speaker memory
projection, processed memory, adaIN statistics, mask, the teacher's prenet)
is hoisted out of the loop as in the JAX scan. The weight-gradient probes
(`wgrad_probes`, `assemble_wgrads`, `merge_wgrads`) form the two LSTM
cells' weight gradients with one product each after the loop. JAX's
``remat`` has no counterpart: autograd keeps every step's activations.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import dropout
from ..ops.rnn import LSTMParams, lstm_cell
from .attention import Attention, attention_step, process_memory
from .common import Linear, linear, prenet, prenet_init


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Mirror of the YAML `model.decoder.decoder` block."""

    n_mels: int = 80
    n_frames_per_step: int = 3
    enc_embed_dim: int = 512
    spkr_embed_dim: int = 128
    prenet_dim: int = 256
    prenet_dropout: float = 0.5
    query_rnn_dim: int = 1024
    dec_rnn_dim: int = 1024
    query_dropout: float = 0.1
    dec_dropout: float = 0.1
    attn_dim: int = 256
    n_location_filters: int = 32
    location_kernel_size: int = 31
    loc_aware: bool = True
    use_summed_weights: bool = True
    drop_dec_in: float = 0.0
    spkr_embed_mode: str = "adain"
    pretrain: bool = False
    mask_attention: bool = False


class Decoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, generator=None):
        super().__init__()
        g = generator
        r, M = cfg.n_frames_per_step, cfg.n_mels
        E = cfg.enc_embed_dim
        self.prenet = prenet_init(M * r, (cfg.prenet_dim, cfg.prenet_dim), generator=g)
        self.query_rnn = LSTMParams(cfg.prenet_dim + E, cfg.query_rnn_dim, g)
        self.attn = Attention(cfg.query_rnn_dim, E, cfg.attn_dim, cfg.n_location_filters,
                              cfg.location_kernel_size, loc_aware=cfg.loc_aware,
                              use_summed_weights=cfg.use_summed_weights, generator=g)
        self.dec_rnn = LSTMParams(cfg.query_rnn_dim + E, cfg.dec_rnn_dim, g)
        self.proj = Linear(cfg.dec_rnn_dim + E, M * r, generator=g)
        self.gate = Linear(cfg.dec_rnn_dim + E, 1, w_init_gain="sigmoid", generator=g)
        mode = cfg.spkr_embed_mode.lower()
        S = cfg.spkr_embed_dim
        if mode == "adain":
            self.pseudo_mean = Linear(S, cfg.query_rnn_dim, init="torch", generator=g)
            self.pseudo_std = Linear(S, cfg.query_rnn_dim, init="torch", generator=g)
        elif mode == "concat":
            self.spkr_mem_proj = Linear(S + E, E, init="torch", generator=g)
        elif mode == "add":
            self.spkr_proj = Linear(S, E, init="torch", generator=g)
            self.spkr_mem_proj = Linear(E, E, init="torch", generator=g)
        else:
            raise NotImplementedError(mode)


def wgrad_probes(cfg: DecoderConfig, decode_steps: int, B: int, device=None):
    """Zero per-step gate probes of the two LSTM cells, leaves that require
    grad: pass them to `decoder_apply(wgrad_probes=...)` and differentiate
    with respect to them."""
    def zeros(H):
        return torch.zeros((decode_steps, B, 4 * H), device=device, requires_grad=True)

    return {"q": zeros(cfg.query_rnn_dim), "d": zeros(cfg.dec_rnn_dim)}


def assemble_wgrads(aux, probe_grads):
    """The LSTM weight gradients from the probes' gradients (the gate
    gradients, (steps, B, 4H)) and the stacked cell inputs ``aux``
    (concat(x_t, h_{t-1}), (steps, B, D + H)): one product per cell, split
    into {query_rnn, dec_rnn: {w_ih, w_hh}}."""
    out = {}
    for name, key in (("query_rnn", "q"), ("dec_rnn", "d")):
        g = probe_grads[key]
        H = g.shape[-1] // 4
        in_dim = aux[key].shape[-1] - H
        d_cat = g.reshape(-1, 4 * H).T @ aux[key].reshape(-1, aux[key].shape[-1])
        out[name] = {"w_ih": d_cat[:, :in_dim], "w_hh": d_cat[:, in_dim:]}
    return out


def merge_wgrads(dec: Decoder, grads: dict, aux, probe_grads) -> dict:
    """Add the batched LSTM weight gradients into ``grads``, a dict from
    parameter to its gradient (None where autograd did not reach, as the
    detached cell weights under the probes); returns it."""
    for name, sub in assemble_wgrads(aux, probe_grads).items():
        cell = getattr(dec, name)
        for k, v in sub.items():
            p = getattr(cell, k)
            grads[p] = v if grads.get(p) is None else grads[p] + v
    return grads


def decoder_apply(dec: Decoder, memory, spkr_embed, *, cfg: DecoderConfig, decode_steps: int,
                  memory_lengths=None, generator=None, train: bool = False, teacher=None,
                  teacher_rows=None, tf_rate: float = 1.0, coins=None, wgrad_probes=None):
    """Run the decoder for ``decode_steps`` macro-steps.

    memory (B, L, enc_embed_dim); spkr_embed (B, spkr_embed_dim);
    memory_lengths (B,) masks attention at positions >= length when
    ``cfg.mask_attention``. ``generator`` drives every random draw: prenet
    dropout (always on), in ``train`` mode the dropout of the query and
    decoder cells' outputs, and the scheduled-sampling coins.

    ``teacher`` (B, T_t*r, M): ground-truth mel, projected through the prenet
    for all steps at once (one dropout mask); step t then feeds teacher frame
    min(t, T_t - 1), or the teacher prenet's mean over time when the step's
    second coin is below ``cfg.drop_dec_in``, or the step's own output when
    its first coin is above ``tf_rate``. ``teacher_rows`` (B,) bool: rows
    without a teacher always feed their own output. ``coins`` (steps, 2):
    the coins to use instead of drawing them (one pair a step, shared across
    the batch, as JAX draws them).

    Returns (mel (B, steps*r, M), align (B, steps, L), stop (B, steps*r)),
    and with ``wgrad_probes`` (from `wgrad_probes`) also ``aux``, the
    stacked cell inputs that `assemble_wgrads` needs; the cells' weight
    matrices are then detached.
    """
    B, L, _ = memory.shape
    r, M = cfg.n_frames_per_step, cfg.n_mels
    mode = cfg.spkr_embed_mode.lower()

    if mode == "concat":
        mem = linear(dec.spkr_mem_proj,
                     torch.cat([memory, spkr_embed[:, None, :].expand(B, L, spkr_embed.shape[-1])], -1))
    elif mode == "add":
        mem = linear(dec.spkr_mem_proj, memory + linear(dec.spkr_proj, spkr_embed)[:, None, :])
    else:
        mem = memory
    mem = mem.contiguous()
    processed_memory = process_memory(dec.attn, mem)
    attn_mask = None
    if cfg.mask_attention and memory_lengths is not None:
        attn_mask = torch.arange(L, device=memory.device)[None, :] >= memory_lengths[:, None]
    if mode == "adain":
        ada_mean = linear(dec.pseudo_mean, spkr_embed)
        ada_std = F.relu(linear(dec.pseudo_std, spkr_embed))

    zeros = memory.new_zeros
    if teacher is not None:
        T_t = teacher.shape[1] // r
        teacher_pre = prenet(dec.prenet, teacher.reshape(B, T_t, r * M), cfg.prenet_dropout,
                             generator)                                  # (B, T_t, P)
        teacher_mean = teacher_pre.mean(1)
        t_rows = None if teacher_rows is None else teacher_rows[:, None].to(memory.dtype)
        if coins is None:  # one host transfer for all steps' coins
            coins = torch.rand((decode_steps, 2), generator=generator, device=memory.device)
        coins = torch.as_tensor(coins).tolist()
    dec_in = prenet(dec.prenet, zeros((B, r * M)), cfg.prenet_dropout, generator)
    q_h, q_c = zeros((B, cfg.query_rnn_dim)), zeros((B, cfg.query_rnn_dim))
    d_h, d_c = zeros((B, cfg.dec_rnn_dim)), zeros((B, cfg.dec_rnn_dim))
    attn_w, attn_w_sum = zeros((B, L)), zeros((B, L))
    ctx = zeros((B, cfg.enc_embed_dim))
    use_probes = wgrad_probes is not None
    if use_probes:  # one unbind: autograd stacks the steps' probe gradients once
        probes_q, probes_d = wgrad_probes["q"].unbind(0), wgrad_probes["d"].unbind(0)
    mels, aligns, stops, aux_q, aux_d = [], [], [], [], []
    for t in range(decode_steps):
        q_in = torch.cat([dec_in, ctx], -1)
        if use_probes:
            aux_q.append(torch.cat([q_in, q_h], -1))
        q_h, q_c = lstm_cell(dec.query_rnn, q_in, q_h, q_c,
                             probe=probes_q[t] if use_probes else None, stop_w=use_probes)
        q_h = dropout(q_h, cfg.query_dropout, enabled=train, generator=generator)
        if cfg.pretrain:  # audio-LM pretraining: no conditioning
            ctx, w = torch.zeros_like(ctx), torch.zeros_like(attn_w)
        else:
            if cfg.use_summed_weights:
                hist = torch.stack([attn_w, attn_w_sum], dim=1)         # (B, 2, L)
            else:
                hist = attn_w[:, None, :]
            ctx, w = attention_step(dec.attn, q_h, mem, processed_memory, hist, mask=attn_mask)
        attn_w, attn_w_sum = w, attn_w_sum + w
        adapted = ada_std * (q_h - ada_mean) if mode == "adain" else q_h
        d_in = torch.cat([ctx, adapted], -1)
        if use_probes:
            aux_d.append(torch.cat([d_in, d_h], -1))
        d_h, d_c = lstm_cell(dec.dec_rnn, d_in, d_h, d_c,
                             probe=probes_d[t] if use_probes else None, stop_w=use_probes)
        d_h = dropout(d_h, cfg.dec_dropout, enabled=train, generator=generator)
        hc = torch.cat([d_h, ctx], -1)
        mel_out = linear(dec.proj, hc).reshape(B, r, M)
        stops.append(linear(dec.gate, hc).repeat_interleave(r, dim=1))  # (B, r)
        mels.append(mel_out)
        aligns.append(w)
        teach = None  # scheduled sampling: the teacher's frame when the first coin allows
        if teacher is not None and coins[t][0] <= tf_rate:
            teach = teacher_mean if coins[t][1] < cfg.drop_dec_in else teacher_pre[:, min(t, T_t - 1)]
        if teach is None or t_rows is not None:  # some row feeds its own output
            own = prenet(dec.prenet, mel_out.reshape(B, r * M), cfg.prenet_dropout, generator)
        if teach is None:
            dec_in = own
        else:
            dec_in = teach if t_rows is None else t_rows * teach + (1.0 - t_rows) * own
    mel = torch.stack(mels, dim=1).reshape(B, decode_steps * r, M)
    align = torch.stack(aligns, dim=1)
    stop = torch.stack(stops, dim=1).reshape(B, decode_steps * r)
    if use_probes:
        return mel, align, stop, {"q": torch.stack(aux_q).detach(), "d": torch.stack(aux_d).detach()}
    return mel, align, stop
