"""Tacotron2 autoregressive decoder, inference path (counterpart of
`semi_tts_tpu/models/decoder.py` `decoder_apply` with ``teacher=None``,
``tf_rate=0`` and ``train=False``).

Each step: prenet of the previous frame group (dropout always on) -> query
LSTMCell -> location-sensitive attention (kernel K3) -> speaker adaIN ->
decoder LSTMCell -> mel projection and stop gate. The step-invariant work
(speaker memory projection, processed memory, adaIN statistics, mask) is
hoisted out of the loop as in the JAX scan. Teacher forcing, the weight-
gradient probes and rematerialisation belong to the training slice.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

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


def decoder_apply(dec: Decoder, memory, spkr_embed, *, cfg: DecoderConfig, decode_steps: int,
                  memory_lengths=None, generator=None):
    """Free-running decode for ``decode_steps`` macro-steps.

    memory (B, L, enc_embed_dim); spkr_embed (B, spkr_embed_dim);
    memory_lengths (B,) masks attention at positions >= length when
    ``cfg.mask_attention``. ``generator`` drives the prenet dropout.
    Returns (mel (B, steps*r, M), align (B, steps, L), stop (B, steps*r)).
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
    dec_in = prenet(dec.prenet, zeros((B, r * M)), cfg.prenet_dropout, generator)
    q_h, q_c = zeros((B, cfg.query_rnn_dim)), zeros((B, cfg.query_rnn_dim))
    d_h, d_c = zeros((B, cfg.dec_rnn_dim)), zeros((B, cfg.dec_rnn_dim))
    attn_w, attn_w_sum = zeros((B, L)), zeros((B, L))
    ctx = zeros((B, cfg.enc_embed_dim))
    mels, aligns, stops = [], [], []
    for _ in range(decode_steps):
        q_h, q_c = lstm_cell(dec.query_rnn, torch.cat([dec_in, ctx], -1), q_h, q_c)
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
        d_h, d_c = lstm_cell(dec.dec_rnn, torch.cat([ctx, adapted], -1), d_h, d_c)
        hc = torch.cat([d_h, ctx], -1)
        mel_out = linear(dec.proj, hc).reshape(B, r, M)
        stops.append(linear(dec.gate, hc).repeat_interleave(r, dim=1))  # (B, r)
        mels.append(mel_out)
        aligns.append(w)
        dec_in = prenet(dec.prenet, mel_out.reshape(B, r * M), cfg.prenet_dropout, generator)
    mel = torch.stack(mels, dim=1).reshape(B, decode_steps * r, M)
    align = torch.stack(aligns, dim=1)
    stop = torch.stack(stops, dim=1).reshape(B, decode_steps * r)
    return mel, align, stop
