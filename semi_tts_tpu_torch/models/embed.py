"""Shared phoneme codebook (counterpart of `semi_tts_tpu/models/embed.py`):
the configuration, the parameters, the text side `codebook_inference` and
the speech side `codebook_forward`, which quantizes ASR latents with a
straight-through gradient (``enc + picked - enc.detach()``)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.init import normal
from .common import Linear, linear


@dataclasses.dataclass(frozen=True)
class CodebookConfig:
    """Mirror of the YAML `model.codebook` block."""

    bone: str = "l2"  # 'l2' | 'seperate'
    vocab_size: int = 43
    latent_dim: int = 64
    commit_weight: float = 0.0
    vq_weight: float = 0.0
    temp: float = 1.0
    skip_prob: float = 0.0
    stop_grad: bool = True
    softmax: str = "normal"
    use_phn_attr: bool = True
    attr_dim: int = 31
    proj_attr: int = 16

    @property
    def out_dim(self) -> int:
        return self.latent_dim

    @property
    def learn_dim(self) -> int:
        return self.latent_dim - (self.proj_attr if self.use_phn_attr else 0)


class Codebook(nn.Module):
    """Parameters of the JAX ``codebook_init`` tree: ``learnable_table``
    (l2 bone) or ``embedding`` + ``asr_final`` (seperate bone), plus
    ``proj_attr`` and a learnable ``temp`` where the config asks for them."""

    def __init__(self, cfg: CodebookConfig, generator=None):
        super().__init__()
        if cfg.commit_weight != 0 or cfg.vq_weight != 0:
            raise ValueError("codebook commit_weight/vq_weight must be 0: the commit/VQ "
                             "losses are not implemented")
        if cfg.temp < 0:
            self.temp = nn.Parameter(torch.ones(1))
        if cfg.use_phn_attr:
            self.proj_attr = Linear(cfg.attr_dim, cfg.proj_attr, init="torch", generator=generator)
        if cfg.bone == "l2":
            self.learnable_table = nn.Parameter(normal((cfg.vocab_size, cfg.learn_dim), generator))
        elif cfg.bone == "seperate":
            self.asr_final = Linear(cfg.latent_dim, cfg.vocab_size, init="torch", generator=generator)
            self.embedding = nn.Parameter(normal((cfg.vocab_size, cfg.learn_dim), generator))
        else:
            raise NotImplementedError(cfg.bone)


def codebook_inference(cb: Codebook, cfg: CodebookConfig, txt, phn_attr=None):
    """Text ids (B, L) -> latent vectors (B, L, latent_dim)."""
    table = cb.learnable_table if cfg.bone == "l2" else cb.embedding
    emb = table[txt]
    if cfg.use_phn_attr:
        emb = torch.cat([emb, linear(cb.proj_attr, phn_attr[txt])], dim=-1)
    return emb


def neg_batch_l2(x, table):
    """-||x - e||^2 for every codebook entry: x (..., D), table (V, D) ->
    (..., V)."""
    x2 = (x ** 2).sum(-1, keepdim=True)
    e2 = (table ** 2).sum(-1)
    return -(x2 + e2 - 2.0 * x @ table.T)


def _full_table(cb: Codebook, cfg: CodebookConfig, phn_attr, *, detach=False):
    """The l2 table (V, latent_dim): learnable part ++ projected attributes."""
    table = cb.learnable_table
    if cfg.use_phn_attr:
        table = torch.cat([table, linear(cb.proj_attr, phn_attr)], dim=-1)
    return table.detach() if detach else table


def full_codebook_table(cb: Codebook, cfg: CodebookConfig, phn_attr=None):
    """The whole embedding table (V, latent_dim), the learnable part and
    the projected attributes, as the TensorBoard projector shows it."""
    if cfg.bone == "l2":
        return _full_table(cb, cfg, phn_attr)
    emb = cb.embedding
    if cfg.use_phn_attr:
        emb = torch.cat([emb, linear(cb.proj_attr, phn_attr)], dim=-1)
    return emb


def codebook_forward(cb: Codebook, cfg: CodebookConfig, enc_embs, *, phn_attr=None,
                     first_n_real_mel: int = 0, train: bool = False, generator=None):
    """Encoder latents (B, S, D) -> (p_code (B, S, V), quantized (B, S, D)).

    ``first_n_real_mel``: leading batch rows that are real mel; for the rest
    the table is detached so their p_code cannot move the codebook."""
    if cfg.bone == "seperate":
        p_code = torch.softmax(linear(cb.asr_final, enc_embs), dim=-1)
        picked = p_code.argmax(-1)
        if cfg.stop_grad:
            new_latent = cb.embedding[picked]
            if cfg.use_phn_attr:
                new_latent = torch.cat([new_latent, linear(cb.proj_attr, phn_attr[picked])], -1)
        else:
            onehot = F.one_hot(picked, cfg.vocab_size).to(p_code.dtype)
            p_hard = p_code + (onehot - p_code).detach()
            new_latent = p_hard @ cb.embedding
            if cfg.use_phn_attr:
                new_latent = torch.cat([new_latent, linear(cb.proj_attr, p_hard @ phn_attr)], -1)
        return p_code, new_latent

    table = _full_table(cb, cfg, phn_attr)
    temp = torch.relu(cb.temp) if cfg.temp < 0 else float(cfg.temp)  # a fixed temp is >= 0
    if first_n_real_mel > 0:
        table_d = _full_table(cb, cfg, phn_attr, detach=True)
        similarity = torch.cat([temp * neg_batch_l2(enc_embs[:first_n_real_mel], table),
                                temp * neg_batch_l2(enc_embs[first_n_real_mel:], table_d)], 0)
    else:
        similarity = temp * neg_batch_l2(enc_embs, table)
    p_code = torch.softmax(similarity, dim=-1)
    picked = p_code.argmax(-1)
    if cfg.stop_grad:
        picked_code = table[picked]
    else:
        onehot = F.one_hot(picked, cfg.vocab_size).to(p_code.dtype)
        picked_code = (p_code + (onehot - p_code).detach()) @ table
    quantized = enc_embs + picked_code - enc_embs.detach()
    if train and cfg.skip_prob > 0:
        u = torch.rand((), generator=generator, device=enc_embs.device)
        quantized = torch.where(u < cfg.skip_prob, enc_embs, quantized)
    return p_code, quantized
