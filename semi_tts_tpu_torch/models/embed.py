"""Shared phoneme codebook, text side only (counterpart of
`semi_tts_tpu/models/embed.py`): the configuration, the parameters and
`codebook_inference`. The speech-side quantizer (`codebook_forward`) waits
for the ASR half of the port."""

from __future__ import annotations

import dataclasses

import torch
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
