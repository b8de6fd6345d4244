"""Tacotron2 TTS model: text encoder + AR decoder + CBHG mel->linear
postnet (counterpart of `semi_tts_tpu/models/tts.py`), free-running and
in training."""

from __future__ import annotations

import dataclasses

from torch import nn

from .cbhg import CBHG, cbhg_apply
from .common import Linear, linear
from .decoder import Decoder, DecoderConfig, decoder_apply
from .encoder import Encoder, encoder_apply


@dataclasses.dataclass(frozen=True)
class TTSConfig:
    """Mirror of the YAML `model.decoder` block."""

    n_mels: int = 80
    linear_dim: int | None = 1025
    in_embed_dim: int = 64
    spkr_embed_dim: int = 128
    separate_postnet: bool = False
    enc_n_conv: int = 3
    enc_kernel_size: int = 5
    enc_rnn_layer: int = 1
    enc_embed_dim: int = 512
    enc_dropout: float = 0.0
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)


class Postnet(nn.Module):
    def __init__(self, n_mels, linear_dim, generator=None):
        super().__init__()
        self.cbhg = CBHG(n_mels, K=8, generator=generator)
        self.linear = Linear(n_mels * 2, linear_dim, init="torch", generator=generator)


class TTS(nn.Module):
    def __init__(self, cfg: TTSConfig, generator=None):
        super().__init__()
        self.encoder = Encoder(cfg.in_embed_dim, cfg.enc_embed_dim, cfg.enc_n_conv,
                               cfg.enc_rnn_layer, cfg.enc_kernel_size, generator=generator)
        self.decoder = Decoder(cfg.decoder, generator=generator)
        if cfg.linear_dim is not None:
            self.postnet = Postnet(cfg.n_mels, cfg.linear_dim, generator=generator)


def tts_apply(p: TTS, txt_embed, spkr_embed, *, cfg: TTSConfig, decode_steps: int,
              txt_lengths=None, generator=None, train: bool = False, teacher=None,
              teacher_rows=None, tf_rate: float = 1.0, wgrad_probes=None):
    """txt_embed (B, L, in_embed_dim) codebook latents -> (mel, linear,
    align, stop), plus the decoder's ``aux`` with ``wgrad_probes``;
    ``linear`` is None when the model has no postnet. ``train``: batch
    statistics in every BatchNorm (the running ones updated in place) and
    dropout; the teacher arguments are `decoder_apply`'s.
    ``cfg.separate_postnet`` detaches the postnet's input."""
    memory = encoder_apply(p.encoder, txt_embed, dropout_rate=cfg.enc_dropout, train=train,
                           generator=generator)
    out = decoder_apply(p.decoder, memory, spkr_embed, cfg=cfg.decoder,
                        decode_steps=decode_steps, memory_lengths=txt_lengths,
                        generator=generator, train=train, teacher=teacher,
                        teacher_rows=teacher_rows, tf_rate=tf_rate, wgrad_probes=wgrad_probes)
    mel, align, stop = out[:3]
    lin = None
    if hasattr(p, "postnet"):
        post_in = mel.detach() if cfg.separate_postnet else mel
        lin = linear(p.postnet.linear, cbhg_apply(p.postnet.cbhg, post_in, train=train))
    return (mel, lin, align, stop) + tuple(out[3:])
