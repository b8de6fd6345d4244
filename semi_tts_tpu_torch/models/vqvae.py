"""VQVAE composite (counterpart of `semi_tts_tpu/models/vqvae.py`): the
configuration, the parameters (ASR encoder and postnet, codebook, speaker
table, TTS), `speech_to_text`, `embed_text` and `text_to_speech`.
`config_from_yaml` reads the YAML ``model`` block."""

from __future__ import annotations

import dataclasses
from typing import Optional

from torch import nn

from ..ops.init import normal
from .asr import ASR, ASRConfig, ASRPostnet, asr_apply, asr_postnet_apply
from .decoder import DecoderConfig
from .embed import Codebook, CodebookConfig, codebook_forward, codebook_inference
from .tts import TTS, TTSConfig, tts_apply

FRAME_PHN_RATIO = 6.0  # mel frames per phoneme for text-only decode budgets


@dataclasses.dataclass(frozen=True)
class VQVAEConfig:
    n_mels: int = 80
    linear_dim: Optional[int] = 1025
    vocab_size: int = 43
    n_spkr: int = 109
    spkr_latent_dim: int = 128
    max_frames_per_phn: int = 3
    stop_threshold: float = 0.5
    txt_update_codebook: bool = False
    asr_postnet_weight: float = 0.0
    encoder: ASRConfig = dataclasses.field(default_factory=ASRConfig)
    codebook: CodebookConfig = dataclasses.field(default_factory=CodebookConfig)
    tts: TTSConfig = dataclasses.field(default_factory=TTSConfig)

    @property
    def use_asr_postnet(self) -> bool:
        return self.asr_postnet_weight > 0

    @property
    def latent_dim(self) -> int:
        return self.codebook.latent_dim

    @property
    def time_reduce_factor(self) -> int:
        return self.encoder.time_reduce_factor

    @property
    def n_frames_per_step(self) -> int:
        return self.tts.decoder.n_frames_per_step


def config_from_yaml(model_cfg: dict, *, n_mels: int, linear_dim, vocab_size: int,
                     n_spkr: int, attr_dim: int = 31) -> VQVAEConfig:
    """VQVAEConfig from the YAML ``model`` block (a dict), with the JAX
    package's field names and defaults."""
    enc = dict(model_cfg["encoder"])
    cb = dict(model_cfg["codebook"])
    dec = dict(model_cfg["decoder"])
    latent_dim = cb["latent_dim"]
    enc_cfg = ASRConfig(
        in_dim=n_mels, out_dim=latent_dim, dim=enc["dim"],
        kernel=tuple(enc["kernel"]), stride=tuple(enc["stride"]),
        residual=tuple(enc["residual"]), dropout=enc["dropout"],
        activation=enc["activation"], batch_norm=enc["batch_norm"],
        rnn_bid=enc["rnn_bid"], rnn_layers=enc["rnn_layers"],
        rnn_dim=enc["rnn_dim"], layer_norm=enc["layer_norm"],
    )
    phn_attr_pth = cb.get("phn_attr_pth") or ""
    cb_cfg = CodebookConfig(
        bone=cb["bone"], vocab_size=vocab_size, latent_dim=latent_dim,
        commit_weight=cb["commit_weight"], vq_weight=cb["vq_weight"],
        temp=cb["temp"], skip_prob=cb["skip_prob"], stop_grad=cb["stop_grad"],
        softmax=cb["softmax"], use_phn_attr=phn_attr_pth != "",
        attr_dim=attr_dim, proj_attr=cb.get("proj_attr") or 0,
    )
    d = dec["decoder"]
    dec_cfg = DecoderConfig(
        n_mels=n_mels, n_frames_per_step=d["n_frames_per_step"],
        enc_embed_dim=dec["encoder"]["enc_embed_dim"],
        spkr_embed_dim=model_cfg["spkr_latent_dim"],
        prenet_dim=d["prenet_dim"], prenet_dropout=d["prenet_dropout"],
        query_rnn_dim=d["query_rnn_dim"], dec_rnn_dim=d["dec_rnn_dim"],
        query_dropout=d["query_dropout"], dec_dropout=d["dec_dropout"],
        attn_dim=d["attn_dim"], n_location_filters=d["n_location_filters"],
        location_kernel_size=d["location_kernel_size"], loc_aware=d["loc_aware"],
        use_summed_weights=d["use_summed_weights"], drop_dec_in=d["drop_dec_in"],
        spkr_embed_mode=d.get("spkr_embed_mode", "adaIN").lower(),
        mask_attention=d.get("mask_attention", False),
    )
    tts_cfg = TTSConfig(
        n_mels=n_mels, linear_dim=linear_dim, in_embed_dim=latent_dim,
        spkr_embed_dim=model_cfg["spkr_latent_dim"],
        separate_postnet=dec.get("separate_postnet", False),
        enc_n_conv=dec["encoder"]["enc_n_conv"],
        enc_kernel_size=dec["encoder"]["enc_kernel_size"],
        enc_rnn_layer=dec["encoder"]["enc_rnn_layer"],
        enc_embed_dim=dec["encoder"]["enc_embed_dim"],
        enc_dropout=dec["encoder"]["enc_dropout"],
        decoder=dec_cfg,
    )
    return VQVAEConfig(
        n_mels=n_mels, linear_dim=linear_dim, vocab_size=vocab_size, n_spkr=n_spkr,
        spkr_latent_dim=model_cfg["spkr_latent_dim"],
        max_frames_per_phn=model_cfg["max_frames_per_phn"],
        stop_threshold=model_cfg["stop_threshold"],
        txt_update_codebook=model_cfg.get("txt_update_codebook", False),
        asr_postnet_weight=model_cfg.get("asr_postnet_weight", 0.0),
        encoder=enc_cfg, codebook=cb_cfg, tts=tts_cfg,
    )


class VQVAE(nn.Module):
    """ASR encoder (and ASR postnet when its loss weight is above 0) +
    codebook + speaker table (``spkr_embed``, N(0, 1)) + TTS, with the
    parameter paths of the JAX ``vqvae_init`` tree. Fresh parameters follow
    the JAX init rules, drawn from ``generator`` (a CPU `torch.Generator`);
    move the module to its device afterwards."""

    def __init__(self, cfg: VQVAEConfig, generator=None):
        super().__init__()
        self.asr = ASR(cfg.encoder, generator=generator)
        if cfg.use_asr_postnet:
            self.asr_postnet = ASRPostnet(cfg.latent_dim, cfg.latent_dim, generator=generator)
        self.codebook = Codebook(cfg.codebook, generator=generator)
        self.spkr_embed = nn.Parameter(normal((cfg.n_spkr, cfg.spkr_latent_dim), generator))
        self.tts = TTS(cfg.tts, generator=generator)


def speech_to_text(model: VQVAE, cfg: VQVAEConfig, phn_attr, all_mel, *, paired_bs: int,
                   first_n_real_mel: int = 0, train: bool, generator=None):
    """ASR-encode a mel batch (B, T, n_mels) and quantize it ->
    (p_code (B, T', V), quantized (B, T', D), post_prob of the first
    ``paired_bs`` rows or None). In train mode the BN running statistics are
    updated in place."""
    latents = asr_apply(model.asr, all_mel, cfg=cfg.encoder, train=train, generator=generator)
    post_prob = None
    if cfg.use_asr_postnet:
        post_prob = asr_postnet_apply(model.asr_postnet, latents[:paired_bs], train=train,
                                      generator=generator)
    p_code, quantized = codebook_forward(model.codebook, cfg.codebook, latents,
                                         phn_attr=phn_attr, first_n_real_mel=first_n_real_mel,
                                         train=train, generator=generator)
    return p_code, quantized, post_prob


def embed_text(model: VQVAE, cfg: VQVAEConfig, phn_attr, txt):
    """Text ids -> codebook latents."""
    return codebook_inference(model.codebook, cfg.codebook, txt, phn_attr)


def text_to_speech(model: VQVAE, cfg: VQVAEConfig, all_latent, all_sid, *, decode_steps: int,
                   latent_lengths=None, generator=None, train: bool = False, teacher=None,
                   teacher_rows=None, tf_rate: float = 1.0, wgrad_probes=None):
    """Decode a latent batch -> (mel, linear, align, stop), plus the
    decoder's ``aux`` with ``wgrad_probes``; free-running without a
    ``teacher``. ``all_sid``: (B,) speaker ids; the other arguments are
    `tts_apply`'s."""
    spkr = model.spkr_embed[all_sid]
    return tts_apply(model.tts, all_latent, spkr, cfg=cfg.tts, decode_steps=decode_steps,
                     txt_lengths=latent_lengths, generator=generator, train=train,
                     teacher=teacher, teacher_rows=teacher_rows, tf_rate=tf_rate,
                     wgrad_probes=wgrad_probes)

