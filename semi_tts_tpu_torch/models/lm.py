"""Language models for pretraining (counterpart of `semi_tts_tpu/models/lm.py`).

* `AudioLM`: the TTS decoder in ``pretrain`` mode (attention bypassed, no
  text or speaker conditioning), teacher-forced over a mel, plus the CBHG
  postnet and its linear layer. Its trees graft into a VQVAE's
  ``tts/decoder`` and ``tts/postnet``.
* `TextLM`: a causal phoneme LM whose output distribution is the softmax of
  the negative squared L2 distance to the codebook table it pretrains
  (``learnable_table``), with ``EPS`` inside the log.
* `RNNLM`: an embedding, stacked LSTM or GRU layers and a projection, with
  the log-softmax of the negative distance to the embedding table.
* `DenoisingLM`: an embedding, a conv stack and the same measurement.
* `NgramPrior`: the KL divergence of CTC posteriors from an n-gram table,
  reduced by token, sentence or batch.

The recurrent layers run one direction each (`ops.rnn.lstm_layer`,
`gru_layer`: K1/K7 and K2/K8). Parameters are named as the JAX trees'
leaves, so `bridge.load_jax_params` and `to_jax_params` map them leaf for
leaf; the audio LM's BatchNorm statistics are its ``postnet`` state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import dropout
from ..ops.init import normal
from ..ops.rnn import GRUParams, LSTMParams, gru_layer, lstm_layer
from .cbhg import cbhg_apply
from .common import Conv1d, Linear, conv1d, linear
from .decoder import Decoder, DecoderConfig, decoder_apply
from .embed import neg_batch_l2
from .tts import Postnet

EPS = 1e-10


def _next_token_nll(logp, txt, txt_len):
    """Mean NLL of ``txt[:, 1:]`` under ``logp`` (B, U-1, V), over the
    first ``txt_len - 1`` targets of each row."""
    tgt = txt[:, 1:]
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    mask = (torch.arange(tgt.shape[1], device=txt.device)[None, :]
            < (txt_len - 1)[:, None]).to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------- RNNLM ----------------

class RNNLM(nn.Module):
    """``emb`` (V, E), ``rnn`` (layers of LSTM or GRU parameters), ``post``
    (dim -> E, no bias)."""

    def __init__(self, vocab_size: int, emb_dim: int, module: str = "lstm", dim: int = 512,
                 n_layers: int = 2, generator=None):
        super().__init__()
        g = generator
        self.cell = module.lower()
        cls = LSTMParams if self.cell == "lstm" else GRUParams
        self.emb = nn.Parameter(normal((vocab_size, emb_dim), g))
        self.rnn = nn.ModuleList(cls(emb_dim if i == 0 else dim, dim, g) for i in range(n_layers))
        self.post = Linear(dim, emb_dim, bias=False, init="torch", generator=g)


def rnnlm_apply(m: RNNLM, txt, *, drop_rate: float = 0.0, train: bool = True, generator=None):
    """txt (B, U) -> next-token log-probs (B, U, V)."""
    h = m.emb[txt]
    if drop_rate > 0:
        h = dropout(h, drop_rate, enabled=train, generator=generator)
    layer = lstm_layer if m.cell == "lstm" else gru_layer
    for p in m.rnn:
        h = layer(p, h)
    return F.log_softmax(neg_batch_l2(linear(m.post, h), m.emb), dim=-1)


def rnnlm_loss(m: RNNLM, txt, txt_len, *, train: bool = True, generator=None):
    """Shifted next-token NLL, masked past each row's ``txt_len - 1``."""
    return _next_token_nll(rnnlm_apply(m, txt[:, :-1], train=train, generator=generator),
                           txt, txt_len)


# ---------------- TextLM (codebook pretraining) ----------------

class TextLM(nn.Module):
    """``in_emb`` (V, D), ``rnn`` (LSTM layers of ``rnn_dim`` units),
    ``proj`` (rnn_dim -> D) and ``learnable_table`` (V, D), the codebook
    table it pretrains."""

    def __init__(self, vocab_size: int, latent_dim: int, *, rnn_dim: int = 256,
                 n_layers: int = 1, generator=None):
        super().__init__()
        g = generator
        self.in_emb = nn.Parameter(normal((vocab_size, latent_dim), g))
        self.rnn = nn.ModuleList(LSTMParams(latent_dim if i == 0 else rnn_dim, rnn_dim, g)
                                 for i in range(n_layers))
        self.proj = Linear(rnn_dim, latent_dim, init="torch", generator=g)
        self.learnable_table = nn.Parameter(normal((vocab_size, latent_dim), g))


def textlm_apply(m: TextLM, txt):
    """txt (B, U) -> log(softmax(-L2(h, learnable_table)) + EPS), (B, U, V)."""
    h = m.in_emb[txt]
    for p in m.rnn:
        h = lstm_layer(p, h)
    h = linear(m.proj, h)
    return torch.log(torch.softmax(neg_batch_l2(h, m.learnable_table), dim=-1) + EPS)


def textlm_loss(m: TextLM, txt, txt_len):
    return _next_token_nll(textlm_apply(m, txt[:, :-1]), txt, txt_len)


# ---------------- DenoisingLM ----------------

class DenoisingLM(nn.Module):
    """``text_to_fake_wave`` (V, in_dim), ``convs`` (kernel 3; ``channels``
    wide, the last ``latent_dim``) and ``emb`` (V, latent_dim)."""

    def __init__(self, vocab_size: int, in_dim: int, latent_dim: int, *, channels: int = 256,
                 n_conv: int = 3, generator=None):
        super().__init__()
        g = generator
        self.text_to_fake_wave = nn.Parameter(normal((vocab_size, in_dim), g))
        dims = [in_dim] + [channels] * (n_conv - 1) + [latent_dim]
        self.convs = nn.ModuleList(Conv1d(a, b, 3, generator=g) for a, b in zip(dims, dims[1:]))
        self.emb = nn.Parameter(normal((vocab_size, latent_dim), g))


def denoising_lm_apply(m: DenoisingLM, txt):
    """Text -> conv encoder (ReLU between convs) -> neg-L2 log-probs."""
    h = m.text_to_fake_wave[txt]
    for i, c in enumerate(m.convs):
        h = conv1d(c, h)
        if i < len(m.convs) - 1:
            h = F.relu(h)
    return F.log_softmax(neg_batch_l2(h, m.emb), dim=-1)


# ---------------- NgramPrior ----------------

@dataclasses.dataclass(frozen=True)
class NgramPrior:
    """KL divergence of CTC posteriors from an n-gram table. ``table``: for
    n > 1 a (vocab^(n-1), vocab) row-stochastic array, for n == 1 a (vocab,)
    unigram distribution. ``reduction``: token, sentence or batch."""

    vocab_size: int
    n_gram: int
    weight: float
    reduction: str = "token"
    start_step: int = 0

    @staticmethod
    def load_table(path):
        return torch.from_numpy(np.load(path)) + EPS

    def compute_loss(self, table, enc_prob, enc_len):
        """enc_prob (B, T, V) posteriors, enc_len (B,) -> the scalar loss."""
        B, T, V = enc_prob.shape
        dev = enc_prob.device
        if self.n_gram > 1:
            idx = enc_prob.detach().argmax(-1)
            # prefix: zero pad, <sos> = 1, then the codes shifted by one
            idx = torch.cat([idx.new_zeros((B, max(0, self.n_gram - 2))), idx.new_ones((B, 1)),
                             idx[:, :-1]], dim=-1)
            powers = torch.tensor([self.vocab_size ** (self.n_gram - 2 - i)
                                   for i in range(self.n_gram - 1)], dtype=idx.dtype, device=dev)
            t0 = (torch.arange(T, device=dev)[:, None]
                  + torch.arange(self.n_gram - 1, device=dev)[None, :])
            prior = table[(idx[:, t0] * powers).sum(-1)]                  # (B, T, V)
        else:
            prior = table[None, None, :].expand(B, T, V)
        mask = torch.arange(T, device=dev)[None, :, None] >= enc_len[:, None, None]
        prior = torch.where(mask, torch.full_like(prior, EPS), prior)
        lens = enc_len.to(torch.float32)
        if self.reduction == "token":
            kld = -(enc_prob * torch.log(prior)).sum(-1)
            return (kld.sum(-1) / lens).mean()
        if self.reduction == "sentence":
            ep = enc_prob.sum(1) / lens[:, None]
            pp = prior.sum(1) / lens[:, None]
            return (-ep * torch.log(pp)).sum(-1).mean()
        if self.reduction == "batch":
            ep = (enc_prob.sum(1) / lens[:, None]).mean(0)
            pp = (prior.sum(1) / lens[:, None]).mean(0)
            return (-ep * torch.log(pp)).sum()
        raise NotImplementedError(self.reduction)


# ---------------- AudioLM ----------------

class AudioLM(nn.Module):
    """``decoder`` (a `Decoder` of ``dec_cfg`` with ``pretrain`` set) and,
    given ``linear_dim``, ``postnet`` (CBHG with K=8 and its linear layer to
    ``linear_dim`` bins). ``cfg`` is the decoder configuration it runs."""

    def __init__(self, dec_cfg: DecoderConfig, linear_dim=None, generator=None):
        super().__init__()
        self.cfg = dataclasses.replace(dec_cfg, pretrain=True)
        self.decoder = Decoder(self.cfg, generator=generator)
        if linear_dim is not None:
            self.postnet = Postnet(self.cfg.n_mels, linear_dim, generator=generator)


def audiolm_apply(m: AudioLM, mel_teacher, *, train: bool = True, generator=None, coins=None,
                  wgrad_probes=None):
    """Teacher-forced unconditional decode over ``mel_teacher`` (B, T, M),
    T a multiple of r -> (mel_pred, linear_pred or None), and with
    ``wgrad_probes`` the decoder's ``aux`` (`decoder.merge_wgrads`).
    ``generator`` draws the prenet dropout, in ``train`` mode the decoder
    cells' dropout, and the coins unless ``coins`` are given; in ``train``
    mode the postnet's BatchNorms update their running statistics."""
    cfg = m.cfg
    B, T, _ = mel_teacher.shape
    memory = mel_teacher.new_zeros((B, 2, cfg.enc_embed_dim))
    spkr = mel_teacher.new_zeros((B, cfg.spkr_embed_dim))
    out = decoder_apply(m.decoder, memory, spkr, cfg=cfg, decode_steps=T // cfg.n_frames_per_step,
                        generator=generator, train=train, teacher=mel_teacher, tf_rate=1.0,
                        coins=coins, wgrad_probes=wgrad_probes)
    mel, lin = out[0], None
    if hasattr(m, "postnet"):
        lin = linear(m.postnet.linear, cbhg_apply(m.postnet.cbhg, mel, train=train))
    return (mel, lin) + ((out[3],) if wgrad_probes is not None else ())
