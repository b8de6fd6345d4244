"""Step functions of the trainers (counterpart of
`semi_tts_tpu/train/steps.py`): feature extraction with the frame padding,
the CTC input lengths, the paired CTC and TTS losses, the paired
(supervised) train step, the unpaired cycles (the speech-first step on even
steps, the text-first step on odd ones) and the evaluation step.

A step draws its augmentation (SNRs, stretch rate, noise), its dropout and
prenet masks and its scheduled-sampling coins from one `torch.Generator` on
the model's device, seeded from (seed, step number) as the JAX step folds
the step number into its key. Building a step turns TF32 off (`use_fp32`),
so the card computes in the fp32 the CPU path does, and asks cuDNN for
deterministic algorithms (`use_deterministic`), so a step repeats bit for
bit. A cycle's escapes stay on the device: the speech-first step gates its
unpaired loss with the all-blank flag of trim/merge, and the text-first
step zeroes a non-finite unpaired CTC loss, each a multiplier or a select,
never a host branch.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import use_deterministic, use_fp32
from ..models import vqvae as V
from ..models.decoder import merge_wgrads, wgrad_probes
from ..ops.ctc import ctc_loss
from ..ops.quantize import padded_concat, trim_merge_segments
from .losses import freq_loss

EPS = 1e-10
SPEC_PAD_VALUE = 0.0


class Weights(NamedTuple):
    asr: float = 1.0
    tts: float = 1.0
    unpair_text: float = 0.0
    unpair_speech: float = 0.0
    unpair_text_start: int = 0
    unpair_speech_start: int = 0


def round_up(x, r):
    """Round ``x`` up to the next multiple of ``r``."""
    return x + (-x) % r


def _pad_frames(x, r):
    """Pad time (axis 1) to a multiple of ``r`` with at least one extra frame."""
    return F.pad(x, (0, 0, 0, r - x.shape[1] % r), value=SPEC_PAD_VALUE)


def _grads(model, total, probes, aux):
    """The gradients of ``total`` with respect to ``model.parameters()``
    (None where it does not reach), the decoder cells' weight gradients
    formed from the probes."""
    params = list(model.parameters())
    *grads, gq, gd = torch.autograd.grad(total, params + [probes["q"], probes["d"]],
                                         allow_unused=True)
    grads = merge_wgrads(model.tts.decoder, dict(zip(params, grads)), aux, {"q": gq, "d": gd})
    return [grads[p] for p in params]


def step_generator(seed: int, step_no: int, device) -> torch.Generator:
    """The generator of one step: a 64-bit mix of (seed, step_no)."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + int(step_no) * 0xBF58476D1CE4E5B9) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


class StepBuilder:
    """What the step functions share: model and audio configuration, the
    featurizer, the phonological attribute table, the loss weights, the
    spectrogram loss (``freq_loss_kwargs``: `freq_loss`'s keywords, whose
    ``sample_rate`` and ``n_mels`` default to the featurizer's and the
    model's, the rest to `freq_loss`'s defaults, the YAML ``hparas``
    defaults) and the CTC length rule. ``actual_len``: CTC input lengths
    from the non-pad frames instead of the full encoder length."""

    def __init__(self, cfg: V.VQVAEConfig, feat, phn_attr, *, weights: Weights = Weights(),
                 freq_loss_kwargs: dict | None = None, actual_len: bool = False):
        self.cfg = cfg
        self.feat = feat
        self.phn_attr = phn_attr
        self.w = weights
        floss = {"n_mels": cfg.n_mels}
        if feat is not None:
            floss["sample_rate"] = feat.cfg.sample_rate
        self.floss = partial(freq_loss, **{**floss, **(freq_loss_kwargs or {})})
        self.actual_len = actual_len
        self.r = cfg.n_frames_per_step

    def _features(self, waves, wave_len, generator=None, *, need_clean=True, need_aug=True,
                  augment=None):
        """(mel, linear, aug, flen, aug_flen); clean features padded to a
        multiple of ``r`` frames; what is not asked for is None. ``augment``:
        (snrs, rate, noise) to featurize with instead of drawing them from
        ``generator``."""
        mel = linear = flen = aug = aug_flen = None
        if need_clean:
            mel, linear, flen = self.feat.featurize(waves, wave_len)
            mel, linear = _pad_frames(mel, self.r), _pad_frames(linear, self.r)
        if need_aug and augment is None:
            aug, aug_flen = self.feat.featurize_augmented(waves, wave_len, generator)
        elif need_aug:
            aug, aug_flen = self.feat.featurize_augmented_at(waves, wave_len, *augment)
        return mel, linear, aug, flen, aug_flen

    def _enc_len(self, flen, t_enc):
        """Encoder output length of each row's real frames, at most t_enc."""
        up = -(-flen.to(torch.int64) // self.cfg.time_reduce_factor)
        return torch.clamp(up, max=t_enc)

    def _ctc_lengths(self, model_input, p_code):
        """Full encoder length by default; with ``actual_len`` the count of
        frames that are not all padding, over the time reduction."""
        B, T_enc = p_code.shape[0], p_code.shape[1]
        if not self.actual_len:
            return torch.full((B,), T_enc, dtype=torch.int32, device=p_code.device)
        pad = (model_input == SPEC_PAD_VALUE).sum(-1) == model_input.shape[-1]
        return ((~pad).sum(-1) // self.cfg.time_reduce_factor).to(torch.int32)

    def _paired_ctc(self, model_input, probs, text, *, apply_log=True):
        ctc_in = torch.log(probs + EPS) if apply_log else probs
        lens = self._ctc_lengths(model_input, probs)
        return ctc_loss(ctc_in, text, lens, (text != 0).sum(-1))

    def _losses_paired(self, model, mel, linear, aug_mel, text, sid, tf_rate, generator, *,
                       wgrad_probes=None):
        """Paired forward: ASR on the augmented features and CTC, then the
        TTS teacher-forced on the clean mel, and the weighted total.
        Returns (total, metrics, the decoder's aux or None)."""
        cfg = self.cfg
        B = mel.shape[0]
        p_code, _, post_prob = V.speech_to_text(model, cfg, self.phn_attr, aug_mel, paired_bs=B,
                                                train=True, generator=generator)
        asr_loss = self._paired_ctc(aug_mel, p_code, text)
        lat = V.embed_text(model, cfg, self.phn_attr, text)
        lat_len = (text != 0).sum(-1) + 1  # the non-pad tokens and the trailing <pad>
        out = V.text_to_speech(model, cfg, lat, sid, decode_steps=mel.shape[1] // self.r,
                               latent_lengths=lat_len, generator=generator, train=True,
                               teacher=mel, tf_rate=tf_rate, wgrad_probes=wgrad_probes)
        mel_pred, lin_pred, align = out[:3]
        mel_loss = self.floss(mel_pred, mel)
        lin_loss = self.floss(lin_pred, linear) if lin_pred is not None else mel_loss.new_zeros(())
        total = self.w.tts * (mel_loss + lin_loss)
        if cfg.use_asr_postnet:
            post_loss = self._paired_ctc(aug_mel, post_prob, text, apply_log=False)
            w = cfg.asr_postnet_weight
            total = total + self.w.asr * (1 - w) * asr_loss + self.w.asr * w * post_loss
        else:
            post_loss = mel_loss.new_zeros(())
            total = total + self.w.asr * asr_loss
        mets = dict(asr_loss=asr_loss.detach(), mel_loss=mel_loss.detach(),
                    linear_loss=lin_loss.detach(), tts_loss=(mel_loss + lin_loss).detach(),
                    post_loss=post_loss.detach(), pair_align=align.detach(),
                    pair_pred=p_code.detach().argmax(-1))
        return total, mets, (out[4] if wgrad_probes is not None else None)

    def paired_loss_and_grads(self, model, waves, wave_len, text, sid, tf_rate, generator, *,
                              augment=None):
        """The paired loss of one batch and its gradients with respect to
        ``model.parameters()`` (None where the loss does not reach), the
        decoder cells' weight gradients formed from the probes. Returns
        (total, metrics, grads)."""
        mel, linear, aug, _, aug_flen = self._features(waves, wave_len, generator,
                                                       augment=augment)
        probes = wgrad_probes(self.cfg.tts.decoder, mel.shape[1] // self.r, mel.shape[0],
                              mel.device)
        total, mets, aux = self._losses_paired(model, mel, linear, aug, text, sid, tf_rate,
                                               generator, wgrad_probes=probes)
        mets["pair_pred_len"] = self._enc_len(aug_flen, mets["pair_pred"].shape[1])
        return total.detach(), mets, _grads(model, total, probes, aux)

    def speech_first_loss_and_grads(self, model, step_no, tf_rate, batch, u_batch, generator, *,
                                    augment=None, u_augment=None, tokens=None):
        """The speech-first cycle (the JAX builder's even step): the ASR on
        the paired and unpaired augmented features packed into one batch,
        the paired CTC, trim/merge of the unpaired rows' quantized latents,
        the TTS teacher-forced on both batches' clean mels from the paired
        text's latents and the unpaired trimmed ones, the paired mel and
        linear losses and the unpaired reconstruction, gated on the device
        by trim/merge's ``ok`` (no row all blank) and ``step_no >
        unpair_speech_start``. ``batch``, ``u_batch``: (waves, wave_len,
        text, sid); ``augment``, ``u_augment``: each batch's (snrs, rate,
        noise), drawn from ``generator`` when None; ``tokens``: the unpaired
        rows' tokens for trim/merge instead of their argmax. Returns (total,
        metrics, grads) as `paired_loss_and_grads`."""
        cfg, r = self.cfg, self.r
        waves, wave_len, text, sid = batch
        u_waves, u_wave_len, _, u_sid = u_batch
        mel, linear, aug, _, aug_flen = self._features(waves, wave_len, generator, augment=augment)
        u_mel, u_linear, u_aug, _, u_aug_flen = self._features(u_waves, u_wave_len, generator,
                                                               augment=u_augment)
        Bp, Bu = mel.shape[0], u_mel.shape[0]
        # the decoder runs as many steps as the longer of the two teachers
        decode_steps = max(mel.shape[1], u_mel.shape[1]) // r
        probes = wgrad_probes(cfg.tts.decoder, decode_steps, Bp + Bu, mel.device)
        p_code, q, _ = V.speech_to_text(model, cfg, self.phn_attr, padded_concat(aug, u_aug),
                                        paired_bs=Bp, train=True, generator=generator)
        trf = cfg.time_reduce_factor
        pair_prob = p_code[:Bp, :aug.shape[1] // trf]
        u_latent, u_lens, ok = trim_merge_segments(p_code[Bp:], q[Bp:],
                                                   max_frames_per_phn=cfg.max_frames_per_phn,
                                                   tokens=tokens)
        asr_loss = self._paired_ctc(aug, pair_prob, text)
        pair_lat = V.embed_text(model, cfg, self.phn_attr, text)
        lat_len = torch.cat([(text != 0).sum(-1) + 1, u_lens.to(torch.int64)])
        mel_pred, lin_pred, align, _, aux = V.text_to_speech(
            model, cfg, padded_concat(pair_lat, u_latent), torch.cat([sid, u_sid]),
            decode_steps=decode_steps, latent_lengths=lat_len, generator=generator, train=True,
            teacher=padded_concat(mel, u_mel), tf_rate=tf_rate, wgrad_probes=probes)
        Tp, Tu = mel.shape[1], u_mel.shape[1]
        mel_loss = self.floss(mel_pred[:Bp, :Tp], mel)
        lin_loss = self.floss(lin_pred[:Bp, :Tp], linear)
        u_sph_loss = (self.floss(mel_pred[Bp:, :Tu], u_mel)
                      + self.floss(lin_pred[Bp:, :Tu], u_linear))
        gate = ok.to(mel.dtype) * float(step_no > self.w.unpair_speech_start)
        total = (self.w.asr * asr_loss + self.w.tts * (mel_loss + lin_loss)
                 + self.w.unpair_speech * gate * u_sph_loss)
        p_det = p_code.detach()
        mets = dict(asr_loss=asr_loss.detach(), mel_loss=mel_loss.detach(),
                    linear_loss=lin_loss.detach(), tts_loss=(mel_loss + lin_loss).detach(),
                    unpair_speech_loss=u_sph_loss.detach(), unpair_ok=ok,
                    pair_align=align[:Bp].detach(), unpair_align=align[Bp:].detach(),
                    pair_pred=pair_prob.detach().argmax(-1),
                    pair_pred_len=self._enc_len(aug_flen, pair_prob.shape[1]),
                    unpair_pred=p_det[Bp:].argmax(-1),
                    unpair_pred_len=self._enc_len(u_aug_flen, p_code.shape[1]))
        return total.detach(), mets, _grads(model, total, probes, aux)

    def text_first_loss_and_grads(self, model, tf_rate, batch, u_batch, generator, *,
                                  augment=None):
        """The text-first cycle (the JAX builder's odd step): the TTS on the
        paired and unpaired texts' latents, the paired rows teacher-forced
        on their clean mel and the unpaired rows fed their own output for
        ``round_up(FRAME_PHN_RATIO * U_u, r)`` frames, the paired mel and
        linear losses; then the ASR on the paired augmented features packed
        with the unpaired fake mel (detached; the codebook table detached
        for those rows), the paired CTC and the unpaired text's CTC, zeroed
        on the device where it is not finite (``ctc_nan``). ``batch``,
        ``u_batch``: (waves, wave_len, text, sid), of the unpaired batch
        only the text and sids are read. Returns (total, metrics, grads) as
        `paired_loss_and_grads`."""
        cfg, r = self.cfg, self.r
        waves, wave_len, text, sid = batch
        u_text, u_sid = u_batch[2], u_batch[3]
        mel, linear, aug, _, aug_flen = self._features(waves, wave_len, generator, augment=augment)
        Bp, Bu = mel.shape[0], u_text.shape[0]
        # the fake mel's length: FRAME_PHN_RATIO frames a token, rounded up to r
        u_ts = round_up(int(V.FRAME_PHN_RATIO * u_text.shape[1]), r)
        decode_steps = max(mel.shape[1] // r, u_ts // r)
        probes = wgrad_probes(cfg.tts.decoder, decode_steps, Bp + Bu, mel.device)
        pair_lat = V.embed_text(model, cfg, self.phn_attr, text)
        u_lat = V.embed_text(model, cfg, self.phn_attr, u_text)
        teacher = torch.cat([mel, mel.new_zeros((Bu,) + mel.shape[1:])])
        teacher_rows = torch.arange(Bp + Bu, device=mel.device) < Bp
        lat_len = torch.cat([(text != 0).sum(-1) + 1, (u_text != 0).sum(-1) + 1])
        mel_pred, lin_pred, align, _, aux = V.text_to_speech(
            model, cfg, padded_concat(pair_lat, u_lat), torch.cat([sid, u_sid]),
            decode_steps=decode_steps, latent_lengths=lat_len, generator=generator, train=True,
            teacher=teacher, teacher_rows=teacher_rows, tf_rate=tf_rate, wgrad_probes=probes)
        Tp = mel.shape[1]
        mel_loss = self.floss(mel_pred[:Bp, :Tp], mel)
        lin_loss = self.floss(lin_pred[:Bp, :Tp], linear)
        fake_mel = mel_pred[Bp:, :u_ts].detach()
        p_code, _, _ = V.speech_to_text(model, cfg, self.phn_attr, padded_concat(aug, fake_mel),
                                        paired_bs=Bp, first_n_real_mel=Bp, train=True,
                                        generator=generator)
        trf = cfg.time_reduce_factor
        pair_prob = p_code[:Bp, :aug.shape[1] // trf]
        u_prob = p_code[Bp:, :u_ts // trf]
        asr_loss = self._paired_ctc(aug, pair_prob, text)
        u_tlen = (u_text != 0).sum(-1)
        if self.actual_len:
            ctc_len = 1 + round_up(u_tlen * int(V.FRAME_PHN_RATIO), r) // trf
        else:
            ctc_len = torch.full((Bu,), u_prob.shape[1], dtype=torch.int32, device=mel.device)
        u_txt_loss = ctc_loss(torch.log(u_prob + EPS), u_text, ctc_len, u_tlen)
        ctc_nan = ~torch.isfinite(u_txt_loss)
        u_txt_loss = torch.where(ctc_nan, 0.0, u_txt_loss)
        total = (self.w.asr * asr_loss + self.w.tts * (mel_loss + lin_loss)
                 + self.w.unpair_text * u_txt_loss)
        mets = dict(asr_loss=asr_loss.detach(), mel_loss=mel_loss.detach(),
                    linear_loss=lin_loss.detach(), tts_loss=(mel_loss + lin_loss).detach(),
                    unpair_text_loss=u_txt_loss.detach(), ctc_nan=ctc_nan,
                    pair_align=align[:Bp].detach(), pair_pred=pair_prob.detach().argmax(-1),
                    pair_pred_len=self._enc_len(aug_flen, pair_prob.shape[1]))
        return total.detach(), mets, _grads(model, total, probes, aux)

    def make_paired_step(self, optimizer, *, seed: int = 0):
        """``paired_step(model, step_no, tf_rate, waves, wave_len, text, sid,
        augment=None)`` -> metrics (losses, grad_norm,
        pair_align, pair_pred, pair_pred_len); the parameters and the
        BatchNorm running statistics are updated in place. ``optimizer``
        holds ``model.parameters()`` in order."""
        use_fp32()
        use_deterministic()

        def paired_step(model, step_no, tf_rate, waves, wave_len, text, sid, *, augment=None):
            g = step_generator(seed, step_no, waves.device)
            total, mets, grads = self.paired_loss_and_grads(model, waves, wave_len, text, sid,
                                                            tf_rate, g, augment=augment)
            mets.update(total_loss=total, grad_norm=optimizer.step(grads))
            return mets

        return paired_step

    def make_speech_first_step(self, optimizer, *, seed: int = 0):
        """``speech_first_step(model, step_no, tf_rate, waves, wave_len, text,
        sid, u_waves, u_wave_len, u_text, u_sid, augment=None, u_augment=None,
        tokens=None)`` -> the metrics of `speech_first_loss_and_grads`, with
        total_loss and grad_norm; updates as `make_paired_step`'s step."""
        use_fp32()
        use_deterministic()

        def speech_first_step(model, step_no, tf_rate, waves, wave_len, text, sid, u_waves,
                              u_wave_len, u_text, u_sid, *, augment=None, u_augment=None,
                              tokens=None):
            g = step_generator(seed, step_no, waves.device)
            total, mets, grads = self.speech_first_loss_and_grads(
                model, step_no, tf_rate, (waves, wave_len, text, sid),
                (u_waves, u_wave_len, u_text, u_sid), g, augment=augment, u_augment=u_augment,
                tokens=tokens)
            mets.update(total_loss=total, grad_norm=optimizer.step(grads))
            return mets

        return speech_first_step

    def make_text_first_step(self, optimizer, *, seed: int = 0):
        """``text_first_step(model, step_no, tf_rate, waves, wave_len, text,
        sid, u_waves, u_wave_len, u_text, u_sid, augment=None)`` -> the
        metrics of `text_first_loss_and_grads`, with total_loss and
        grad_norm; updates as `make_paired_step`'s step."""
        use_fp32()
        use_deterministic()

        def text_first_step(model, step_no, tf_rate, waves, wave_len, text, sid, u_waves,
                            u_wave_len, u_text, u_sid, *, augment=None):
            g = step_generator(seed, step_no, waves.device)
            total, mets, grads = self.text_first_loss_and_grads(
                model, tf_rate, (waves, wave_len, text, sid), (u_waves, u_wave_len, u_text, u_sid),
                g, augment=augment)
            mets.update(total_loss=total, grad_norm=optimizer.step(grads))
            return mets

        return text_first_step

    def make_eval_step(self):
        """The dev-set step: clean features -> ``speech_to_text(train=False)``
        for PER, and a free-running decode of ``mel.shape[1] // r`` steps
        (``tf_rate`` 0, no teacher) for the TTS loss ->
        dict(mel, linear, p_code, post_prob, enc_len, mel_pred, lin_pred,
        align, tts_loss). ``generator`` draws the prenet's dropout."""

        @torch.no_grad()
        def step(model, waves, wave_len, text, sid, generator=None):
            cfg = self.cfg
            mel, linear, _, flen, _ = self._features(waves, wave_len, need_aug=False)
            p_code, _, post_prob = V.speech_to_text(model, cfg, self.phn_attr, mel,
                                                    paired_bs=mel.shape[0], train=False)
            lat = V.embed_text(model, cfg, self.phn_attr, text)
            mel_pred, lin_pred, align, _ = V.text_to_speech(
                model, cfg, lat, sid, decode_steps=mel.shape[1] // self.r,
                latent_lengths=(text != 0).sum(-1) + 1, generator=generator)
            T = mel.shape[1]
            tts_loss = self.floss(mel_pred[:, :T], mel)
            if lin_pred is not None:
                tts_loss = tts_loss + self.floss(lin_pred[:, :T], linear)
            return dict(mel=mel, linear=linear, p_code=p_code, post_prob=post_prob,
                        enc_len=self._enc_len(flen, p_code.shape[1]), mel_pred=mel_pred,
                        lin_pred=lin_pred, align=align, tts_loss=tts_loss)

        return step
