"""Step pieces of the trainers (counterpart of `semi_tts_tpu/train/steps.py`):
feature extraction with the frame padding, the CTC input lengths, the paired
CTC loss and the ASR half of the evaluation step. The TTS losses, the paired
step and the cycle steps come with the TTS half of training."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models import vqvae as V
from ..ops.ctc import ctc_loss

EPS = 1e-10
SPEC_PAD_VALUE = 0.0


def round_up(x, r):
    """Round ``x`` up to the next multiple of ``r``."""
    return x + (-x) % r


def _pad_frames(x, r):
    """Pad time (axis 1) to a multiple of ``r`` with at least one extra frame."""
    return F.pad(x, (0, 0, 0, r - x.shape[1] % r), value=SPEC_PAD_VALUE)


class StepBuilder:
    """What the step functions share: model and audio configuration, the
    featurizer, the phonological attribute table and the CTC length rule.
    ``actual_len``: CTC input lengths from the non-pad frames instead of the
    full encoder length."""

    def __init__(self, cfg: V.VQVAEConfig, feat, phn_attr, *, actual_len: bool = False):
        self.cfg = cfg
        self.feat = feat
        self.phn_attr = phn_attr
        self.actual_len = actual_len
        self.r = cfg.n_frames_per_step

    def _features(self, waves, wave_len, generator=None, *, need_clean=True, need_aug=True):
        """(mel, linear, aug, flen, aug_flen); clean features padded to a
        multiple of ``r`` frames; what is not asked for is None."""
        mel = linear = flen = aug = aug_flen = None
        if need_clean:
            mel, linear, flen = self.feat.featurize(waves, wave_len)
            mel, linear = _pad_frames(mel, self.r), _pad_frames(linear, self.r)
        if need_aug:
            aug, aug_flen = self.feat.featurize_augmented(waves, wave_len, generator)
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

    def make_eval_step(self):
        """The ASR half of the dev-set step: clean features ->
        ``speech_to_text(train=False)`` -> dict(mel, linear, p_code,
        post_prob, enc_len)."""

        @torch.no_grad()
        def step(model, waves, wave_len, text, sid):
            mel, linear, _, flen, _ = self._features(waves, wave_len, need_aug=False)
            p_code, _, post_prob = V.speech_to_text(model, self.cfg, self.phn_attr, mel,
                                                    paired_bs=mel.shape[0], train=False)
            return dict(mel=mel, linear=linear, p_code=p_code, post_prob=post_prob,
                        enc_len=self._enc_len(flen, p_code.shape[1]))

        return step
