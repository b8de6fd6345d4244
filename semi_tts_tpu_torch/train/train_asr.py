"""Supervised ASR-only training (counterpart of
`semi_tts_tpu/train/train_asr.py`): augmented features -> ASR encoder ->
codebook -> paired CTC -> backward -> clip/Adam/schedule update.

A step draws its augmentation (SNRs, stretch rate, noise) and its dropout
masks from one `torch.Generator` on the model's device (`step_generator`).
The step does not compute the clean features, which it would not use; the
clean path runs in `AsrTrainer.validate_asr`. The step runs where the model
and the featurizer live: the card, unless they were built with
``device="cpu"`` (`AudioFeaturizer` resolves its device so). Building a step
turns TF32 off (`use_fp32`), so the card computes in the fp32 the CPU path
does, and asks cuDNN for deterministic algorithms (`use_deterministic`), so
a step repeats bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import use_deterministic, use_fp32
from ..models import vqvae as V
from ..utils.metrics import cal_per
from .steps import step_generator
from .train_vqvae import PAIRED, VqvaeTrainer


def asr_loss_and_grads(builder, model, waves, wave_len, text, generator, *, augment=None):
    """The ASR loss of one batch and its gradients with respect to
    ``model.parameters()`` (None where the loss does not reach).
    ``augment``: (snrs, rate, noise) to featurize with instead of drawing
    them from ``generator``. Returns (total, metrics, grads)."""
    cfg = builder.cfg
    _, _, aug, _, aug_flen = builder._features(waves, wave_len, generator, need_clean=False,
                                               augment=augment)
    B = aug.shape[0]
    p_code, _, post_prob = V.speech_to_text(model, cfg, builder.phn_attr, aug, paired_bs=B,
                                            train=True, generator=generator)
    asr_loss = builder._paired_ctc(aug, p_code, text)
    if cfg.use_asr_postnet:
        post = builder._paired_ctc(aug, post_prob, text, apply_log=False)
        w = cfg.asr_postnet_weight
        total = (1 - w) * asr_loss + w * post
    else:
        total = asr_loss
    params = list(model.parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    mets = dict(asr_loss=asr_loss.detach(), pair_pred=p_code.detach().argmax(-1),
                pair_pred_len=builder._enc_len(aug_flen, p_code.shape[1]))
    return total.detach(), mets, grads


def make_asr_step(builder, optimizer, *, seed: int = 0):
    """``asr_step(model, step_no, waves, wave_len, text, sid, augment=None)``
    -> dict(total_loss, asr_loss, grad_norm, pair_pred, pair_pred_len); the
    parameters and the BN running statistics are updated in place.
    ``optimizer`` holds ``model.parameters()`` in order."""
    use_fp32()
    use_deterministic()

    def asr_step(model, step_no, waves, wave_len, text, sid, *, augment=None):
        g = step_generator(seed, step_no, waves.device)
        total, mets, grads = asr_loss_and_grads(builder, model, waves, wave_len, text, g,
                                                augment=augment)
        mets.update(total_loss=total, grad_norm=optimizer.step(grads))
        return mets

    return asr_step


class AsrTrainer(VqvaeTrainer):
    """`VqvaeTrainer`'s loop over ASR steps: logs the ASR loss and gradient
    norm, and validates with `validate_asr` (PER only)."""

    def _make_step(self):
        return make_asr_step(self.builder, self.optimizer, seed=self.seed)

    def _make_cycles(self):
        return {}

    def step_kind(self) -> str:
        return PAIRED

    def _train_step(self, batch, unpaired=None):
        return self._step_fn(self.model, self.step, *batch)

    def validate(self):
        return self.validate_asr()

    def validate_asr(self) -> float:
        """Mean phone error rate over the dev set; keeps the best."""
        pers = []
        for i, (waves, wave_len, text, sid) in enumerate(self.dev_set):
            out = self._eval(i, waves, wave_len, text, sid)
            pers.append(cal_per(out["p_code"].cpu().numpy(), np.asarray(text.cpu()),
                                pred_lens=out["enc_len"].cpu().numpy()))
        dev_per = sum(pers) / max(len(pers), 1)
        self.best_per = min(self.best_per, dev_per)
        self.log(self.step, "per/dev", dev_per)
        return dev_per
