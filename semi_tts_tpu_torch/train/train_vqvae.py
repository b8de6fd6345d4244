"""The semi-supervised VQVAE trainer's loop (counterpart of
`semi_tts_tpu/train/train_vqvae.py` `VqvaeTrainer.exec` and `validate`).

`exec` runs the paired step wherever the JAX loop runs it: every step when
the unpaired loss weights are 0, and the steps between the cycles
otherwise. The speech-first and text-first cycle steps are not ported yet:
a step that would run one raises NotImplementedError. Left out for the
solvers and utilities (ROADMAP A8, A10): the YAML solver around the trainer,
TensorBoard, Griffin-Lim audio of dev predictions, checkpoint saving, the
``--profile`` window and resuming an imported checkpoint's schedule.
"""

from __future__ import annotations

import numpy as np

from ..utils.metrics import cal_per
from .optim import tf_rate_schedule
from .steps import step_generator

# (logged name, metric) after the first step and every progress step
LOGGED = (("txt_loss/pair", "asr_loss"), ("speech_loss/pair", "tts_loss"),
          ("speech_loss/mel", "mel_loss"), ("speech_loss/linear", "linear_loss"),
          ("grad_norm", "grad_norm"))


class VqvaeTrainer:
    """Runs ``max_step`` train steps over ``pair_iter`` (an iterator of
    ``(waves, wave_len, text, sid)`` batches on the model's device), logs the
    losses and gradient norm after the first step and every
    ``progress_step`` steps, and validates on ``dev_set`` (an iterable of
    such batches) after the first step and every ``valid_step`` steps.
    ``tf_rate``: the teacher-forcing schedule (a function of the step;
    default 1.0). ``log`` receives (step, name, value). The loss weights are
    the builder's."""

    def __init__(self, model, builder, optimizer, *, pair_iter, dev_set, max_step: int,
                 valid_step: int, progress_step: int = 20, seed: int = 0, tf_rate=None, log=None):
        self.model = model
        self.builder = builder
        self.optimizer = optimizer
        self.pair_iter = pair_iter
        self.dev_set = dev_set
        self.max_step = max_step
        self.valid_step = valid_step
        self.progress_step = progress_step
        self.seed = seed
        self.tf_rate = tf_rate or tf_rate_schedule()
        self.step = 0
        self.best_tts_loss = 100.0
        self.best_per = 2.0
        self.log = log or (lambda step, name, value: None)
        self._step_fn = self._make_step()
        self._eval_step = builder.make_eval_step()

    def _make_step(self):
        """The train step this loop runs: the paired step."""
        return self.builder.make_paired_step(self.optimizer, seed=self.seed)

    def _train_step(self, waves, wave_len, text, sid):
        w = self.builder.w
        use_unpair_text = w.unpair_text > 0 and self.step > w.unpair_text_start
        use_unpair_speech = w.unpair_speech > 0 and self.step > w.unpair_speech_start
        speech_first = self.step % 2 == 0
        if (use_unpair_speech if speech_first else use_unpair_text):
            cycle = "speech-first" if speech_first else "text-first"
            raise NotImplementedError(f"step {self.step} runs the {cycle} cycle, which is not "
                                      "ported yet (ROADMAP A7)")
        return self._step_fn(self.model, self.step, self.tf_rate(self.step), waves, wave_len,
                             text, sid)

    def exec(self):
        while self.step < self.max_step:
            mets = self._train_step(*next(self.pair_iter))
            self.step += 1
            if self.step == 1 or self.step % self.progress_step == 0:
                for name, key in LOGGED:
                    if key in mets:
                        self.log(self.step, name, float(mets[key]))
            if self.step == 1 or self.step % self.valid_step == 0:
                self.validate()

    def _eval(self, i, waves, wave_len, text, sid):
        """The eval step on dev batch ``i``, its prenet dropout drawn from a
        generator of (seed, step, i)."""
        g = step_generator(self.seed + 1, self.step * 100003 + i, waves.device)
        return self._eval_step(self.model, waves, wave_len, text, sid, g)

    def validate(self):
        """Mean TTS loss and phone error rate over the dev set; keeps the
        best of each. Returns (dev_tts_loss, dev_per)."""
        tts, pers, post_pers = [], [], []
        for i, (waves, wave_len, text, sid) in enumerate(self.dev_set):
            out = self._eval(i, waves, wave_len, text, sid)
            truth, lens = np.asarray(text.cpu()), out["enc_len"].cpu().numpy()
            pers.append(cal_per(out["p_code"].cpu().numpy(), truth, pred_lens=lens))
            if out["post_prob"] is not None:
                post_pers.append(cal_per(out["post_prob"].cpu().numpy(), truth, pred_lens=lens))
            tts.append(float(out["tts_loss"]))
        dev_tts = sum(tts) / max(len(tts), 1)
        dev_per = sum(pers) / max(len(pers), 1)
        self.best_tts_loss = min(self.best_tts_loss, dev_tts)
        self.best_per = min([self.best_per, dev_per] + ([sum(post_pers) / len(post_pers)]
                                                        if post_pers else []))
        self.log(self.step, "speech_loss/dev", dev_tts)
        self.log(self.step, "per/dev", dev_per)
        return dev_tts, dev_per
