"""The semi-supervised VQVAE trainer's loop (counterpart of
`semi_tts_tpu/train/train_vqvae.py` `VqvaeTrainer.exec` and `validate`).

`exec` runs the step the JAX loop runs at each step: the speech-first cycle
on even steps past ``unpair_speech_start`` when the unpaired speech weight
is above 0, the text-first cycle on odd steps past ``unpair_text_start``
when the unpaired text weight is, and the paired step otherwise. Each step's
device flags (the speech cycle's ``unpair_ok`` and predictions, the text
cycle's ``ctc_nan``) are buffered and read back in one transfer at each
progress step, with the logged metrics, into JAX's counters: ``ctc_nan``
(text cycles whose unpaired CTC was not finite, and a non-finite total at
the progress step), ``unp_sph`` (speech cycles that kept every row),
``unp_txt`` (text cycles), and the token usage of the kept speech cycles
over the true encoder lengths. Left out for the solvers and utilities
(ROADMAP A8, A10): the YAML solver around the trainer, TensorBoard (the
alignment figures and the token-usage histogram), Griffin-Lim audio of dev
predictions, checkpoint saving, the ``--profile`` window and resuming an
imported checkpoint's schedule.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.metrics import cal_per
from .optim import tf_rate_schedule
from .steps import step_generator

# (logged name, metric) after the first step and every progress step
LOGGED = (("txt_loss/pair", "asr_loss"), ("speech_loss/pair", "tts_loss"),
          ("speech_loss/mel", "mel_loss"), ("speech_loss/linear", "linear_loss"),
          ("grad_norm", "grad_norm"), ("txt_loss/unpair", "unpair_text_loss"),
          ("speech_loss/unpair", "unpair_speech_loss"))
COUNTERS = ("ctc_nan", "unp_sph", "unp_txt")
PAIRED, SPEECH_FIRST, TEXT_FIRST = "paired", "speech_first", "text_first"


class VqvaeTrainer:
    """Runs ``max_step`` train steps over ``pair_iter`` (an iterator of
    ``(waves, wave_len, text, sid)`` batches on the model's device) and, for
    the cycles, ``unpair_iter`` (batches of the same form), logs the losses,
    the gradient norm and the counters after the first step and every
    ``progress_step`` steps, and validates on ``dev_set`` (an iterable of
    such batches) after the first step and every ``valid_step`` steps.
    ``tf_rate``: the teacher-forcing schedule (a function of the step;
    default 1.0). ``log`` receives (step, name, value). The loss weights and
    start steps are the builder's."""

    def __init__(self, model, builder, optimizer, *, pair_iter, dev_set, max_step: int,
                 valid_step: int, unpair_iter=None, progress_step: int = 20, seed: int = 0,
                 tf_rate=None, log=None):
        self.model = model
        self.builder = builder
        self.optimizer = optimizer
        self.pair_iter = pair_iter
        self.unpair_iter = unpair_iter
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
        self.counters = dict.fromkeys(COUNTERS, 0)
        self.token_usage = np.zeros(0, np.int64)  # predicted tokens of the kept speech cycles
        self.text_usage = np.zeros(0, np.int64)   # their unpaired texts' tokens
        self._pending = []  # per step: (kind, device tensors to read at the progress step)
        self._step_fn = self._make_step()
        self._cycle_fns = self._make_cycles()
        self._eval_step = builder.make_eval_step()

    def _make_step(self):
        """The paired train step."""
        return self.builder.make_paired_step(self.optimizer, seed=self.seed)

    def _make_cycles(self):
        """The cycle steps whose loss weight is above 0."""
        w, b = self.builder.w, self.builder
        fns = {}
        if w.unpair_speech > 0:
            fns[SPEECH_FIRST] = b.make_speech_first_step(self.optimizer, seed=self.seed)
        if w.unpair_text > 0:
            fns[TEXT_FIRST] = b.make_text_first_step(self.optimizer, seed=self.seed)
        return fns

    def step_kind(self) -> str:
        """The kind of step the JAX loop runs at ``self.step``."""
        w = self.builder.w
        if self.step % 2 == 0:
            use = w.unpair_speech > 0 and self.step > w.unpair_speech_start
            return SPEECH_FIRST if use else PAIRED
        use = w.unpair_text > 0 and self.step > w.unpair_text_start
        return TEXT_FIRST if use else PAIRED

    def _train_step(self, batch, unpaired=None):
        """Runs the step of `step_kind` on ``batch`` (and, for a cycle, the
        ``unpaired`` batch) -> its metrics."""
        kind = self.step_kind()
        args = (self.model, self.step, self.tf_rate(self.step)) + tuple(batch)
        if kind == PAIRED:
            return self._step_fn(*args)
        return self._cycle_fns[kind](*args, *unpaired)

    def exec(self):
        while self.step < self.max_step:
            batch = next(self.pair_iter)
            kind = self.step_kind()
            unpaired = None if kind == PAIRED else next(self.unpair_iter)
            mets = self._train_step(batch, unpaired)
            if kind == SPEECH_FIRST:
                self._pending.append((kind, (mets["unpair_ok"], mets["unpair_pred"],
                                             mets["unpair_pred_len"], unpaired[2])))
            elif kind == TEXT_FIRST:
                self._pending.append((kind, (mets["ctc_nan"],)))
            self.step += 1
            if self.step == 1 or self.step % self.progress_step == 0:
                self._progress(mets)
            if self.step == 1 or self.step % self.valid_step == 0:
                self.validate()

    def _progress(self, mets):
        """One transfer of the buffered flags and the logged metrics to the
        host; updates and logs the counters, then resets them."""
        logged = [(name, key) for name, key in LOGGED if key in mets]
        tensors = [mets[key] for _, key in logged] + [mets["total_loss"]]
        tensors += [t for _, flags in self._pending for t in flags]
        host = self._read(tensors)
        values, total, flags = host[:len(logged)], host[len(logged)], host[len(logged) + 1:]
        for kind, entry in self._pending:
            n = len(entry)
            got, flags = flags[:n], flags[n:]
            if kind == TEXT_FIRST:
                self.counters["unp_txt"] += 1
                self.counters["ctc_nan"] += int(got[0].item())
            elif got[0].item():
                self.counters["unp_sph"] += 1
                pred, plen, utext = got[1], got[2], got[3]
                kept = np.concatenate([pred[b, :int(plen[b])] for b in range(pred.shape[0])])
                self.token_usage = _add_counts(self.token_usage, kept)
                self.text_usage = _add_counts(self.text_usage, utext.reshape(-1))
        self._pending = []
        if not np.isfinite(total.item()):
            self.counters["ctc_nan"] += 1  # a non-finite step (its update was skipped)
        for (name, _), v in zip(logged, values):
            self.log(self.step, name, float(v.item()))
        for k in COUNTERS:
            self.log(self.step, "counter/" + k, self.counters[k])
            self.counters[k] = 0

    @staticmethod
    def _read(tensors):
        """Host numpy copies of ``tensors`` through one device-to-host copy."""
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        return out

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


def _add_counts(counts, tokens):
    """``counts`` (a bincount) plus the occurrences of ``tokens``."""
    new = np.bincount(np.asarray(tokens, np.int64))
    n = max(len(counts), len(new))
    return np.pad(counts, (0, n - len(counts))) + np.pad(new, (0, n - len(new)))
