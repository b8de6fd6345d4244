"""Language-model pretraining (counterpart of `semi_tts_tpu/train/train_lm.py`),
the CLI's ``--pretrain-speech`` and ``--pretrain-text``.

* `AudioLmSolver`: the audio LM (`models.lm.AudioLM`: the TTS decoder in
  ``pretrain`` mode and the CBHG postnet) teacher-forced over the clean mel
  of each batch, with the mel and linear `freq_loss`. It saves
  ``best_mel.pth`` with the model tree ``{"tts": {"decoder", "postnet"}}``
  and the postnet's BatchNorm statistics under the same prefix, which a
  VQVAE grafts as ``pretrained_tts``.
* `TextLmSolver`: the text LM (`models.lm.TextLM`) on the shifted
  next-token NLL. It saves ``best_acc.pth`` with ``{"codebook":
  {"learnable_table"}, "textlm": ...}``, which a VQVAE grafts as
  ``pretrained_emb``.

Both train on the unpaired split, or the paired one when the unpaired split
is empty, with the optimizer, learning rate and schedule of the YAML
``hparas``; validate the dev loss after the first step, every
``valid_step`` steps and at the end, saving when it is no worse than the
best so far; and resume a pretraining checkpoint of either package with
``--load``. Checkpoints hold the JAX layout and the optax state
(`checkpoint.optimizer_tree`). A speech-LM step draws the prenet dropout,
the decoder cells' dropout and the scheduled-sampling coins from a
generator of (seed, step), as the paired step does
(`audiolm_loss_and_grads` also takes the coins, ``coins=``).
"""

from __future__ import annotations

import math
import os
from functools import partial

import torch

from ..bridge import load_jax_params, to_jax_params
from ..data.loader import infinite
from ..device import use_deterministic, use_fp32
from ..models.decoder import merge_wgrads, wgrad_probes
from ..models.lm import AudioLM, TextLM, audiolm_apply, textlm_loss
from ..utils.metrics import human_format
from .checkpoint import load_checkpoint, load_optimizer_tree, optimizer_tree, save_checkpoint
from .losses import freq_loss
from .optim import Optimizer, advance_lr_schedule
from .solver import to_device
from .steps import _pad_frames, step_generator
from .train_vqvae import VqvaeSolver


def _clean_features(feat, waves, wave_len, r):
    """Clean mel and linear features padded to a multiple of ``r`` frames."""
    mel, linear, _ = feat.featurize(waves, wave_len)
    return _pad_frames(mel, r), (None if linear is None else _pad_frames(linear, r))


def _audiolm_total(model, floss, mel, linear, **kw):
    out = audiolm_apply(model, mel, **kw)
    total = floss(out[0], mel)
    if out[1] is not None:
        total = total + floss(out[1], linear)
    return total, out


def audiolm_loss_and_grads(model: AudioLM, feat, floss, waves, wave_len, generator, *,
                           coins=None):
    """One speech-LM step's loss and its gradients with respect to
    ``model.parameters()`` (None where the loss does not reach, as the
    attention the pretrain mode bypasses): clean features, the
    teacher-forced decode through the weight-gradient probes, the postnet,
    ``floss`` on mel plus linear. Returns (loss, grads)."""
    mel, linear = _clean_features(feat, waves, wave_len, model.cfg.n_frames_per_step)
    probes = wgrad_probes(model.cfg, mel.shape[1] // model.cfg.n_frames_per_step, mel.shape[0],
                          mel.device)
    total, out = _audiolm_total(model, floss, mel, linear, train=True, generator=generator,
                                coins=coins, wgrad_probes=probes)
    params = list(model.parameters())
    *grads, gq, gd = torch.autograd.grad(total, params + [probes["q"], probes["d"]],
                                         allow_unused=True)
    grads = merge_wgrads(model.decoder, dict(zip(params, grads)), out[2], {"q": gq, "d": gd})
    return total.detach(), [grads[p] for p in params]


def textlm_loss_and_grads(model: TextLM, text, text_len):
    """One text-LM step's loss and its gradients with respect to
    ``model.parameters()``. Returns (loss, grads)."""
    total = textlm_loss(model, text, text_len)
    return total.detach(), list(torch.autograd.grad(total, list(model.parameters())))


def make_audiolm_step(model: AudioLM, feat, optimizer, floss, *, seed: int = 0):
    """``step(step_no, waves, wave_len)`` -> dict(total_loss, grad_norm): one
    speech-LM step, the parameters and BatchNorm statistics updated in
    place. ``optimizer`` holds ``model.parameters()`` in order."""
    use_fp32()
    use_deterministic()

    def step(step_no, waves, wave_len):
        g = step_generator(seed, step_no, waves.device)
        total, grads = audiolm_loss_and_grads(model, feat, floss, waves, wave_len, g)
        return dict(total_loss=total, grad_norm=optimizer.step(grads))

    return step


def make_textlm_step(model: TextLM, optimizer):
    """``step(step_no, text, text_len)`` -> dict(total_loss, grad_norm)."""
    use_fp32()
    use_deterministic()

    def step(step_no, text, text_len):
        total, grads = textlm_loss_and_grads(model, text, text_len)
        return dict(total_loss=total, grad_norm=optimizer.step(grads))

    return step


class LmSolver(VqvaeSolver):
    """What the two pretraining solvers share; ``lm_mode`` is "speech" or
    "text". The data come as the VQVAE solver loads them."""

    lm_mode = "speech"

    def __init__(self, config, paras, mode):
        super().__init__(config, paras, mode)
        self.best_dev = math.inf
        self._last_valid_step = -1

    def load_data(self):
        super().load_data()
        # untranscribed speech / text-only data; the paired split when there is none
        train_set = self.unpair_set if len(self.unpair_set) else self.pair_set
        self.train_iter = (to_device(b, self.device) for b in infinite(train_set))

    def set_model(self):
        h = self.config["hparas"]
        self.model_cfg, _ = self.model_config()  # the pretrained_* keys play no part here
        g = torch.Generator().manual_seed(self.paras.seed)
        if self.lm_mode == "speech":
            self.model = AudioLM(self.model_cfg.tts.decoder, self.model_cfg.tts.linear_dim,
                                 generator=g).to(self.device)
            self.verbose(f"AudioLM pretraining: decoder + CBHG postnet ({self.n_mels} mels -> "
                         f"linear {self.linear_dim})")
        else:
            self.model = TextLM(self.vocab_size, self.model_cfg.codebook.learn_dim,
                                generator=g).to(self.device)
            self.verbose(f"TextLM pretraining: codebook table ({self.vocab_size} x "
                         f"{self.model_cfg.codebook.learn_dim})")
        self.optimizer = Optimizer(self.model.parameters(), h["optimizer"], h["lr"],
                                   h["lr_scheduler"])
        if self.lm_mode == "speech":
            self.floss = partial(freq_loss, **self.freq_loss_kwargs())
            self._step = make_audiolm_step(self.model, self.featurizer, self.optimizer,
                                           self.floss, seed=self.paras.seed)
        else:
            self._step = make_textlm_step(self.model, self.optimizer)
        if self.paras.load:
            self.load(self.paras.load)

    def load(self, path):
        """Resume a pretraining checkpoint of either package: parameters,
        BatchNorm statistics, optimizer state and step."""
        ckpt = load_checkpoint(path)
        prefix = "tts" if self.lm_mode == "speech" else "textlm"
        load_jax_params(self.model, ckpt["model"][prefix], ckpt["state"].get(prefix, {}))
        if ckpt["optimizer"] is None:
            advance_lr_schedule(self.optimizer, ckpt["global_step"])
        else:
            load_optimizer_tree(self.optimizer, self.model, ckpt["optimizer"])
        self.step = ckpt["global_step"]
        self.verbose(f"Load {self.lm_mode} LM ckpt from {path}, restarting at step {self.step}")

    def _args(self, batch):
        """A device batch -> the step's arguments after ``step_no``."""
        waves, wave_len, text, _ = batch
        if self.lm_mode == "speech":
            return waves, wave_len
        text = text.long()
        return text, (text != 0).sum(-1)

    def train_step(self, batch):
        """One step on ``batch`` at ``self.step`` -> its metrics."""
        return self._step(self.step, *self._args(batch))

    def exec(self):
        self.verbose(f"Total pretraining steps {human_format(self.max_step)} ({self.lm_mode} LM).")
        self.timer.set()
        while self.step < self.max_step:
            batch = next(self.train_iter)
            self.timer.cnt("rd")
            mets = self.train_step(batch)
            self.step += 1
            self.timer.cnt("fw")
            self.timer.cnt("bw")
            if self.step == 1 or self.step % self._PROGRESS_STEP == 0:
                loss = float(mets["total_loss"])
                self.progress(f"LM({self.lm_mode}) | Loss - {loss:.3f} | {self.timer.show()}")
                self.write_log("lm_loss", {"train": loss})
            if self.step == 1 or self.step % self.valid_step == 0:
                self.validate()
            self.timer.set()
        if self._last_valid_step != self.step:
            self.validate()  # the last step's: a checkpoint always exists

    @torch.no_grad()
    def dev_loss(self, i, batch):
        """The loss of dev batch ``i``: the speech LM decodes in eval mode,
        its prenet dropout drawn from a generator of (seed, step, i)."""
        args = self._args(batch)
        if self.lm_mode == "text":
            return float(textlm_loss(self.model, *args))
        g = step_generator(self.paras.seed + 1, self.step * 100003 + i, self.device)
        mel, linear = _clean_features(self.featurizer, *args, self.model.cfg.n_frames_per_step)
        return float(_audiolm_total(self.model, self.floss, mel, linear, train=False,
                                    generator=g)[0])

    def validate(self):
        """Mean dev loss; saves the checkpoint when it is no worse than the
        best so far. Returns it."""
        self._last_valid_step = self.step
        losses = [self.dev_loss(i, to_device(b, self.device)) for i, b in enumerate(self.dev_set)]
        dev = sum(losses) / max(len(losses), 1)
        self.write_log("lm_loss", {"dev": dev})
        if dev <= self.best_dev:
            self.best_dev = dev
            self._save(dev)
        return dev

    def _save(self, score):
        """``best_mel.pth`` (speech) or ``best_acc.pth`` (text) in the JAX
        pretraining layout."""
        params, state = to_jax_params(self.model)
        if self.lm_mode == "speech":
            model, state, fname = {"tts": params}, {"tts": state}, "best_mel.pth"
        else:
            model = {"codebook": {"learnable_table": params["learnable_table"]}, "textlm": params}
            fname = "best_acc.pth"
        path = os.path.join(self.ckpdir, fname)
        save_checkpoint(path, params=model, state=state,
                        opt_state=optimizer_tree(self.optimizer, self.model), step=self.step)
        self.verbose("Saved {} LM checkpoint (step = {}, dev = {:.3f}) @ {}".format(
            self.lm_mode, human_format(self.step), score, path))


class AudioLmSolver(LmSolver):
    lm_mode = "speech"


class TextLmSolver(LmSolver):
    lm_mode = "text"
