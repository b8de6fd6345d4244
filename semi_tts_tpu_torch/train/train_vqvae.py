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
over the true encoder lengths. `validate` keeps the best dev TTS loss and
PER and, given a ``save`` callback, writes the checkpoints of the JAX
trainer's policy.

With ``media`` (a TensorBoard writer exists) the loop also logs what the
JAX trainer logs for a person to look at: at step 1 and every
`ATTENTION_PLOT_STEP` steps the paired and unpaired PER, the token-usage
bar chart and the attention alignments of `LISTEN_N_EXAMPLES` rows; at
each validation the middle dev batch's hypotheses, predicted spectrograms
and alignments, their Griffin-Lim audio on the device (K4) unless
``store_best_per``, at step 1 the ground truth's too, and the codebook for
the projector. A `Timer` splits each step's host wall into reading the
batch and the step, without synchronising the card; ``profile_dir`` opens a
`profile_trace` over the window of `profile_window`.

`VqvaeSolver` is the CLI's solver around the loop (counterpart of the JAX
`VqvaeTrainer` solver): ``load_data`` (the corpus's loaders, their batches
moved to the device), ``set_model`` (the YAML config, the model with the
``pretrained_*`` grafts, the optimizer, the step builder, ``--load``) and
``exec``; ``--profile`` traces into the run's log directory.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..bridge import load_jax_params
from ..data import load_dataset
from ..data.loader import infinite
from ..models import vqvae as V
from ..models.embed import full_codebook_table
from ..ops.features import linear_to_amp
from ..ops.griffin_lim import random_phases, specgram_to_waveform
from ..utils import viz
from ..utils.metrics import cal_per, human_format
from ..utils.timer import Timer, profile_trace, profile_window
from .checkpoint import apply_pretrained, load_checkpoint, load_optimizer_tree
from .optim import Optimizer, advance_lr_schedule, tf_rate_schedule
from .solver import BaseSolver, DeviceBatches, TrainLog, to_device
from .steps import StepBuilder, Weights, step_generator

CKPT_STEP = 10000
LISTEN_N_EXAMPLES = 6    # rows whose figures and audio are logged
ATTENTION_PLOT_STEP = 500

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
    start steps are the builder's. ``save`` receives (file name, score) for
    each checkpoint `validate` writes; ``store_best_per`` keeps only the
    best-PER checkpoints, as ``--store-best-per``. ``media``: also log the
    figures, samples and projector (see the module's docstring; needs
    ``tokenizer``). ``timer``: the `Timer` of the progress line (a new one
    by default). ``profile_dir``: trace `profile_window`'s steps there."""

    def __init__(self, model, builder, optimizer, *, pair_iter, dev_set, max_step: int,
                 valid_step: int, unpair_iter=None, progress_step: int = 20, seed: int = 0,
                 tf_rate=None, log=None, save=None, store_best_per: bool = False,
                 media: bool = False, tokenizer=None, timer=None, profile_dir=None):
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
        self.save = save or (lambda name, score: None)
        self.store_best_per = store_best_per
        self.media, self.tokenizer = media, tokenizer
        self.timer = timer or Timer()
        self.profile_dir = profile_dir
        self.counters = dict.fromkeys(COUNTERS, 0)
        # predicted tokens of the kept speech cycles and their unpaired texts' tokens,
        # counted since the last token-usage chart
        self.token_usage = np.zeros(0, np.int64)
        self.text_usage = np.zeros(0, np.int64)
        self._pending = []  # per step: (kind, device tensors to read at the progress step)
        self._unpair_align = None  # the last speech-first step's unpaired alignments
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
        prof = contextlib.ExitStack()
        prof_start, prof_end = profile_window(self.step, self.max_step)
        self.timer.set()
        while self.step < self.max_step:
            if self.profile_dir is not None:
                if self.step == prof_start:
                    prof.enter_context(profile_trace(self.profile_dir))
                elif self.step == prof_end:
                    prof.close()
            batch = next(self.pair_iter)
            kind = self.step_kind()
            unpaired = None if kind == PAIRED else next(self.unpair_iter)
            self.timer.cnt("rd")
            mets = self._train_step(batch, unpaired)
            if kind == SPEECH_FIRST:
                self._pending.append((kind, (mets["unpair_ok"], mets["unpair_pred"],
                                             mets["unpair_pred_len"], unpaired[2])))
                self._unpair_align = mets["unpair_align"]
            elif kind == TEXT_FIRST:
                self._pending.append((kind, (mets["ctc_nan"],)))
            self.step += 1
            self.timer.cnt("fw")
            self.timer.cnt("bw")
            if self.step == 1 or self.step % self.progress_step == 0:
                self._progress(mets, batch)
            if self.step == 1 or self.step % self.valid_step == 0:
                self.validate()
            self.timer.set()
        prof.close()  # a window still open at max_step

    def _progress(self, mets, batch):
        """One transfer of the buffered flags and the logged metrics to the
        host (with `media`, at step 1 and every `ATTENTION_PLOT_STEP` steps,
        also what the plots need); updates and logs the counters, then
        resets them."""
        logged = [(name, key) for name, key in LOGGED if key in mets]
        plot = (self.media and "pair_align" in mets
                and (self.step == 1 or self.step % ATTENTION_PLOT_STEP == 0))
        tensors = [mets[key] for _, key in logged] + [mets["total_loss"]]
        tensors += [t for _, flags in self._pending for t in flags]
        n_flags = len(tensors)
        if plot:
            tensors += [mets["pair_pred"], mets["pair_pred_len"], batch[2], mets["pair_align"]]
            if self._unpair_align is not None:
                tensors.append(self._unpair_align)
        host = self._read(tensors)
        values, total = host[:len(logged)], host[len(logged)]
        flags, plotted = host[len(logged) + 1:n_flags], host[n_flags:]
        last_unpaired = None
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
            if kind == SPEECH_FIRST:
                last_unpaired = got
        self._pending = []
        if not np.isfinite(total.item()):
            self.counters["ctc_nan"] += 1  # a non-finite step (its update was skipped)
        for (name, _), v in zip(logged, values):
            self.log(self.step, name, float(v.item()))
        for k in COUNTERS:
            self.log(self.step, "counter/" + k, self.counters[k])
            self.counters[k] = 0
        if plot:
            self._plots(mets, plotted, last_unpaired)

    def _plots(self, mets, host, last_unpaired):
        """The JAX trainer's logs of an attention-plot step: the paired and
        (after a speech-first step with counted tokens) unpaired PER, the
        token-usage chart since the last one, and the alignments."""
        pred, plen, text, align = host[:4]
        unp_per = None
        if self.token_usage.sum() > 0 and "unpair_pred" in mets and last_unpaired is not None:
            _, u_pred, u_plen, u_text = last_unpaired
            unp_per = cal_per(u_pred, u_text, pred_lens=u_plen)
        self.log(self.step, "per", {"pair": cal_per(pred, text, pred_lens=plen),
                                    "unpair": unp_per})
        bar = viz.data_to_bar(self.token_usage, self.text_usage, self.tokenizer.vocab_size,
                              self.tokenizer._vocab_list)
        if bar is not None:
            self.log(self.step, "unpair_hist", bar)
        u_align = host[4] if len(host) > 4 else None
        for i in range(min(LISTEN_N_EXAMPLES, align.shape[0])):
            self.log(self.step, f"pair_align{i}", viz.feat_to_fig(align[i]))
            if u_align is not None and i < u_align.shape[0]:
                self.log(self.step, f"unpair_align{i}", viz.feat_to_fig(u_align[i]))
        self.token_usage = np.zeros(0, np.int64)
        self.text_usage = np.zeros(0, np.int64)

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
        best of each and writes the checkpoints of `keep_best`; with
        `media`, logs the middle dev batch's samples (`_log_samples`).
        Returns (dev_tts_loss, dev_per)."""
        tts, pers, post_pers = [], [], []
        sample = None
        n_batches = len(self.dev_set)
        for i, (waves, wave_len, text, sid) in enumerate(self.dev_set):
            out = self._eval(i, waves, wave_len, text, sid)
            truth, lens = np.asarray(text.cpu()), out["enc_len"].cpu().numpy()
            pers.append(cal_per(out["p_code"].cpu().numpy(), truth, pred_lens=lens))
            if out["post_prob"] is not None:
                post_pers.append(cal_per(out["post_prob"].cpu().numpy(), truth, pred_lens=lens))
            tts.append(float(out["tts_loss"]))
            if i == n_batches // 2:
                sample = (out, truth)
        dev_tts = sum(tts) / max(len(tts), 1)
        dev_per = sum(pers) / max(len(pers), 1)
        dev_post = sum(post_pers) / len(post_pers) if post_pers else None
        self.keep_best(dev_tts, dev_per, dev_post)
        if self.media and sample is not None:
            self._log_samples(*sample)
        self.log(self.step, "speech_loss/dev", dev_tts)
        self.log(self.step, "per/dev", dev_per)
        if dev_post is not None:
            self.log(self.step, "per/dev_post", dev_post)
        if self.media:
            table = full_codebook_table(self.model.codebook, self.builder.cfg.codebook,
                                        self.builder.phn_attr)
            self.log(self.step, "codebook", (table.detach().cpu().numpy(),
                                             self.tokenizer._vocab_list))
        return dev_tts, dev_per

    def _log_samples(self, out, truth):
        """The first `LISTEN_N_EXAMPLES` rows of a dev batch's eval step:
        hypotheses, predicted mel and linear spectrograms and alignments;
        unless ``store_best_per``, their Griffin-Lim audio, and at step 1
        the true texts, spectrograms and audio."""
        n = LISTEN_N_EXAMPLES
        mel_d, lin_d = out["mel_pred"][:n], out["lin_pred"]
        lin_d = None if lin_d is None else lin_d[:n]
        mel_p, align_p = mel_d.cpu().numpy(), out["align"][:n].cpu().numpy()
        lin_p = None if lin_d is None else lin_d.cpu().numpy()
        hyp = out["p_code"][:n].argmax(-1).cpu().numpy()
        for i in range(len(mel_p)):
            self.log(self.step, f"hyp_text{i}", self.tokenizer.decode(hyp[i].tolist()))
            self.log(self.step, f"mel_spec{i}", viz.feat_to_fig(mel_p[i]))
            if lin_p is not None:
                self.log(self.step, f"linear_spec{i}", viz.feat_to_fig(lin_p[i]))
            self.log(self.step, f"dv_align{i}", viz.feat_to_fig(align_p[i]))
        if self.store_best_per:
            return
        g = step_generator(self.seed + 2, self.step, mel_d.device)
        self._log_waves("mel_wave", mel_d, g, is_mel=True)
        if lin_d is not None:
            self._log_waves("linear_wave", lin_d, g, is_mel=False)
        if self.step == 1:
            mel_t, lin_t = out["mel"][:n], out["linear"]
            for i, txt in enumerate(truth[:n]):
                self.log(self.step, f"truth_text{i}", self.tokenizer.decode(txt.tolist()))
                self.log(self.step, f"mel_spec{i}_gt", viz.feat_to_fig(mel_t[i].cpu().numpy()))
                if lin_t is not None:
                    self.log(self.step, f"linear_spec{i}_gt",
                             viz.feat_to_fig(lin_t[i].cpu().numpy()))
            self._log_waves("mel_wave", mel_t, g, is_mel=True, suffix="_gt")
            if lin_t is not None:
                self._log_waves("linear_wave", lin_t[:n], g, is_mel=False, suffix="_gt")

    def _log_waves(self, name, feats, generator, *, is_mel, suffix=""):
        """Batched Griffin-Lim on the device of normalized mel or linear
        spectrograms (B, T, D), its initial phases drawn from
        ``generator``; logs each row's wave as ``{name}{i}{suffix}``."""
        feat = self.builder.feat
        a = feat.cfg
        amp = feat.mel_to_linear_amp(feats) if is_mel else linear_to_amp(feats)
        phases = random_phases(amp.shape, generator, amp.device)
        wavs = specgram_to_waveform(amp, n_fft=a.n_fft, hop=a.hop_length,
                                    win_length=a.win_length,
                                    preemphasis_coeff=a.preemphasis_coeff,
                                    phases=phases).cpu().numpy()
        for i, w in enumerate(wavs):
            self.log(self.step, f"{name}{i}{suffix}", (w, a.sample_rate))

    def keep_best(self, dev_tts, dev_per, dev_post_per=None):
        """The JAX trainer's checkpoint policy. By default: ``tts_{step}``
        when the dev TTS loss improves, ``asr_{step}`` when the PER does
        (neither at step 1), ``best_post_per`` when the ASR postnet's PER
        beats the best PER; with ``store_best_per`` only ``best_per`` and
        ``best_post_per``; and ``step_{step}`` every `CKPT_STEP` steps
        unless ``store_best_per``."""
        if self.store_best_per:
            if dev_per < self.best_per:
                self.best_per = dev_per
                self.save("best_per.pth", dev_per)
        else:
            if dev_tts < self.best_tts_loss:
                self.best_tts_loss = dev_tts
                if self.step > 1:
                    self.save(f"tts_{self.step}.pth", dev_tts)
            if dev_per < self.best_per:
                self.best_per = dev_per
                if self.step > 1:
                    self.save(f"asr_{self.step}.pth", dev_per)
        if dev_post_per is not None and dev_post_per < self.best_per:
            self.best_per = dev_post_per
            self.save("best_post_per.pth", dev_post_per)
        if self.step > 1 and self.step % CKPT_STEP == 0 and not self.store_best_per:
            self.save(f"step_{self.step}.pth", dev_tts)


def pretrained_grafts(model_cfg: dict, linear_dim) -> dict:
    """{subtree key: checkpoint path} of the YAML ``model`` block's
    ``pretrained_*`` paths, as the JAX trainer grafts them: the whole ASR
    from ``pretrained_asr``, the codebook table alone from
    ``pretrained_emb``, the TTS decoder and (with a linear output) its
    postnet from ``pretrained_tts``; never the TTS text encoder."""
    tts = model_cfg.get("pretrained_tts")
    grafts = {"asr": model_cfg.get("pretrained_asr"),
              "codebook/learnable_table": model_cfg.get("pretrained_emb"),
              "tts/decoder": tts, "tts/postnet": tts if linear_dim else None}
    return {k: v for k, v in grafts.items() if v}


def _add_counts(counts, tokens):
    """``counts`` (a bincount) plus the occurrences of ``tokens``."""
    new = np.bincount(np.asarray(tokens, np.int64))
    n = max(len(counts), len(new))
    return np.pad(counts, (0, n - len(counts))) + np.pad(new, (0, n - len(new)))


class VqvaeSolver(BaseSolver):
    """The semi-supervised VQVAE trainer behind the CLI's default mode:
    the corpus's loaders, the model and optimizer of the YAML config, and
    `VqvaeTrainer`'s loop with the JAX trainer's checkpoint policy. The
    model is initialized from a generator seeded with ``--seed``, then the
    config's ``pretrained_*`` checkpoints (of either package) are grafted
    into it with their BatchNorm statistics (`pretrained_grafts`),
    and the steps draw from generators of (seed, step); ``--load`` resumes a
    checkpoint of either package: params, BatchNorm statistics, the
    optimizer state (or, where a checkpoint has none, the schedule advanced
    to its step), the step and the best-metric watermarks."""

    trainer_class = VqvaeTrainer

    def __init__(self, config, paras, mode):
        super().__init__(config, paras, mode)
        h = config["hparas"]
        self.weights = Weights(h["asr_weight"], h["tts_weight"], h["unpair_text_weight"],
                               h["unpair_speech_weight"], h["unpair_text_start_step"],
                               h["unpair_speech_start_step"])

    def load_data(self):
        self.verbose(["Loading data... large corpus may took a while."])
        (self.unpair_set, self.pair_set, self.dev_set, self.test_set,
         self.featurizer, self.tokenizer, data_msg) = load_dataset(
            self.paras.njobs, not self.paras.cpu, self.paras.pin_memory, seed=self.paras.seed,
            device=self.device, **self.config["data"])
        self.data_dims()
        self.verbose(data_msg)

    def set_model(self):
        h = self.config["hparas"]
        self.model_cfg, self.phn_attr = self.model_config()
        g = torch.Generator().manual_seed(self.paras.seed)
        self.model = V.VQVAE(self.model_cfg, generator=g).to(self.device)
        grafts = pretrained_grafts(self.config["model"], self.linear_dim)
        if grafts:
            apply_pretrained(self.model, grafts)
            self.verbose(f"Grafted {', '.join(grafts)} from {', '.join(sorted(set(grafts.values())))}")
        self.optimizer = Optimizer(self.model.parameters(), h["optimizer"], h["lr"],
                                   h["lr_scheduler"])
        self.builder = StepBuilder(self.model_cfg, self.featurizer, self.phn_attr,
                                   weights=self.weights, freq_loss_kwargs=self.freq_loss_kwargs(),
                                   actual_len=getattr(self.paras, "actual_len", False))
        w = self.weights
        self.verbose(["Optim.spec.| Algo. = {}\t| Lr/sampling scheduler = {}/{}".format(
            h["optimizer"], h["lr_scheduler"], h.get("tf_end", 1.0) != 1),
            f"           | ASR weight = {w.asr}\t| TTS weight = {w.tts}",
            f"           | Txt weight = {w.unpair_text}\t| start step = {w.unpair_text_start}",
            f"           | Sph weight = {w.unpair_speech}\t| start step = {w.unpair_speech_start}"])
        self.trainer = self.trainer_class(
            self.model, self.builder, self.optimizer,
            pair_iter=(to_device(b, self.device) for b in infinite(self.pair_set)),
            unpair_iter=(to_device(b, self.device) for b in infinite(self.unpair_set)),
            dev_set=DeviceBatches(self.dev_set, self.device), max_step=self.max_step,
            valid_step=self.valid_step, progress_step=self._PROGRESS_STEP, seed=self.paras.seed,
            tf_rate=tf_rate_schedule(h.get("tf_start", 1.0), h.get("tf_end", 1.0),
                                     h.get("tf_step", 1)),
            log=TrainLog(self), save=self.save,
            store_best_per=getattr(self.paras, "store_best_per", False),
            media=self.log is not None, tokenizer=self.tokenizer, timer=self.timer,
            profile_dir=self.logdir if getattr(self.paras, "profile", False) else None)
        if self.paras.load:
            self.load(self.paras.load)

    def load(self, path):
        """Resume from the checkpoint at ``path``."""
        ckpt = load_checkpoint(path)
        load_jax_params(self.model, ckpt["model"], ckpt["state"])
        if ckpt["optimizer"] is None:
            advance_lr_schedule(self.optimizer, ckpt["global_step"])
        else:
            load_optimizer_tree(self.optimizer, self.model, ckpt["optimizer"])
        self.step = self.trainer.step = ckpt["global_step"]
        extra = ckpt.get("extra") or {}
        self.trainer.best_tts_loss = extra.get("best_tts_loss", self.trainer.best_tts_loss)
        self.trainer.best_per = extra.get("best_per", self.trainer.best_per)
        self.verbose(f"Load ckpt from {path}, restarting at step {self.step}")

    def save(self, f_name, score):
        """A checkpoint of the trainer's model and optimizer, with the
        best-metric watermarks in its ``extra``."""
        self.step = self.trainer.step
        self.save_checkpoint_triple(
            f_name, score, model=self.model, optimizer=self.optimizer,
            extra={"best_tts_loss": float(self.trainer.best_tts_loss),
                   "best_per": float(self.trainer.best_per)})

    def exec(self):
        self.verbose(f"Total training steps {human_format(self.max_step)}.")
        if self.trainer.profile_dir is not None:
            first, end = profile_window(self.trainer.step, self.max_step)
            self.verbose(f"Profiling steps {first}..{end} -> {self.logdir}")
        self.trainer.exec()
