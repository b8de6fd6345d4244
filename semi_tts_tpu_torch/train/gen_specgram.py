"""Inference solver: TTS spectrograms of the test split (counterpart of
`semi_tts_tpu/train/gen_specgram.py` `SpecgramGenerator`).

Decodes each test batch free-running (``tf_rate`` 0) for the teacher's
frames plus `INFERENCE_MARGIN_FRAMES`, and saves per utterance
``{id}-mel.npy``, ``{id}-spec.npy`` and ``{id}-align.npy`` (the alignment
cut to ``|text| * FRAME_PHN_RATIO / r`` decode steps and ``|text|``
memory positions); with ``--gen-wav`` also ``{id}-pred.wav``, Griffin-Lim
of the linear prediction (K4). The prenet's dropout (on at inference, as
in the JAX package) is drawn from a generator seeded from (seed, batch),
the Griffin-Lim phases from one seeded from (seed + 1, batch). Both run as
programs sharing one `graphs.GraphOwner`: the eval step (a CUDA graph a
batch shape on the card, from a shape's second batch on) and Griffin-Lim.

With ``--mesh`` the evaluation step runs this rank's rows of each test
batch and gathers the outputs (`StepBuilder.on_rows`); rank 0 vocodes and
writes them.
"""

from __future__ import annotations

import os
from os.path import join

import numpy as np
import torch

from ..bridge import load_jax_params
from ..data import load_dataset, wavio
from ..models import vqvae as V
from ..ops.features import linear_to_amp
from ..graphs import step_seed
from ..ops.griffin_lim import griffin_lim_program
from ..parallel.mesh import replicate
from .checkpoint import load_checkpoint
from .solver import BaseSolver, to_device
from .steps import StepBuilder

INFERENCE_MARGIN_FRAMES = 40


class SpecgramGenerator(BaseSolver):
    def load_data(self):
        (self.unpair_set, self.pair_set, self.dev_set, self.test_set,
         self.featurizer, self.tokenizer, _) = load_dataset(
            self.paras.njobs, not self.paras.cpu, self.paras.pin_memory, inference_stage=True,
            seed=self.paras.seed, device=self.device, **self.load_kwargs(), **self.config["data"])
        self.data_dims()

    def set_model(self):
        if self.paras.load is None:
            raise ValueError("--gen-specgram needs a checkpoint (--load)")
        self.model_cfg, self.phn_attr = self.model_config()
        ckpt = load_checkpoint(self.paras.load)
        self.model = load_jax_params(V.VQVAE(self.model_cfg, generator=torch.Generator()),
                                     ckpt["model"], ckpt["state"]).to(self.device)
        self.step = ckpt["global_step"]
        self.verbose("Load ckpt from {}, restarting at step {}".format(self.paras.load, self.step))
        if self.mesh is not None:
            replicate(list(self.model.parameters()) + list(self.model.buffers()), self.mesh)
        self.builder = StepBuilder(self.model_cfg, self.featurizer, self.phn_attr,
                                   freq_loss_kwargs=self.freq_loss_kwargs(), mesh=self.mesh)
        self.builder.graph_owner(self.device).notify = self.verbose
        self._eval_step = self.builder.make_eval_step()
        self._vocoder = griffin_lim_program(self.builder.graph_owner)

    def exec(self):
        self.gen_specgram("test", self.logdir + "_%dk" % (self.step // 1000))

    def gen_specgram(self, split, output_dir):
        os.makedirs(output_dir, exist_ok=True)
        self.verbose("Save outputs in {}".format(output_dir))
        loader = getattr(self, split + "_set")
        r = self.model_cfg.n_frames_per_step
        acfg = self.featurizer.cfg
        cnt = 0
        for i, batch in enumerate(loader):
            self.progress("Generating spectrogram for {} - {}/{}".format(split, i + 1, len(loader)))
            waves, wave_len, text, sid = to_device(batch, self.device)
            out = self._eval_step(self.model, waves, wave_len, text, sid,
                                  seed=step_seed(self.paras.seed, i),
                                  margin_frames=INFERENCE_MARGIN_FRAMES)
            if not self.is_first:
                continue
            wavs = None
            if self.paras.gen_wav:
                wavs = self._vocoder(
                    linear_to_amp(out["lin_pred"]), seed=step_seed(self.paras.seed + 1, i),
                    n_fft=acfg.n_fft, hop=acfg.hop_length, win_length=acfg.win_length,
                    preemphasis_coeff=acfg.preemphasis_coeff).cpu().numpy()
            mel_pred = out["mel_pred"].cpu().numpy()
            lin_pred = out["lin_pred"].cpu().numpy()
            align = out["align"].cpu().numpy()
            enc_step = (batch.text != 0).sum(-1).tolist()
            for idx, fname in enumerate(batch.fids):
                np.save(join(output_dir, fname + "-mel.npy"), mel_pred[idx], allow_pickle=False)
                np.save(join(output_dir, fname + "-spec.npy"), lin_pred[idx], allow_pickle=False)
                dec_step = int(enc_step[idx] * V.FRAME_PHN_RATIO) // r
                np.save(join(output_dir, fname + "-align.npy"),
                        align[idx][:dec_step, :enc_step[idx]])
                if wavs is not None:
                    wavio.write(join(output_dir, fname + "-pred.wav"), wavs[idx], acfg.sample_rate)
                cnt += 1
        self.verbose("Save {} spectrogram totally".format(cnt))
