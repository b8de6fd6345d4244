"""Ground-truth spectrograms of the test split (counterpart of
`semi_tts_tpu/train/gen_gt_specgram.py`): each utterance's clean mel and
linear features, cut to its frames, as ``{id}-mel.npy`` and
``{id}-spec.npy``; with ``--gen-wav`` also ``{id}-pred.wav``, Griffin-Lim
of the linear features with phases from a generator seeded from (seed,
batch). No model is loaded. The featurizer and Griffin-Lim run as programs
of one `graphs.GraphOwner` (CUDA graphs from a batch shape's second
batch on)."""

from __future__ import annotations

import os
from os.path import join

import numpy as np

from ..data import wavio
from ..graphs import GraphOwner, step_seed
from ..ops.features import featurize_program, linear_to_amp
from ..ops.griffin_lim import griffin_lim_program
from .gen_specgram import SpecgramGenerator as _Base
from .solver import to_device


class SpecgramGenerator(_Base):
    def set_model(self):
        self.step = 0  # ground-truth features only: no model
        owner = GraphOwner(self.device, notify=self.verbose)
        self._featurize = featurize_program(self.featurizer, lambda device: owner)
        self._vocoder = griffin_lim_program(lambda device: owner)

    def exec(self):
        self.gen_specgram("test", self.logdir + "_gt")

    def gen_specgram(self, split, output_dir):
        os.makedirs(output_dir, exist_ok=True)
        self.verbose("Save outputs in {}".format(output_dir))
        acfg = self.featurizer.cfg
        cnt = 0
        for bi, batch in enumerate(getattr(self, split + "_set")):
            if not self.is_first:  # with --mesh rank 0 alone writes the features
                continue
            waves, wave_len, _, _ = to_device(batch, self.device)
            mel, linear, flen = self._featurize(waves, wave_len)
            wavs = None
            if self.paras.gen_wav:
                wavs = self._vocoder(
                    linear_to_amp(linear), seed=step_seed(self.paras.seed, bi),
                    n_fft=acfg.n_fft, hop=acfg.hop_length, win_length=acfg.win_length,
                    preemphasis_coeff=acfg.preemphasis_coeff).cpu().numpy()
            mel, linear, flen = mel.cpu().numpy(), linear.cpu().numpy(), flen.cpu().numpy()
            for i, fname in enumerate(batch.fids):
                T = int(flen[i])
                np.save(join(output_dir, fname + "-mel.npy"), mel[i, :T], allow_pickle=False)
                np.save(join(output_dir, fname + "-spec.npy"), linear[i, :T], allow_pickle=False)
                if wavs is not None:
                    wavio.write(join(output_dir, fname + "-pred.wav"), wavs[i], acfg.sample_rate)
                cnt += 1
        self.verbose("Save {} spectrogram totally".format(cnt))
