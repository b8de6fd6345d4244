"""Greedy CTC decoding of the test split (counterpart of
`semi_tts_tpu/train/asr_decode.py` `VqvaeDecoder`): the ASR on each
utterance's clean features (the featurizer as a program, a CUDA graph a
batch shape on the card), repeats merged and the special tokens dropped,
written with the split's PER to ``{logdir}_decode/hyp.tsv``."""

from __future__ import annotations

import os
from os.path import join

import torch

from ..models import vqvae as V
from ..ops.features import featurize_program
from ..utils.metrics import IGNORE_INDICES, cal_per
from .gen_specgram import SpecgramGenerator as _Base
from .solver import to_device
from .steps import _pad_frames


class VqvaeDecoder(_Base):
    def set_model(self):
        super().set_model()
        self._featurize = featurize_program(self.featurizer, self.builder.graph_owner)

    @torch.no_grad()
    def exec(self):
        output_dir = self.logdir + "_decode"
        os.makedirs(output_dir, exist_ok=True)
        rows, pers = [], []
        for batch in self.test_set:
            waves, wave_len, _, _ = to_device(batch, self.device)
            mel, _, flen = self._featurize(waves, wave_len)
            mel = _pad_frames(mel, self.model_cfg.n_frames_per_step)
            p_code, _, _ = V.speech_to_text(self.model, self.model_cfg, self.phn_attr, mel,
                                            paired_bs=mel.shape[0], train=False)
            pred = p_code.argmax(-1).cpu().numpy()
            enc_len = self.builder._enc_len(flen, p_code.shape[1]).cpu().numpy()
            pers.append(cal_per(pred, batch.text, pred_lens=enc_len))
            for i, fid in enumerate(batch.fids):
                p = pred[i][: int(enc_len[i])].tolist()
                p = [v for j, v in enumerate(p)
                     if (j == 0 or v != p[j - 1]) and v not in IGNORE_INDICES]
                rows.append((fid, self.tokenizer.decode(p)))
        self.per = sum(pers) / max(len(pers), 1)
        if not self.is_first:  # with --mesh every rank decodes the split; rank 0 writes
            return
        with open(join(output_dir, "hyp.tsv"), "w") as f:
            f.write("id\thyp\n")
            for fid, hyp in rows:
                f.write(f"{fid}\t{hyp}\n")
        self.verbose(f"Decoded {len(rows)} utterances | PER = {self.per:.3f} -> "
                     f"{output_dir}/hyp.tsv")
