"""Offline vocoder: ``*-spec.npy`` linear spectrograms (what ``--gen-specgram``
writes) -> Griffin-Lim wavs, on the card unless ``--cpu``:

    python -m semi_tts_tpu_torch.util_cli.gen_wav_from_specgram \\
        --config config/semi-multi-spkr-paired-data.yaml \\
        --specgram-dir ckpt/<name>_<step>k --output-dir wavs/ [--sample] [--batch 16]

Files are grouped by frame count and vocoded a batch of ``--batch`` at a
time (`ops.griffin_lim.griffin_lim_program`: kernels K4 on the card, a CUDA
graph a batch shape from the shape's second batch on), the initial phases
of every batch drawn in turn from the program's generator seeded 0, so a
run repeats. Wavs are written 16-bit with `data.wavio`.
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict
from glob import glob
from os.path import basename, join

import numpy as np
import torch

from ..data import wavio
from ..device import resolve_device, use_fp32
from ..ops.features import AudioConfig, linear_to_amp
from ..ops.griffin_lim import griffin_lim_program

SAMPLE_LIST = [  # the utterances --sample keeps
    "LJ010-0057", "LJ027-0067", "LJ009-0213", "LJ034-0190", "LJ005-0281",
    "LJ002-0054", "LJ028-0259", "LJ012-0022", "LJ006-0039", "LJ019-0060",
    "LJ023-0001", "LJ044-0108", "LJ007-0219", "LJ016-0258", "LJ042-0113",
    "LJ013-0087", "LJ010-0003", "LJ019-0128", "LJ013-0200", "LJ001-0131",
]


def audio_config(config) -> AudioConfig:
    a = config["data"]["audio"]
    return AudioConfig(num_freq=a["num_freq"], num_mels=a["num_mels"],
                       frame_length_ms=a["frame_length_ms"], frame_shift_ms=a["frame_shift_ms"],
                       preemphasis_coeff=a["preemphasis_coeff"], sample_rate=a["sample_rate"],
                       use_linear=a["use_linear"], snr_range=tuple(a["snr_range"]),
                       time_stretch_range=tuple(a["time_stretch_range"]))


def batches(specgram_dir, batch: int, sample: bool = False):
    """[(paths, stacked spectrograms (B, T, F))]: the directory's
    ``*-spec.npy`` files (only `SAMPLE_LIST`'s with ``sample``) grouped by
    frame count, in order of frame count and then of name, ``batch`` at a
    time."""
    files = sorted(glob(join(specgram_dir, "*-spec.npy")))
    if sample:
        files = [f for f in files if basename(f).replace("-spec.npy", "") in SAMPLE_LIST]
    by_T = defaultdict(list)
    for f in files:
        spec = np.load(f)
        by_T[spec.shape[0]].append((f, spec))
    out = []
    for _, group in sorted(by_T.items()):
        for s in range(0, len(group), batch):
            chunk = group[s: s + batch]
            out.append(([f for f, _ in chunk], np.stack([c for _, c in chunk])))
    return out


def vocode(specs, acfg: AudioConfig, gl, device, seed=None):
    """Normalized linear spectrograms (B, T, F) -> waves (B, hop*(T-1))
    through ``gl`` (a `griffin_lim_program`), its phases drawn from its
    generator reseeded with ``seed`` (None: drawing on)."""
    amp = linear_to_amp(torch.from_numpy(specs).to(device))
    return gl(amp, seed=seed, n_fft=acfg.n_fft, hop=acfg.hop_length, win_length=acfg.win_length,
              preemphasis_coeff=acfg.preemphasis_coeff)


def vocode_dir(acfg: AudioConfig, specgram_dir, output_dir, *, batch: int = 16,
               sample: bool = False, device=None, verbose: bool = True):
    """Vocode every spectrogram of `batches` into ``output_dir`` on
    ``device`` (the card unless ``"cpu"``); returns the written paths."""
    device = resolve_device(device)
    use_fp32()
    os.makedirs(output_dir, exist_ok=True)
    todo = batches(specgram_dir, batch, sample)
    total = sum(len(paths) for paths, _ in todo)
    gl = griffin_lim_program()
    written = []
    for i, (paths, specs) in enumerate(todo):
        wavs = vocode(specs, acfg, gl, device, seed=0 if i == 0 else None)
        for f, wav in zip(paths, wavs.cpu().numpy()):
            out = join(output_dir, basename(f).replace("-spec.npy", ".wav"))
            wavio.write(out, wav, acfg.sample_rate)
            written.append(out)
            if verbose:
                print(f"[{len(written)}/{total}] {out}")
    return written


def parser():
    p = argparse.ArgumentParser(prog="python -m semi_tts_tpu_torch.util_cli.gen_wav_from_specgram",
                                description="Convert spectrogram into raw waveform.")
    p.add_argument("--config", type=str, required=True, help="Path to experiment config.")
    p.add_argument("--specgram-dir", type=str, required=True, help="Path to input spectrogram.")
    p.add_argument("--output-dir", type=str, required=True, help="Path to output wave.")
    p.add_argument("--sample", action="store_true", help="Only sample some wavs.")
    p.add_argument("--batch", type=int, default=16, help="Griffin-Lim batch size.")
    p.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the card.")
    return p


def main(argv=None):
    import yaml

    paras = parser().parse_args(argv)
    with open(paras.config) as f:
        acfg = audio_config(yaml.safe_load(f))
    return len(vocode_dir(acfg, paras.specgram_dir, paras.output_dir, batch=paras.batch,
                          sample=paras.sample, device="cpu" if paras.cpu else None))


if __name__ == "__main__":
    main()
