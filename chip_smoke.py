#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`semi_tts_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: a CUDA card must be present; prints nvidia-smi's name and power limit;
2. build: compiles every kernel under ``semi_tts_tpu_torch/csrc`` with nvcc (sm_90a);
3. kernels: each kernel at its serving shapes against its plain PyTorch version
   (max abs error against a stated tolerance), plus ragged shapes and every
   shape it is timed at; device time of
   the kernel, of the plain version and of one PyTorch library call where one
   computes the same function (CUDA events around a replayed CUDA graph of many
   calls), the kernel's eager time through its Python wrapper, and the least
   time the card could take (bytes over 3.35 TB/s or FLOPs over 67 TFLOP/s fp32,
   whichever is larger); for the recurrences also the time per step, for K1
   by batch rows per cluster (``ms_by_rows``) and at the ASR shape T=267; for
   K6, K7 and K8 their time, plain time and bound at every shape the train
   steps give them (``ms_by_shape``, ``plain_ms_by_shape``,
   ``bound_ms_by_shape``; shapes a step gives that phase 3 did not time are
   held to the plain version and timed after phase 7, ``shapes_seen``), K6's
   time a step (``us_per_step``) and `ctc_plan` at each shape (``plans``), for
   K3 its cluster size (``cluster``), for K4 ``gl_ola_frame`` its time by
   output frames per CTA (``ms_by_tile``) and the default tile (``tile``),
   for K5 ``stft_frames`` and B6 ``trim_merge`` their time, plain time and
   bound at the flagship and 15.28 s shapes (``ms_by_shape``, ...) and
   their launch plans (``plans``), for K5 also its time by frames per CTA
   (``ms_by_tile``) and a check on 49 rows of 15.28 s (66,591 frame rows);
   K6, K7 and K8 also beside cuDNN's LSTM and GRU backward and F.ctc_loss
   at each timed shape (``library_ms_by_shape``);
   rows without a library yardstick say why in ``library``;
4. serving at the flagship width of ``config/semi-multi-spkr-paired-data.yaml``:
   a seeded random model written with the port's ``save_checkpoint``, loaded with
   ``TTSServer.from_checkpoint`` on the card, one warm-up request, then five timed
   requests of B=16 utterances of U=32 tokens (100 decode steps, 300 frames, 82225
   samples each; the median wall time is reported), with every kernel's launch
   counter reset before the first and read after it; the wall time of each stage;
   one request under torch.profiler for the device's busy time and idle share, whose
   replayed graphs must run every serving kernel (by name); the same requests run
   eagerly (no graph), timed and profiled beside them; graphed `synthesize` and
   `synthesize_full` against eager, bit for bit, at B=16 x U=32 and B=4 x U=20,
   two keys each, and a server of ``program_cache_size`` 1 alternating the two
   buckets with the same waveforms; the same comparison with cuDNN's
   non-deterministic algorithms allowed, reported only (`loose_cudnn`); and a
   small request against the same checkpoint served by the plain path on the
   CPU;
5. ASR training at the same width: a seeded random model driven by ``AsrTrainer``
   for one warm-up step and five timed ``asr_step``s of B=8 utterances of 3.0 s
   (66150 samples) and U=32 tokens (median wall, peak memory, the loss and
   gradient norm of every step, all finite), with ``validate_asr`` after the
   first (finite PER); the kernel launches of the run and of the validation;
   one more step under torch.profiler for the device's busy time and idle
   share, and K6's own device time (``picked_ms``); and one step's loss and
   gradients on the card against the CPU plain path on the same weights,
   dropout 0 and the same SNRs, stretch rate and noise; then `graph_check`.
   The featurizer is also timed against ``torch.stft`` + ``abs`` + the mel
   GEMM at equal row lengths;
6. paired training at the same width: ``VqvaeTrainer`` with the unpaired loss
   weights 0 runs one warm-up paired step (ASR on augmented features, CTC,
   the TTS teacher-forced over 81 decode steps on the clean mel, CBHG postnet,
   mel and linear losses, backward, Adam) and five timed ones of B=8 x 3.0 s
   x U=32 (median wall, peak memory, the ASR, mel and linear losses and the
   gradient norm of every step, all finite), then ``validate`` (dev TTS loss
   and PER); the kernel launches of the run (K1 with cell states, K7, K2,
   K8, K3, K9, K5, K6: each must launch) and of a validation; one profiled
   step; and one step's loss and gradients on the card against the CPU plain
   path (B=2, every dropout 0, tf_rate 1, the same augmentation), the
   gradients held in all and, but where a ReLU or max-pool lies on the way
   back from the loss (``KINKED_LEAVES``), leaf by leaf (``compare_grads``),
   beside how far the card's own gradients move in a rerun and on weights
   an ulp off (``card_spread``; the ASR step's check reports both too);
   then `graph_check`;
7. the unpaired cycles at the same width: ``VqvaeTrainer`` with the
   flagship's unpaired speech weight (10) and an unpaired text weight of 1
   runs step 0 paired, then the text-first cycle on odd steps and the
   speech-first cycle (with B6 trim/merge) on even ones, B=8 x 3.0 s x U=32
   paired and unpaired batches: three warm-up steps and three timed steps
   of each kind (median wall, peak memory, every step's losses and the
   trainer's counters, all finite); the kernel launches of the run (K1 with
   cell states, K7, K2, K8, K3, K9, K5, K6 and B6: each must launch); one
   profiled step of each kind (K6 twice in the text-first step's); one step of each kind on the card against the CPU
   plain path (B = 2 + 2, every dropout 0, tf_rate 1, the same
   augmentation; the CPU follows the card's unpaired argmax tokens);
   `graph_check` of each cycle; a speech-first step whose unpaired
   utterance is 15.28 s long, through its CUDA graph, so that K3 and K9 run
   at L ~ 680; and the speech-first step at the flagship partition table's
   CORPUS_SHAPES most frequent batch shapes (`corpus_shapes`): eager, capture
   and replay times, what each capture cost the card (the allocator's pool
   and the card outside it) and its memory after each capture; under a
   budget of BUDGET_GRAPHS graphs the next shape runs eagerly, bit for bit
   its eager twin, and nothing is evicted;
8. the CLI's solvers at the same width (`phase_cli`), on a synthetic
   corpus written here from a seeded numpy generator (16 paired, 16
   unpaired, 8 dev and 8 test utterances of 2-4 s, a partition table and a
   map table): `VqvaeSolver` (``python -m semi_tts_tpu_torch``'s default)
   runs ``load_data -> set_model -> exec`` for 4 steps of B=8 (paired,
   text-first, speech-first, text-first) from the loader's batches,
   validating every 2, and writes the checkpoints the policy names; a second
   solver resumes from step 2's checkpoint (state equal bit for bit) and
   repeats step 3 bit for bit; `SpecgramGenerator` with --gen-wav writes
   the test split's mel, linear, alignment and Griffin-Lim wave files. The
   kernels of both paths must launch, and one profiled replay of each step
   kind's graph must run every training kernel; the solver's step wall is
   reported beside the bare steps' of phases 6 and 7, for the 4 steps (each
   shape's first call runs eagerly, its second captures) and for the last
   CLI_STEADY_TIMED of CLI_STEADY more steps of the same run (steady state).
   The solver logs to a recording writer, so the JAX trainer's media logs
   run whatever is installed: step 1 must log the paired alignments and
   PER, every validation the middle dev batch's hypotheses, spectrograms,
   alignments, Griffin-Lim audio (K4 must launch) and the codebook, step
   1's also the ground truth's; the first dev wave batch is held to the
   plain Griffin-Lim on the CPU with the same phases (1e-3 of the largest
   sample); one validation is timed with and without the writer. Then
   ``--profile``: 8 paired steps on one batch whose window (steps 4-7)
   covers graph replays; the trace in the log directory must name K3 and
   K9. The native decoder reads the corpus bit for bit as `wavio` does,
   timed beside it (the ``host_decoder`` line). The eval step and the dev
   audio are programs of the trainer's graph owner: the third validation
   must replay them (no wrapper launches), a profiled one must run their
   kernels by name, and the eval step (two dev batch shapes) and the
   featurizer are held to their eager twins bit for bit (`program_check`);
   gen_specgram's second and third passes (capture, replay) write the
   first's files byte for byte;
9. LM pretraining at the same width on that corpus (`phase_pretrain`):
   ``--pretrain-text`` and ``--pretrain-speech`` through `TextLmSolver` and
   `AudioLmSolver`, 4 steps each validated every 2, each writing its
   checkpoint; the launches of the first step of each (eager; the text LM:
   K1 with cell states and K7 once each, one direction; the audio LM: K5,
   K2 and K8 and no K3 or K9); `lm_programs`: each step program held to
   its eager twin (`graph_check`), its replay's wall and a profiled replay
   (the same kernels by name), the dev loss's program held to its eager
   twin, the graphs' bytes; one step of each on the card against the CPU
   plain path (every dropout 0); then both
   checkpoints and phase 8's checkpoint (as ``pretrained_asr``) grafted
   into a `VqvaeSolver`: every grafted leaf and the postnet's BatchNorm
   statistics equal the files' bit for bit, the TTS text encoder a cold
   solver's; two fine-tune steps;
10. the tools (`phase_tools`): a seeded flagship model written as an
   upstream-layout ``.pth`` goes through ``util_cli.import_reference_ckpt``
   and is served (B=16 x U=32) bit for bit as the same weights loaded
   directly, K1-K4 launched; ``util_cli.gen_wav_from_specgram`` vocodes
   phase 8's spectrograms through the Griffin-Lim program, which is held
   to its eager twin at two batch shapes (`program_check`), one batch's K4
   outputs held to their plain versions at every Griffin-Lim round (1e-4),
   the whole batch's distance to the plain Griffin-Lim on the card and on
   the CPU reported;
11. meshes (`phase_mesh`, `semi_tts_tpu_torch.parallel`): (a) one rank
   over NCCL (``--mesh 1x1``): the graphed paired and speech-first steps
   (B=8 x 3.0 s, 8 + 8 rows) through the mesh code, the gradient's
   all-reduce captured in the graph, against the mesh-less graphed steps
   from one copied state (bit for bit where the sums are the same, else the
   step gates), their walls side by side and the all-reduce's device time
   in a profiled replay; (b) two ranks on the one card over gloo (``--mesh
   2x1``, eager steps: a graph cannot capture gloo): each step on 4 + 4
   rows a rank against the one-process step on the 8 rows (the loss 1e-4
   relative, the gradients by the card-vs-CPU gates, the one-process
   unpaired argmax equal to the ranks' on every frame), `TTSServer(mesh=)`
   (its stages graphs) at B=16 x U=32 (8 + 8 rows) and B=3 (whole on each
   rank) against the single server on the same weights (their digests
   equal; 1e-3), every kernel of each path launched on each rank; (c)
   ``python -m semi_tts_tpu_torch --mesh 2x1`` in two processes on phase
   8's corpus, 4 steps: the ranks' train batches disjoint and together the
   unsharded loader's, dev unsharded, checkpoints written by rank 0 alone,
   one loaded by a single-process solver. Each spawned world is joined
   with a deadline (MESH_DEADLINE_S) past which its ranks are killed and
   the run fails. ``python3 chip_smoke.py --mesh-study`` runs the build
   and this phase alone, with the spread study of (b) (`spread_study`);
12. the wide routes of the recurrences (`phase_wide`): K1w, K7w, K2w and
   K8w, which the wrappers launch past the narrow plans
   (`kernels.rnn.lstm_route`/`gru_route`), each held to its plain version
   at 1e-4, a rerun and two graph replays bit for bit, and timed
   (graph-replayed, beside its plain version, its bound and cuDNN's LSTM
   or GRU, forward or backward) at every shape of
   `WIDE_LSTM_SHAPES`/`WIDE_GRU_SHAPES` (``ms_by_shape``, ...,
   ``plans_by_shape``; each also at `WIDE_MORE_SHAPES`, each shape's plan
   held to its design in `K1W_DESIGNS`, `K7W_DESIGNS`, `K2W_DESIGNS`,
   `K8W_DESIGNS`: both designs of each, and the cluster designs at B=64
   in chunks of batch rows); then
   (a) `RNNLM` LSTM and (b) `RNNLM` GRU at their
   default width, 512 units and 2 layers, trained at B=8 x 47 inputs
   through `rnnlm_step` (a `StepProgram`, Adam with the Noam schedule),
   and (c) the ASR step at ``model.encoder.rnn_dim`` 512 (`phase_training`
   with that one override: the flagship's B=8 x 3.0 s x U=32, T=133):
   each a graphed step's wall, busy time, idle share, device events and
   peak memory, its wide kernels run exactly twice a step (a launch a
   layer) in a profiled replay and no narrow recurrence, the card against
   the CPU plain path by the step gates, and `graph_check`. ``python3
   chip_smoke.py --wide`` runs the build and this phase alone;
13. long lengths (`phase_long`), the routes past the shared-memory plans:
   the split K3 (a cluster a chunk of positions, the positions over its
   CTAs, the cluster of a row's last CTA combining the chunks) and K9 at
   every shape of `SPLIT_SHAPES` (L from 1,188 to 8,000, the 30 s step's,
   ragged and masked with a wholly masked chunk, F = 0, A=1024 F=64), K3
   at B=16 L=32 (still one cluster a row, its time beside the recorded
   one), K6 at S = 1,025 to 8,193 and 24,577 (a cluster of CTAs a row at 2
   and 8 states a lane, ``us_per_step`` and its P, K, W) and 49,153 and
   98,305 (a chain of clusters a row past a cluster's states: rows of 100
   and 80 labels at T=120, rows of 5,200 and 10,400 at T=11,000 over two
   and three live clusters, and at B=16 in waves; with targets of all U
   labels too and two graph replays bit for bit) beside F.ctc_loss, B6 and its
   backward at T = 14,529 and 20,000 (C=43) and T=14,528 C=8,000 (the
   split route: the tokens over the card, the scans a CTA a row, the means
   over the card): each held to its plain version (1e-4; B6 1e-6 on the
   means and exact elsewhere) and timed beside it and its bound, B6's
   tokens kernel alone equal to and beside ``torch.argmax``; then (a) `TTSServer.from_checkpoint` on two texts, 1,500 and 40
   tokens, at 50 decode steps (graphed equal to eager bit for bit, the
   split K3 seen by name, within 1e-3 of the CPU plain path) and at the
   default decode policy (its first call, a replay, capture time, peak
   memory, a finite waveform); (b) the speech-first step with a 3.0 s
   paired and a 30.0 s unpaired row through its CUDA graph (memory_len
   past 1,187; the replay equal to the eager step bit for bit from one
   state; K3 split, K9, B6 and its backward by name; finite); (c)
   `AsrTrainer` at B=2 x 15.28 s and U=600 (K6 at 4 states a lane; one
   step against the CPU plain path by phase 5's gates) and graphed steps
   at U=1,100 over 30 s (8 states a lane) and U=2,100 over 60 s (the
   cluster lattice), each route by name. ``python3 chip_smoke.py
   --long`` runs the build and this phase alone.

The server and the train steps run as CUDA graphs (`semi_tts_tpu_torch.graphs`):
each path's line gives the graphed and eager walls (``wall_s``,
``eager_wall_s``), busy time and idle share of a profiled graph replay,
the device events of a call, the graphs' capture times and host launches a
call (``graphs``), and peak allocated and reserved memory with the graphs
alive. A path's kernels are shown to run by their names in a profiled
replay (`KERNEL_NAMES`): a wrapper's counter moves where it launches its
kernel, on an eager call or once at a capture, and a replay moves none. So
each graphed path resets the counters before its run (its capture
included), reads them after (``wrapper_launches``; every kernel of the
path must have launched) and reports as ``launches`` the kernels of each
name in one profiled replay. The bare-step phases capture a shape at its
first call (`capture_first`); the CLI runs the default, the second.
`graph_check` holds each train step's graph to the same step run eagerly
from one copy of the state: GRAPH_STEPS steps of each, every metric,
parameter, BatchNorm statistic and optimizer moment and count equal bit
for bit, and a rerun of a graphed step repeats bit for bit.

Every card-vs-CPU check holds the gradients in all and leaf by leaf in L2;
a leaf behind a ReLU or max-pool (``KINKED_LEAVES``) to max(1e-3, KINK_K x
its own ulp spread on the card); and the card's rerun of the same step must
repeat bit for bit (the train steps ask cuDNN for deterministic algorithms).

The training kernels (K5 ``stft_frames``/``spec_db``, K6 ``ctc_alpha``/
``ctc_beta_grad``, K7 ``bilstm_rec_bwd`` and K1 with cell states,
``bilstm_rec_cs``) and the paired step's backward kernels (K8
``bigru_rec_bwd``, K9 ``attention_step_bwd``, in phase 3 up to L = 1,187; phase 13 past it) and the speech-first step's B6 (``trim_merge``,
``trim_merge_bwd``, bit for bit) are held to their plain versions in
phase 3 at their step's shapes and at ragged ones; K3 also at the memory
lengths 1 and 2 of an all-pad or one-token request. A row's ``launches`` counts the
kernel's runs in one profiled replay of a serving request (K1-K4), an ASR
train step (K5-K7, K1 with cell states), a paired train step (K8, K9) or
a speech-first step (B6), as its ``launches_per`` says;
``launches_by_path`` has every path, each counted by name in one profiled
replay: the CLI's training as one replay of each step kind, its
validation, a gen_specgram pass, the eval step, the featurizer,
Griffin-Lim, the two LM steps and their dev losses; the offline vocoder's
batch by the wrappers' counters over its first (eager) call. K1 with cell states and K7 are also held and timed at the
text LM's one-direction shape, K2 and K8 at one direction and H=128
(``ms_by_shape``, beside cuDNN's unidirectional LSTM and GRU in
``library_ms_by_shape``). The wide routes' rows count their launches in
a step of (a) (K1w, K7w) or (b) (K2w, K8w). Every row's ``bound_ms``
takes its FLOPs from `utils.flops.matmul_flops` of the kernel's call: the
dot FLOPs of the JAX function it replaces, as its wrapper reports them.

Prints a ``{"ptxas": ...}`` line (registers and spills of the recurrence,
attention, CTC and trim/merge kernels), an ``{"asr_shape": ...}`` line, a ``{"featurizer": ...}`` line, a
``{"kernels": [...]}`` line, a ``{"serving": ...}`` line, a
``{"training": ...}`` line, a ``{"paired": ...}`` line, a ``{"cycles": ...}``
line, a ``{"host_decoder": ...}`` line (with the card's name and power
limit and the CLI's steady step wall), a ``{"cli": ...}`` line, a
``{"pretrain": ...}`` line (with the card's name and power limit), a
``{"tools": ...}`` line, a ``{"mesh": ...}`` line (with the card's name
and power limit), a ``{"wide": ...}`` line (steps (a), (b) and (c), with
the card's name and power limit), a ``{"long": ...}`` line (phase 13's
paths, with the card's name and power limit), a ``{"flops": ...}`` line (each timed
path's matrix-product FLOPs from one eager call, `utils.flops`, over its
graphed wall and over the card's 67 TFLOP/s fp32 peak: ``mfu_fp32``;
with the card) and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import filecmp
import functools
import gc
import glob
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# the `model` and `data.audio` blocks of config/semi-multi-spkr-paired-data.yaml
FLAGSHIP_MODEL = {
    "stop_threshold": 0.5, "max_frames_per_phn": 3, "txt_update_codebook": False,
    "spkr_latent_dim": 128,
    "encoder": {"dim": 512, "kernel": [3, 4, 3, 3, 3, 1], "stride": [1, 2, 1, 1, 1, 1],
                "residual": [0, 0, 1, 1, 1, 1], "dropout": 0.5, "activation": "Tanh",
                "batch_norm": True, "rnn_bid": True, "rnn_layers": 2, "rnn_dim": 256,
                "layer_norm": False},
    "codebook": {"bone": "l2", "softmax": "normal", "latent_dim": 64, "commit_weight": 0,
                 "vq_weight": 0, "temp": 1, "skip_prob": 0, "stop_grad": True,
                 "phn_attr_pth": "data/phn_attr.csv", "proj_attr": 16},
    "decoder": {
        "separate_postnet": True,
        "encoder": {"enc_n_conv": 3, "enc_kernel_size": 5, "enc_rnn_layer": 1,
                    "enc_embed_dim": 512, "enc_dropout": 0.0},
        "decoder": {"n_frames_per_step": 3, "prenet_dim": 256, "prenet_dropout": 0.5,
                    "query_rnn_dim": 1024, "dec_rnn_dim": 1024, "query_dropout": 0.1,
                    "dec_dropout": 0.1, "attn_dim": 256, "n_location_filters": 32,
                    "location_kernel_size": 31, "loc_aware": True,
                    "use_summed_weights": True, "drop_dec_in": 0.0},
    },
}
FLAGSHIP_AUDIO = {"num_freq": 1025, "num_mels": 80, "frame_length_ms": 50,
                  "frame_shift_ms": 12.5, "preemphasis_coeff": 0.97, "sample_rate": 22050,
                  "use_linear": True, "snr_range": [10, 100], "time_stretch_range": [0.9, 1.1]}

B, U = 16, 32                   # serving batch and padded text length
REQUESTS = 5                    # timed requests after the one that captures
TRAIN_B, TRAIN_S = 8, 66150     # ASR training batch: 3.0 s utterances
TRAIN_STEPS = 5                 # timed train steps after one warm-up
SERVING_KERNELS = ("bilstm_rec", "bigru_rec", "attention_step", "gl_project", "gl_ola_frame")
TRAINING_KERNELS = ("stft_frames", "spec_db", "bilstm_rec_cs", "bilstm_rec_bwd", "ctc_alpha",
                    "ctc_beta_grad")
PAIRED_KERNELS = ("bigru_rec_bwd", "attention_step_bwd")
# every kernel the paired step launches: K1 with cell states, K7, K2, K8, K3, K9, K5, K6
PAIRED_STEP_KERNELS = TRAINING_KERNELS + ("bigru_rec", "attention_step") + PAIRED_KERNELS
VALIDATION_KERNELS = ("stft_frames", "spec_db", "bilstm_rec", "bigru_rec", "attention_step")
PAIRED_T = 243                  # clean mel frames of a 3.0 s utterance, padded to r = 3
# the text LM's LSTM (one direction): U=32 tokens -> T=31 inputs, B=8, 256 units over
# the codebook table's 48 (64 - 16) learnable dims; RNNLM-GRU's one direction at K2's
# largest width
TEXTLM_T, TEXTLM_H, TEXTLM_D = 31, 256, 48
GRU_LM_T, GRU_LM_H = 31, 128
HOP = int(FLAGSHIP_AUDIO["frame_shift_ms"] / 1000 * FLAGSHIP_AUDIO["sample_rate"])
HBM_BYTES_PER_S = 3.35e12       # H100 SXM
FP32_FLOP_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    return card


def time_ms(fn, iters):
    """Mean time of ``fn()`` over ``iters`` back-to-back eager calls after two
    warm-ups: device time plus whatever host time the calls do not hide."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, reps=3):
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA graph,
    replayed ``reps`` times, so no host time enters."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


def graph_replays_equal(fn, eager):
    """One ``fn()`` captured in a CUDA graph and replayed twice: whether each
    replay's outputs equal the other's and ``eager``'s (``fn()``'s outputs
    outside the graph, a tensor or a tuple with Nones) bit for bit."""
    def outs(x):
        return [t for t in (x if isinstance(x, tuple) else (x,)) if t is not None]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = outs(fn())
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([o.clone() for o in captured])
    del graph
    return all(torch.equal(x, y) and torch.equal(x, e)
               for x, y, e in zip(replays[0], replays[1], outs(eager)))


def max_err(got, want):
    if isinstance(got, tuple):
        if [g is None for g in got] != [w is None for w in want]:
            raise SystemExit("chip_smoke: a kernel and its plain version return different outputs")
        return max(max_err(g, w) for g, w in zip(got, want) if g is not None)
    torch.cuda.synchronize()
    return float((got - want).abs().max())


def rel_err(got, want):
    """The largest of each output's max|got - want| / max|want|: every output
    held on its own scale (outputs that shrink as 1/L, such as attention
    weights, or as 1/U, such as a mean-reduced CTC gradient)."""
    if isinstance(got, tuple):
        if [g is None for g in got] != [w is None for w in want]:
            raise SystemExit("chip_smoke: a kernel and its plain version return different outputs")
        return max(rel_err(g, w) for g, w in zip(got, want) if g is not None)
    torch.cuda.synchronize()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def bound(nbytes, call):
    """The least time the card could take for ``call()``, a kernel wrapper's
    call, and what bounds it: ``nbytes`` over HBM_BYTES_PER_S or its FLOPs
    over FP32_FLOP_PER_S, whichever is larger. The FLOPs come from
    `utils.flops.matmul_flops` of the call, the one source of every row's
    count: the dot FLOPs of the JAX function the kernel replaces, as its
    wrapper reports them."""
    from semi_tts_tpu_torch.utils.flops import matmul_flops

    flops = matmul_flops(call)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _lstm_inputs(randn, unif, T, B, H):
    """Both directions' W_hh and x_proj of a BiLSTM layer."""
    w = [unif(4 * H, H, a=H ** -0.5) for _ in range(2)]
    return w + [randn(T, B, 4 * H, scale=0.5) for _ in range(2)]


def _gru_inputs(randn, unif, T, B, H):
    """Both directions' W_hh, b_hh and x_proj of a BiGRU."""
    w = [unif(3 * H, H, a=H ** -0.5) for _ in range(2)]
    b = [unif(3 * H, a=H ** -0.5) for _ in range(2)]
    return w + b + [randn(T, B, 3 * H, scale=0.5) for _ in range(2)]


def _case_lstm(randn, unif, dev):
    """K1: the TTS encoder BiLSTM, both directions in one launch. Also
    checked at T=1, at B=5 (not a multiple of the rows per cluster), at
    H=80, and one direction at a time, forward and reversed."""
    from semi_tts_tpu_torch.kernels import rnn as k12

    T, H, D = 32, 256, 512
    x_in = randn(T, B, D)
    w_ih = [unif(4 * H, D, a=H ** -0.5) for _ in range(2)]
    bias = [unif(4 * H, a=H ** -0.5) for _ in range(2)]
    w_hh = [unif(4 * H, H, a=H ** -0.5) for _ in range(2)]
    x_proj = [(x_in @ w.T + b).contiguous() for w, b in zip(w_ih, bias)]
    lstm = torch.nn.LSTM(D, H, bidirectional=True).to(dev)
    with torch.no_grad():
        for sfx, wi, wh, b in zip(("", "_reverse"), w_ih, w_hh, bias):
            getattr(lstm, "weight_ih_l0" + sfx).copy_(wi)
            getattr(lstm, "weight_hh_l0" + sfx).copy_(wh)
            getattr(lstm, "bias_ih_l0" + sfx).copy_(b)
            getattr(lstm, "bias_hh_l0" + sfx).zero_()
    args = w_hh + x_proj
    checks = [(lambda a=a: k12.bilstm_rec(*a), lambda a=a: k12.bilstm_rec_plain(*a))
              for a in (_lstm_inputs(randn, unif, 1, B, H), _lstm_inputs(randn, unif, T, 5, H),
                        _lstm_inputs(randn, unif, T, 5, 80))]
    checks += [(lambda r=r: k12.lstm_rec(r, w_hh[0], x_proj[0]),
                lambda r=r: k12.lstm_rec_plain(r, w_hh[0], x_proj[0])) for r in (False, True)]
    return dict(
        name="bilstm_rec", replaces="tools/proto_pallas_rnn.py:33 (pallas_lstm_rec, pallas_call "
        "at :61); semi_tts_tpu/ops/rnn.py:95 (_lstm_rec_fwd), both directions",
        source="semi_tts_tpu_torch/csrc/rnn.cu",
        shapes=f"2 x x_proj ({T},{B},{4 * H}), 2 x w_hh ({4 * H},{H})", steps=T,
        kernel=lambda: k12.bilstm_rec(*args), plain=lambda: k12.bilstm_rec_plain(*args),
        checks=checks, rows=lambda r: k12.bilstm_rec(*args, rows=r), row_options=k12.LSTM_ROWS,
        library=lambda: lstm(x_in),
        library_note="cuDNN nn.LSTM(bidirectional=True), includes the input GEMM; graph-timed",
        tol=1e-4, nbytes=2 * 4 * (T * B * 4 * H + 4 * H * H + T * B * H), iters=20)


def _case_gru(randn, unif, dev):
    """K2: the CBHG BiGRU, both directions in one launch. Also checked at
    T=1, at B=5, at H=50, and one direction at a time, forward and
    reversed."""
    from semi_tts_tpu_torch.kernels import rnn as k12

    T, H = 300, 80
    x_in = randn(T, B, H)
    w_ih = [unif(3 * H, H, a=H ** -0.5) for _ in range(2)]
    b_ih = [unif(3 * H, a=H ** -0.5) for _ in range(2)]
    w_hh = [unif(3 * H, H, a=H ** -0.5) for _ in range(2)]
    b_hh = [unif(3 * H, a=H ** -0.5) for _ in range(2)]
    x_proj = [(x_in @ w.T + b).contiguous() for w, b in zip(w_ih, b_ih)]
    gru = torch.nn.GRU(H, H, bidirectional=True).to(dev)
    with torch.no_grad():
        for sfx, wi, wh, bi, bh in zip(("", "_reverse"), w_ih, w_hh, b_ih, b_hh):
            getattr(gru, "weight_ih_l0" + sfx).copy_(wi)
            getattr(gru, "weight_hh_l0" + sfx).copy_(wh)
            getattr(gru, "bias_ih_l0" + sfx).copy_(bi)
            getattr(gru, "bias_hh_l0" + sfx).copy_(bh)
    args = w_hh + b_hh + x_proj
    checks = [(lambda a=a: k12.bigru_rec(*a), lambda a=a: k12.bigru_rec_plain(*a))
              for a in (_gru_inputs(randn, unif, 1, B, H), _gru_inputs(randn, unif, T, 5, H),
                        _gru_inputs(randn, unif, 40, 5, 50))]
    checks += [(lambda r=r: k12.gru_rec(r, w_hh[0], b_hh[0], x_proj[0]),
                lambda r=r: k12.gru_rec_plain(r, w_hh[0], b_hh[0], x_proj[0]))
               for r in (False, True)]
    one, gru1, x1 = _gru_one_dir(randn, unif, GRU_LM_T, TRAIN_B, GRU_LM_H, dev)
    key = shape_key(GRU_LM_T, TRAIN_B, GRU_LM_H, 1)
    cost1 = _gru_cost(GRU_LM_T, TRAIN_B, GRU_LM_H, 1)
    return dict(
        name="bigru_rec", replaces="semi_tts_tpu/ops/rnn.py:225 (_gru_rec_fwd), both directions",
        source="semi_tts_tpu_torch/csrc/rnn.cu",
        shapes=f"2 x x_proj ({T},{B},{3 * H}), 2 x w_hh ({3 * H},{H})", steps=T,
        kernel=lambda: k12.bigru_rec(*args), plain=lambda: k12.bigru_rec_plain(*args),
        checks=checks,
        library=lambda: gru(x_in),
        library_note="cuDNN nn.GRU(bidirectional=True), includes the input GEMM; graph-timed; "
        "by shape: nn.GRU() one direction",
        tol=1e-4, nbytes=_gru_cost(T, B, H), iters=10,
        timed={key: lambda: k12.bigru_rec(*one)}, timed_plain={key: lambda: k12.bigru_rec_plain(*one)},
        timed_library={key: lambda: gru1(x1)},
        extra={"bound_ms_by_shape": {key: bound(cost1, lambda: k12.bigru_rec(*one))[0]},
               "plans_by_shape": {key: k12.gru_plan(TRAIN_B, GRU_LM_H, 1)}})


def _gru_cost(T, B_, H, ndir=2):
    """Bytes moved by one K2 call: x_proj in, hs out, W_hh and b_hh per
    direction."""
    return ndir * 4 * (T * B_ * 3 * H + 3 * H * H + 3 * H + T * B_ * H)


def _lstm_one_dir(randn, unif, T, B_, H, D, dev):
    """K1 with cell states at ndir=1 (the text LM's layer): its arguments,
    a unidirectional cuDNN LSTM on the layer's input, and that input."""
    w_ih, bias, w_hh = unif(4 * H, D, a=H ** -0.5), unif(4 * H, a=H ** -0.5), unif(4 * H, H, a=H ** -0.5)
    x_in = randn(T, B_, D)
    lstm = torch.nn.LSTM(D, H).to(dev)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih)
        lstm.weight_hh_l0.copy_(w_hh)
        lstm.bias_ih_l0.copy_(bias)
        lstm.bias_hh_l0.zero_()
    return (w_hh, None, (x_in @ w_ih.T + bias).contiguous(), None), lstm, x_in


def _gru_one_dir(randn, unif, T, B_, H, dev):
    """K2 at ndir=1 (RNNLM-GRU's layer): its arguments, a unidirectional
    cuDNN GRU on the layer's input (D = H), and that input."""
    w_ih, b_ih = unif(3 * H, H, a=H ** -0.5), unif(3 * H, a=H ** -0.5)
    w_hh, b_hh = unif(3 * H, H, a=H ** -0.5), unif(3 * H, a=H ** -0.5)
    x_in = randn(T, B_, H)
    gru = torch.nn.GRU(H, H).to(dev)
    with torch.no_grad():
        for n, t in (("weight_ih_l0", w_ih), ("weight_hh_l0", w_hh), ("bias_ih_l0", b_ih),
                     ("bias_hh_l0", b_hh)):
            getattr(gru, n).copy_(t)
    return (w_hh, None, b_hh, None, (x_in @ w_ih.T + b_ih).contiguous(), None), gru, x_in


def _library_backward(module, x_in, randn):
    """The backward of a cuDNN RNN ``module`` on ``x_in``: data and weight
    gradients, for eager timing."""
    x = x_in.clone().requires_grad_(True)
    with torch.enable_grad():
        y, _ = module(x)
    gy = randn(*y.shape)
    leaves = [x] + list(module.parameters())
    return lambda: torch.autograd.grad(y, leaves, gy, retain_graph=True)


def _rnn_library_backward(cls, randn, dev, T, B_, H, ndir, D):
    """The backward of a cuDNN ``cls`` (nn.LSTM or nn.GRU) of ``H`` units
    over ``ndir`` directions on a (T, B, D) input: `_library_backward`."""
    module = cls(D, H, bidirectional=ndir == 2).to(dev)
    return _library_backward(module, randn(T, B_, D), randn)


def ptxas_report(log):
    """Registers, spills and static shared memory of each instantiation of
    the recurrence kernels (K1 with its cell-state flag, K2, K7, K8, and the
    wide routes: `rec_wide_kernel<4>` K1w, `<3>` K2w, K7w, K8w, and the
    cluster designs of K1w, K2w, K7w and K8w), of the
    attention kernels (K3 and its split route's kernel; K9 by span and
    loc_lin staging, and its sums kernel), of K6 (by states a lane, the
    cluster route's two by theirs, the chained route's two by theirs) and of
    B6 (the row route's kernel, the split route's three), from nvcc's ``-Xptxas -v``
    output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(lstm_rec|gru_rec|lstm_bwd|gru_bwd|rec_wide|lstm_wide_bwd_cluster|"
                      r"gru_wide_bwd_cluster|lstm_wide_fwd_cluster|gru_wide_fwd_cluster|"
                      r"lstm_wide_bwd|gru_wide_bwd|"
                      r"attention_bwd_sum|attention_bwd|attention_step|attention_split|"
                      r"ctc_alpha_cluster|ctc_beta_grad_cluster|ctc_alpha_chain|ctc_beta_grad_chain|"
                      r"ctc_alpha|ctc_beta_grad|"
                      r"trim_merge_tokens|trim_merge_scan|trim_merge_means|trim_merge_bwd|"
                      r"trim_merge)_kernel"
                      r"(?:I(?:Li(\d+)E)?(?:Li(\d+)E)?(?:Lb(\d)E)?E)?", line)
        if "Compiling entry function" in line:
            args = ",".join(a for a in m.groups()[1:] if a) if m else ""
            name = f"{m.group(1)}_kernel" + (f"<{args}>" if args else "") if m else None
        elif name and "spill stores" in line:
            out.setdefault(name, {})["spill_bytes"] = int(re.search(r"(\d+) bytes spill stores", line)[1])
        elif name and "Used" in line:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(name, {}).update(registers=int(re.search(r"Used (\d+) registers", line)[1]),
                                            static_smem_bytes=int(smem[1]) if smem else 0)
    return out


@torch.no_grad()
def asr_lstm_check(dev):
    """K1 at P1's own shape, the ASR BiLSTM of `tools/proto_pallas_rnn.py`
    (T=267, B=16, H=256, input 512): agreement with the plain version and
    device time, beside cuDNN's bidirectional LSTM (input GEMM included)."""
    from semi_tts_tpu_torch.kernels import rnn as k12

    g = torch.Generator(device=dev).manual_seed(1)
    T, H, D = 267, 256, 512
    args = [(torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1) * H ** -0.5 for _ in range(2)]
    args += [torch.randn((T, B, 4 * H), generator=g, device=dev) * 0.5 for _ in range(2)]
    err = max_err(k12.bilstm_rec(*args), k12.bilstm_rec_plain(*args))
    if not err <= 1e-4:
        raise SystemExit(f"chip_smoke: bilstm_rec at T={T} disagrees with its plain version ({err})")
    ms = device_ms(lambda: k12.bilstm_rec(*args), 5)
    lstm, x_in = torch.nn.LSTM(D, H, bidirectional=True).to(dev), torch.randn(T, B, D, device=dev)
    return {"name": "bilstm_rec", "T": T, "B": B, "H": H, "max_abs_err": err, "tol": 1e-4,
            "ms": ms, "ms_per_step": ms / T, "library_ms": device_ms(lambda: lstm(x_in), 5),
            "library": "cuDNN nn.LSTM(bidirectional=True), includes the input GEMM; graph-timed"}


NO_LIBRARY = "none: no single PyTorch call computes this function"


def _case_attention(randn, unif, dev):
    """K3: one decoder attention step (no mask, as the flagship decodes).
    Also checked with a padding mask, at memory lengths that are not a
    multiple of 32 (L=45, and L=1000 near the plan's limit, where memory is
    read from L2 instead of shared memory), at B=5, without location
    features (loc_aware: false), and at L=1 and L=2 (the memory of an
    all-pad or one-token request: rows of length 1 and 2, masked past it)."""
    from semi_tts_tpu_torch.kernels import attention as k3

    L, A, D, C, F_, K = 32, 256, 512, 2, 32, 31
    weights = (unif(F_, C, K, a=0.3), unif(A, F_, a=0.3), unif(A, a=0.1))

    def inputs(L, B=B):
        pq, pm, mem = randn(B, A), randn(B, L, A, scale=0.5), randn(B, L, D)
        w = torch.softmax(randn(B, L), -1)
        hist = torch.stack([w, w + torch.softmax(randn(B, L), -1)], 1).contiguous()
        lengths = (L - 12 + torch.arange(B, device=dev) % 13 if L > 12
                   else 1 + torch.arange(B, device=dev) % L)
        mask = torch.arange(L, device=dev)[None, :] >= lengths[:, None]
        return (pq, pm, mem, hist) + weights, mask

    args, mask = inputs(L)
    odd, odd_mask = inputs(45)
    long, long_mask = inputs(1000)
    five, five_mask = inputs(L, B=5)
    no_loc = args[:4] + (None, None, args[6])
    short = [inputs(n) for n in (1, 2)]
    cases = ((args, mask), (odd, None), (odd, odd_mask), (long, None), (long, long_mask),
             (five, None), (five, five_mask), (no_loc, None), (no_loc, mask), *short)
    return dict(
        name="attention_step", replaces="semi_tts_tpu/models/attention.py:39 (attention_step, "
        "in the decoder_apply step body, models/decoder.py:227)",
        source="semi_tts_tpu_torch/csrc/attention.cu",
        shapes=f"B={B} L={L} A={A} D={D} C={C} F={F_} K={K}",
        kernel=lambda: k3.attention_step(*args), plain=lambda: k3.attention_step_plain(*args),
        checks=[(lambda a=a, m=m: k3.attention_step(*a, m),
                 lambda a=a, m=m: k3.attention_step_plain(*a, m)) for a, m in cases],
        extra={"cluster": k3.attention_plan(B, L, A, D, C, F_, K)["cluster"]},
        library=None, library_note=NO_LIBRARY, tol=1e-4,
        nbytes=4 * (B * A + B * L * A + B * L * D + B * C * L + F_ * C * K + A * F_ + A + B * D + B * L),
        iters=200)


def _case_gl_project(randn, unif, dev):
    """K4a: the phase projection at 300 frames of a 2048-point DFT."""
    from semi_tts_tpu_torch.kernels import griffin_lim as k4

    T, F_ = 300, 1025
    reim, mag = randn(B, T, 2 * F_), randn(B, T, F_).abs()
    reim[:, :2, :8] = 0.0  # exercise angle(0) = 0
    reim[:, :2, F_:F_ + 8] = 0.0
    return dict(
        name="gl_project", replaces="semi_tts_tpu/ops/griffin_lim.py:71 (griffin_lim body: "
        "phase projection)", source="semi_tts_tpu_torch/csrc/griffin_lim.cu",
        shapes=f"reim ({B},{T},{2 * F_}) mag ({B},{T},{F_})",
        kernel=lambda: k4.gl_project(reim, mag), plain=lambda: k4.gl_project_plain(reim, mag),
        library=None, library_note=NO_LIBRARY, tol=1e-4, nbytes=4 * B * T * 5 * F_, iters=50)


def _case_gl_ola_frame(randn, unif, dev):
    """K4b: overlap-add + next-round framing at n_fft 2048, hop 275, win 1102.
    Also checked with the signal out (the last round) at T=300, and at T=5,
    where a tile's segment is reflected at both ends: with the default tile
    (greater than T), with one frame a tile and with 2 frames a tile, both
    outputs; at T=300 with one frame a tile; and at an odd window length
    (n_fft 512, hop 220, win 441). Timed by frames per tile."""
    from semi_tts_tpu_torch.kernels import griffin_lim as k4
    from semi_tts_tpu_torch.ops.stft import window_support

    T, geo = 300, dict(n_fft=2048, hop=275, win_length=1102)
    span = window_support(2048, 1102)[1]
    frames = randn(B, T, span, scale=0.1)
    short = randn(B, 5, span, scale=0.1)
    odd_geo = dict(n_fft=512, hop=220, win_length=441)  # odd span: scalar stores
    odd = randn(B, 12, 441, scale=0.1)
    S = geo["hop"] * (T - 1)
    checks = [(lambda x=x, e=e, n=n, g=g: k4.gl_ola_frame(x, emit_signal=e, tile=n, **g),
               lambda x=x, e=e, g=g: k4.gl_ola_frame_plain(x, emit_signal=e, **g))
              for x, n, g in ((frames, None, geo), (frames, 1, geo), (short, None, geo),
                              (short, 1, geo), (short, 2, geo), (odd, None, odd_geo))
              for e in (False, True)]
    return dict(
        name="gl_ola_frame", replaces="semi_tts_tpu/ops/stft.py:400 (istft_reim OLA/divide/trim) "
        "+ :373 (stft_reim pad/framing), per griffin_lim.py:77 round",
        source="semi_tts_tpu_torch/csrc/griffin_lim.cu", shapes=f"frames ({B},{T},{span})",
        kernel=lambda: k4.gl_ola_frame(frames, emit_signal=False, **geo),
        plain=lambda: k4.gl_ola_frame_plain(frames, emit_signal=False, **geo),
        checks=checks, tiles=lambda n: k4.gl_ola_frame(frames, emit_signal=False, tile=n, **geo),
        tile_options=(4, 8, 12, 16, 32), extra={"tile": k4.OLA_TILE},
        library=None, library_note=NO_LIBRARY, tol=1e-4, nbytes=4 * (2 * B * T * span + S),
        iters=50)


def audio_config():
    from semi_tts_tpu_torch.ops.features import AudioConfig

    a = dict(FLAGSHIP_AUDIO, snr_range=tuple(FLAGSHIP_AUDIO["snr_range"]),
             time_stretch_range=tuple(FLAGSHIP_AUDIO["time_stretch_range"]))
    return AudioConfig(**a)


def numpy_waves(lengths, S, seed):
    """Speech-like test signals from a numpy seed: three amplitude-modulated
    partials and a little noise, zero past each row's length."""
    rng = np.random.RandomState(seed)
    t = np.arange(S) / FLAGSHIP_AUDIO["sample_rate"]
    waves = np.zeros((len(lengths), S), np.float32)
    for b, n in enumerate(lengths):
        f0 = rng.uniform(90, 250)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 6) * t)
        sig = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6)) / k for k in (1, 2, 3))
        sig = 0.3 * env * sig + 0.02 * rng.randn(S)
        waves[b, :n] = sig[:n]
    return waves


RAGGED = (66150, 60001, 51234, 40000, 33333, 22050, 15000, 11025)  # down to 0.5 s


# (B, S, path) of K5 timed by shape: the flagship step's augmented and clean
# framing (B=8 x 3.0 s) and the 15.28 s utterance's
K5_SHAPES = ((TRAIN_B, TRAIN_S, "augmented"), (TRAIN_B, TRAIN_S, "clean"),
             (1, 336924, "augmented"), (1, 336924, "clean"))
K5_WIDE_B = 49  # rows of 15.28 s, augmented: 66,591 frame rows, past grid.y's 65,535


def _k5_call(k5, feat, audio, randn, dev, B_, S, path, lengths=None, rate=1.0, seed=5,
             tile=None):
    """`stft_frames` on B_ seeded rows of S samples, the augmented path at
    ``rate`` with noise mixed in or the clean path: {"kernel", "plain",
    "plain_timed" (calls), "cost" (bytes moved), "key", "plan"
    (`frames_plan`)}. "plain_timed" frames the clean path at the tensor hop
    (``clamp=True``), which a CUDA graph can capture (the static hop reads
    it to the host) and which gives the same frames, as its check holds."""
    from semi_tts_tpu_torch.ops.stft import window_support

    waves = torch.from_numpy(numpy_waves([S] * B_, S, seed=seed)).to(dev)
    if lengths is None:
        lengths = torch.full((B_,), S, dtype=torch.int32, device=dev)
    aug = path == "augmented"
    if aug:
        kw = dict(n_fft=audio.n_fft, support=window_support(audio.n_fft, audio.max_stretch_win),
                  num_frames=1 + S // audio.min_stretch_hop, clamp=True,
                  coeff=audio.preemphasis_coeff, noise=randn(B_, S),
                  mix=torch.rand(B_, device=dev) * 0.3)
        geom, max_hop = feat.stretch_geometry(rate, dev), audio.max_stretch_hop
    else:
        kw = dict(n_fft=audio.n_fft, support=window_support(audio.n_fft, audio.win_length),
                  num_frames=1 + S // audio.hop_length, clamp=False, coeff=audio.preemphasis_coeff)
        geom, max_hop = feat._clean_geom, audio.hop_length
    T, span = kw["num_frames"], kw["support"][1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return dict(kernel=lambda: k5.stft_frames(waves, lengths, geom, max_hop=max_hop, tile=tile,
                                              **kw),
                plain=lambda: k5.stft_frames_plain(waves, lengths, geom, **kw),
                plain_timed=lambda: k5.stft_frames_plain(waves, lengths, geom,
                                                         **dict(kw, clamp=True)),
                cost=4 * (B_ * T * span + (2 if aug else 1) * B_ * S),
                key=f"{path} B={B_} T={T} span={span}",
                plan=k5.frames_plan(B_, T, span, max_hop, noise=aug, sms=sms, tile=tile))


def _case_stft_frames(randn, unif, dev):
    """K5a at the train step's augmented shapes (stretch rate 1.0, noise
    mixed in): (8, 66150) -> frames (8, 267, 1212). Also checked on the
    clean path (hop 275, window 1102, frames (8, 241, 1102)) at full and
    ragged lengths down to 0.5 s, augmented at rates 0.9 and 1.1 on ragged
    lengths, and on `K5_WIDE_B` rows of 15.28 s (66,591 frame rows). Timed
    at every shape of `K5_SHAPES` (``ms_by_shape``, ``plain_ms_by_shape``,
    ``bound_ms_by_shape``; ``plans``: `frames_plan` at each) and, at the
    main shape, at every tile of `FRAMES_TILES` (``ms_by_tile``)."""
    from semi_tts_tpu_torch.kernels import features as k5
    from semi_tts_tpu_torch.ops.features import AudioFeaturizer

    audio = audio_config()
    feat = AudioFeaturizer(audio, dev)
    S = TRAIN_S
    ragged = torch.tensor(RAGGED, dtype=torch.int32, device=dev)

    def call(*a, **k):
        return _k5_call(k5, feat, audio, randn, dev, *a, **k)

    main = call(TRAIN_B, S, "augmented")
    checks = [call(TRAIN_B, S, "clean"), call(TRAIN_B, S, "clean", lengths=ragged)]
    checks += [call(TRAIN_B, S, "augmented", lengths=ragged, rate=r) for r in (0.9, 1.1)]
    wide = call(K5_WIDE_B, 336924, "augmented", rate=1.1, seed=6)
    by_shape = {c["key"]: c for c in (call(*sh) for sh in K5_SHAPES)}
    tiled = {G: call(TRAIN_B, S, "augmented", tile=G)["kernel"] for G in k5.FRAMES_TILES}
    return dict(
        name="stft_frames", replaces="semi_tts_tpu/ops/features.py:183 (_augment_impl: noise, "
        "pre-emphasis, reflect_pad_ragged, framing scan, dynamic_hann_window) and :158 "
        "(featurize: ops/stft.py:297 stft_magnitude framing)",
        source="semi_tts_tpu_torch/csrc/features.cu", shapes=f"waves ({TRAIN_B},{S}) + noise -> "
        f"frames ({TRAIN_B},{1 + S // audio.min_stretch_hop},{audio.max_stretch_win})",
        kernel=main["kernel"], plain=main["plain"],
        checks=[(c["kernel"], c["plain"]) for c in checks + [wide]]
        + [(c["plain_timed"], c["plain"]) for c in by_shape.values()],
        library=None, library_note="none per kernel: the featurizer line sets the whole "
        "featurizer beside torch.stft + abs + the mel GEMM", tol=1e-4,
        nbytes=main["cost"], iters=50,
        timed={k: c["kernel"] for k, c in by_shape.items()},
        timed_plain={k: c["plain_timed"] for k, c in by_shape.items()},
        tiles=lambda G: tiled[G](), tile_options=tuple(k5.FRAMES_TILES),
        extra={"hop_win": feat.stretch_geometry(1.0, dev).tolist(), "tile": main["plan"]["tile"],
               "bound_ms_by_shape": {k: bound(c["cost"], c["kernel"])[0]
                                     for k, c in by_shape.items()},
               "plans": {k: c["plan"] for k, c in by_shape.items()},
               "wide_check": f"{wide['key']}: {wide['plan']['grid']} CTAs"})


def _case_spec_db(randn, unif, dev):
    """K5b as the train step calls it first: [re | im] (8, 267, 2050) ->
    magnitude. Also checked with the dB output (the clean path's linear
    spectrogram) and on a mel amplitude (8, 267, 80), ragged frame lengths."""
    from semi_tts_tpu_torch.kernels import features as k5
    from semi_tts_tpu_torch.ops.features import MIN_LEVEL_DB, REF_LEVEL_DB

    lv = dict(min_db=MIN_LEVEL_DB, ref_db=REF_LEVEL_DB)
    T, F_, M = 1 + TRAIN_S // 248, 1025, 80
    reim = randn(TRAIN_B, T, 2 * F_, scale=3.0)
    reim[:, :2, :4] = 1e-7  # below the 1e-5 amplitude floor
    amp = randn(TRAIN_B, T, M).abs()
    flen = (1 + torch.tensor(RAGGED, device=dev) // 248).to(torch.int32)
    checks = [(lambda r=r, d=d: k5.spec_db(reim, flen, reim=r, db=d, **lv),
               lambda r=r, d=d: k5.spec_db_plain(reim, flen, reim=r, db=d, **lv))
              for r, d in ((True, True),)]
    checks += [(lambda: k5.spec_db(amp, flen, reim=False, **lv)[1],
                lambda: k5.spec_db_plain(amp, flen, reim=False, **lv)[1])]
    return dict(
        name="spec_db", replaces="semi_tts_tpu/ops/stft.py:262 (magnitude_dft |.|) + "
        "ops/features.py:154 (_finalize: amp_to_db, normalize_db) and the frame masks "
        "(stft.py:330, features.py:244)", source="semi_tts_tpu_torch/csrc/features.cu",
        shapes=f"reim ({TRAIN_B},{T},{2 * F_}) -> magnitude ({TRAIN_B},{T},{F_})",
        kernel=lambda: k5.spec_db(reim, flen, reim=True, db=False, **lv)[0],
        plain=lambda: k5.spec_db_plain(reim, flen, reim=True, db=False, **lv)[0], checks=checks,
        library=None, library_note="none per kernel: see the featurizer line", tol=1e-4,
        nbytes=4 * TRAIN_B * T * 3 * F_, iters=50)


def _ctc_inputs(randn, dev, B_=8, T=133, C=43, U=32, seed=0, tl=(32, 30, 28, 24, 32, 20, 16, 31),
                il=None):
    """log(softmax + 1e-10) as the train step feeds CTC, targets in 3..42
    padded with the blank, target lengths ``tl`` (the first B_), input
    lengths ``il`` (default: full)."""
    g = torch.Generator().manual_seed(seed)
    lp = torch.log(torch.softmax(randn(B_, T, C, scale=2.0), -1) + 1e-10)
    tl = torch.tensor(tl[:B_], dtype=torch.int32)
    tg = torch.randint(3, C, (B_, U), generator=g, dtype=torch.int32)
    tg[torch.arange(U)[None, :] >= tl[:, None]] = 0
    il = torch.tensor([T] * B_ if il is None else il, dtype=torch.int32)
    return lp, tg.to(dev), il.to(dev), tl.to(dev)


def _ctc_edge_cases(randn, dev):
    """(log_probs, targets, input_lengths, target_lengths) sets: input
    lengths below T, a target length of 0, repeated labels, an impossible
    alignment (32 equal labels need 63 frames; the row has 40), T = 1; T=700
    with ragged input lengths (many chunks of steps); and U=511 (S=1,023
    states, two a thread in 16 chain warps: the widest `ctc_plan` takes)."""
    lp, tg, il, tl = _ctc_inputs(randn, dev, seed=1)
    il2 = torch.tensor([133, 120, 100, 133, 90, 133, 70, 40], dtype=torch.int32, device=dev)
    tg2, tl2 = tg.clone(), tl.clone()
    tg2[3], tl2[3] = 0, 0
    tg2[5, :20] = 7                   # repeated labels
    tg2[7, :] = 9                     # impossible within 40 frames
    tl2[7] = 32
    lp1 = lp[:, :1].contiguous()
    tg1 = torch.zeros_like(tg)
    tg1[::2, 0] = 5
    tl1 = (tg1[:, 0] > 0).to(torch.int32)
    return [(lp, tg, il, tl), (lp, tg2, il2, tl2),
            (lp1, tg1, torch.ones_like(il), tl1),
            _ctc_inputs(randn, dev, T=700, seed=2, il=(700, 651, 533, 420, 301, 133, 96, 41)),
            _ctc_inputs(randn, dev, B_=2, T=600, U=511, seed=3, tl=(511, 400), il=(600, 571))]


def ctc_shape_key(B_, T, C, S):
    return f"B={B_} T={T} C={C} S={S}"


def _ctc_shape_inputs(randn, dev, B_, T, C, S):
    """K6's inputs at (B, T, C, S): `_ctc_inputs` with target lengths of U
    down to two thirds of U, full input lengths."""
    U = (S - 1) // 2
    return _ctc_inputs(randn, dev, B_, T, C, U, tl=[U - (5 * b) % (U // 3 + 1) for b in range(B_)])


def _ctc_beta_args(a):
    """``ctc_beta_grad``'s arguments from K6's inputs: the plain version's
    alphas and nll, and the 'mean' reduction's g."""
    from semi_tts_tpu_torch.kernels import ctc as k6

    alphas, nll = k6.ctc_alpha_plain(*a)
    g = 1.0 / (a[0].shape[0] * torch.clamp(a[3], min=1).to(torch.float32))
    return a + (alphas, nll, g)


def _ctc_alpha_cost(B_, T, C, S):
    """Bytes moved by one ctc_alpha call: log_probs read once, the alphas
    written, targets and lengths."""
    return 4 * (B_ * T * C + T * B_ * S + B_ * (4 + (S - 1) // 2))


def _ctc_beta_cost(B_, T, C, S):
    """Bytes moved by one ctc_beta_grad call: log_probs read and the
    gradient written, the alphas read, targets, lengths, nll and g."""
    return 4 * (2 * B_ * T * C + T * B_ * S + 3 * B_)


# (B, T, C, S) of K6 in the train steps: the ASR, paired and speech-first
# steps' CTC (8 rows of T=133) and the text-first step's unpaired CTC (T=96,
# u_ts // time_reduce_factor); also T=700 and S=1,023, the longest and
# widest of the checks; the run adds any other shape the steps give it
K6_SHAPES = ((8, 133, 43, 65), (8, 96, 43, 65), (8, 700, 43, 65), (2, 600, 43, 1023))


def _ctc_library(lp, tg, il, tl, backward):
    """F.ctc_loss on the card, reduction 'mean', forward (and backward)."""
    x = lp.detach().clone().requires_grad_(backward)
    t64, ilc, tlc = tg.long(), il.cpu().long(), tl.cpu().long()

    def run():
        with torch.enable_grad():
            loss = torch.nn.functional.ctc_loss(x.transpose(0, 1), t64, ilc, tlc, reduction="mean")
            return torch.autograd.grad(loss, x) if backward else loss

    return run


def _case_ctc_alpha(randn, unif, dev):
    """K6a at the train step's shapes (B=8, T=133, C=43, U=32: S=65 states);
    the edge cases of `_ctc_edge_cases` checked too. Timed at every shape
    of `K6_SHAPES` (``ms_by_shape``, ``plain_ms_by_shape``,
    ``bound_ms_by_shape``; ``plans``: `ctc_plan` at each)."""
    from semi_tts_tpu_torch.kernels import ctc as k6

    args = _ctc_inputs(randn, dev)
    B_, T, C = args[0].shape
    S = 2 * args[1].shape[1] + 1
    checks = [(lambda a=a: k6.ctc_alpha(*a), lambda a=a: k6.ctc_alpha_plain(*a))
              for a in _ctc_edge_cases(randn, dev)]
    timed, timed_plain, bounds = _timed_by_shape(
        K6_SHAPES, lambda *sh: _ctc_shape_inputs(randn, dev, *sh), k6.ctc_alpha, k6.ctc_alpha_plain,
        _ctc_alpha_cost, ctc_shape_key)
    nbytes = _ctc_alpha_cost(B_, T, C, S)
    return dict(
        name="ctc_alpha", replaces="semi_tts_tpu/ops/ctc.py:63 (_alpha_pass, with "
        "_logaddexp3 :34; forward of the custom VJP _ctc_nll_fwd :114)",
        source="semi_tts_tpu_torch/csrc/ctc.cu", shapes=f"log_probs ({B_},{T},{C}), S={S}",
        kernel=lambda: k6.ctc_alpha(*args), plain=lambda: k6.ctc_alpha_plain(*args),
        checks=checks, library=_ctc_library(*args, backward=False), library_timing="eager",
        library_note="F.ctc_loss forward, reduction mean, on the card (CUDA events, eager: "
        "its lengths go through the host)", tol=1e-4, nbytes=nbytes, iters=50,
        steps=T, timed=timed, timed_plain=timed_plain,
        timed_library={ctc_shape_key(*sh): _ctc_library(*_ctc_shape_inputs(randn, dev, *sh),
                                                        backward=False) for sh in K6_SHAPES},
        extra={"bound_ms_by_shape": bounds, "plans": _ctc_plans()})


def _ctc_plans():
    from semi_tts_tpu_torch.kernels import ctc as k6

    return {ctc_shape_key(*sh): k6.ctc_plan(sh[0], sh[1], sh[3]) for sh in K6_SHAPES}


def _case_ctc_beta_grad(randn, unif, dev):
    """K6b at the train step's shapes, from the plain version's alphas; the
    edge cases checked too (the impossible row's gradient must be zero), and
    a rerun at the step's shape and at T=700 must repeat bit for bit (the
    check's error is the count of elements that differ). Timed at every
    shape of `K6_SHAPES`."""
    from semi_tts_tpu_torch.kernels import ctc as k6

    args = _ctc_beta_args(_ctc_inputs(randn, dev))
    B_, T, C = args[0].shape
    S = args[4].shape[2]
    edge = [_ctc_beta_args(a) for a in _ctc_edge_cases(randn, dev)]
    impossible = edge[1]
    if not float(impossible[5][7]) > 1e29:
        raise SystemExit("chip_smoke: the impossible CTC alignment has a finite NLL")
    checks = [(lambda a=a: k6.ctc_beta_grad(*a), lambda a=a: k6.ctc_beta_grad_plain(*a))
              for a in edge]
    checks.append((lambda: k6.ctc_beta_grad(*impossible)[7].abs().max(),
                   lambda: torch.zeros((), device=dev)))
    checks += [(lambda a=a: (k6.ctc_beta_grad(*a) != k6.ctc_beta_grad(*a)).sum().float(),
                lambda: torch.zeros((), device=dev)) for a in (args, edge[3])]
    timed, timed_plain, bounds = _timed_by_shape(
        K6_SHAPES, lambda *sh: _ctc_beta_args(_ctc_shape_inputs(randn, dev, *sh)),
        k6.ctc_beta_grad, k6.ctc_beta_grad_plain, _ctc_beta_cost, ctc_shape_key)
    nbytes = _ctc_beta_cost(B_, T, C, S)
    return dict(
        name="ctc_beta_grad", replaces="semi_tts_tpu/ops/ctc.py:123 (_ctc_nll_bwd: beta "
        "recursion, occupancies, one-hot gradient einsum)",
        source="semi_tts_tpu_torch/csrc/ctc.cu", shapes=f"log_probs ({B_},{T},{C}), S={S}",
        kernel=lambda: k6.ctc_beta_grad(*args), plain=lambda: k6.ctc_beta_grad_plain(*args),
        checks=checks, library=_ctc_library(*args[:4], backward=True), library_timing="eager",
        library_note="F.ctc_loss forward + backward, reduction mean, on the card (CUDA events, "
        "eager; includes the forward)", tol=1e-4, nbytes=nbytes, iters=50,
        steps=T, timed=timed, timed_plain=timed_plain,
        timed_library={ctc_shape_key(*sh): _ctc_library(*_ctc_shape_inputs(randn, dev, *sh),
                                                        backward=True) for sh in K6_SHAPES},
        extra={"bound_ms_by_shape": bounds, "plans": _ctc_plans()})


def _lstm_bwd_inputs(randn, unif, T, B_, H, ndir=2):
    """W_hh, gate pre-activations (T, B, 4H) per direction, cell states and
    the gradient of hs (T, B, ndir*H); the second direction None for one."""
    w = [unif(4 * H, H, a=H ** -0.5) for _ in range(ndir)]
    gates = [randn(T, B_, 4 * H) for _ in range(ndir)]
    if ndir == 1:
        w, gates = w + [None], gates + [None]
    return w + gates + [randn(T, B_, ndir * H, scale=0.5), randn(T, B_, ndir * H)]


def _lstm_bwd_cost(T, B_, H, ndir=2):
    """Bytes moved by one K7 call: gates in and dgates out per direction, cs
    and g_hs, W_hh per direction."""
    return 4 * (2 * ndir * T * B_ * 4 * H + 2 * T * B_ * ndir * H + ndir * 4 * H * H)


def _gru_bwd_cost(T, B_, H, ndir=2):
    """Bytes moved by one K8 call: z, coef_h, g_hs and dh2, W_hh per
    direction."""
    return ndir * 4 * (T * B_ * H * 6 + 3 * H * H)


def shape_key(T, B_, H, ndir=2):
    return f"T={T} B={B_} H={H}" + ("" if ndir == 2 else f" ndir={ndir}")


def _timed_by_shape(shapes, inputs, kernel, plain, cost, key=shape_key):
    """``timed``, ``timed_plain`` and ``bound_ms_by_shape`` of a kernel at
    each shape of ``shapes`` (a recurrence's (T, B, H[, ndir]), or K6's
    (B, T, C, S) with ``key=ctc_shape_key``)."""
    args = {key(*sh): inputs(*sh) for sh in shapes}
    return ({k: lambda a=a: kernel(*a) for k, a in args.items()},
            {k: lambda a=a: plain(*a) for k, a in args.items()},
            {key(*sh): bound(cost(*sh), lambda a=args[key(*sh)]: kernel(*a))[0] for sh in shapes})


# (T, B, H, ndir) of K7 in the train steps: the ASR BiLSTM (T=133) on 8
# (ASR and paired steps) or 16 rows (cycles), the TTS encoder's (T=32 tokens)
# on 8 or 16 rows; the text LM's one direction; the run adds any other shape the steps
# give the wrappers
K7_SHAPES = ((133, 8, 256, 2), (133, 16, 256, 2), (32, 8, 256, 2), (32, 16, 256, 2),
             (TEXTLM_T, 8, TEXTLM_H, 1))
# (T, B, H, ndir) of K8, the CBHG BiGRU over the paired (8) or paired + unpaired (16)
# rows, and RNNLM-GRU's one direction at H=128
K8_SHAPES = ((PAIRED_T, 8, 80, 2), (PAIRED_T, 16, 80, 2), (GRU_LM_T, 8, GRU_LM_H, 1))


def _case_lstm_bwd(randn, unif, dev):
    """K7 at the ASR BiLSTM's train-step shape (T=133, B=8, H=256, both
    directions in one launch); also at T=1, B=5, H=80, one direction, and
    one direction at H=288 (the largest it takes) on a ragged batch. Timed
    at every shape of `K7_SHAPES` (``ms_by_shape``, ``plain_ms_by_shape``,
    ``bound_ms_by_shape``)."""
    from semi_tts_tpu_torch.kernels import rnn as k17

    T, H, D = 133, 256, 512
    args = _lstm_bwd_inputs(randn, unif, T, TRAIN_B, H)
    others = [_lstm_bwd_inputs(randn, unif, 1, TRAIN_B, H), _lstm_bwd_inputs(randn, unif, 40, 5, H),
              _lstm_bwd_inputs(randn, unif, 40, 5, 80), _lstm_bwd_inputs(randn, unif, T, 5, H, 1),
              _lstm_bwd_inputs(randn, unif, 40, 5, k17.LSTM_MAX_H, 1)]
    timed, timed_plain, bounds = _timed_by_shape(
        K7_SHAPES, lambda T_, B_, H_, n: _lstm_bwd_inputs(randn, unif, T_, B_, H_, n),
        k17.bilstm_rec_bwd, k17.bilstm_rec_bwd_plain, _lstm_bwd_cost)
    checks = [(lambda a=a: k17.bilstm_rec_bwd(*a), lambda a=a: k17.bilstm_rec_bwd_plain(*a))
              for a in others]
    lstm = torch.nn.LSTM(D, H, bidirectional=True).to(dev)
    x = randn(T, TRAIN_B, D).requires_grad_(True)
    with torch.enable_grad():
        y, _ = lstm(x)
    gy = randn(*y.shape)
    leaves = [x] + list(lstm.parameters())
    _, lstm1, x1 = _lstm_one_dir(randn, unif, TEXTLM_T, TRAIN_B, TEXTLM_H, TEXTLM_D, dev)
    return dict(
        name="bilstm_rec_bwd", replaces="semi_tts_tpu/ops/rnn.py:114 (_lstm_rec_bwd, the "
        "backward scan of the custom VJP of _lstm_rec), both directions",
        source="semi_tts_tpu_torch/csrc/rnn.cu",
        shapes=f"2 x gates ({T},{TRAIN_B},{4 * H}), W_hh ({4 * H},{H})", steps=T,
        kernel=lambda: k17.bilstm_rec_bwd(*args), plain=lambda: k17.bilstm_rec_bwd_plain(*args),
        checks=checks,
        library=lambda: torch.autograd.grad(y, leaves, gy, retain_graph=True),
        library_timing="eager",
        library_note="the backward of cuDNN nn.LSTM(bidirectional=True): also the input "
        "GEMM's data and weight gradients and dW_hh (CUDA events, eager); by shape: "
        "nn.LSTM() one direction", tol=1e-4,
        nbytes=_lstm_bwd_cost(T, TRAIN_B, H), iters=10,
        timed=timed, timed_plain=timed_plain,
        timed_library={**{shape_key(*sh): _rnn_library_backward(torch.nn.LSTM, randn, dev, *sh, D)
                          for sh in K7_SHAPES if sh[3] == 2},
                       shape_key(TEXTLM_T, TRAIN_B, TEXTLM_H, 1): _library_backward(lstm1, x1, randn)},
        extra={"plan": k17.lstm_bwd_plan(TRAIN_B, H, 2, k17.max_clusters(H, "lstm_rec_bwd")),
               "bound_ms_by_shape": bounds})


def _case_lstm_cs(randn, unif, dev):
    """K1 as training launches it (cell states kept) at the ASR BiLSTM's
    shape (T=133, B=8, H=256); also at T=1, B=5, H=80 and one direction."""
    from semi_tts_tpu_torch.kernels import rnn as k17

    T, H, D = 133, 256, 512
    args = _lstm_inputs(randn, unif, T, TRAIN_B, H)
    one = _lstm_inputs(randn, unif, T, 5, H)
    checks = [(lambda a=a: k17.bilstm_rec_cs(*a), lambda a=a: k17.bilstm_rec_cs_plain(*a))
              for a in (_lstm_inputs(randn, unif, 1, TRAIN_B, H), _lstm_inputs(randn, unif, 40, 5, H),
                        _lstm_inputs(randn, unif, 40, 5, 80))]
    checks.append((lambda: k17.bilstm_rec_cs(one[0], None, one[2], None),
                   lambda: k17.bilstm_rec_cs_plain(one[0], None, one[2], None)))
    lstm, x_in = torch.nn.LSTM(D, H, bidirectional=True).to(dev), randn(T, TRAIN_B, D)
    lm_args, lstm1, x1 = _lstm_one_dir(randn, unif, TEXTLM_T, TRAIN_B, TEXTLM_H, TEXTLM_D, dev)
    key = shape_key(TEXTLM_T, TRAIN_B, TEXTLM_H, 1)
    cost1 = _lstm_cs_cost(TEXTLM_T, TRAIN_B, TEXTLM_H, 1)
    return dict(
        name="bilstm_rec_cs", replaces="tools/proto_pallas_rnn.py:33 (pallas_lstm_rec); "
        "semi_tts_tpu/ops/rnn.py:95 (_lstm_rec_fwd, which keeps cs for the backward)",
        source="semi_tts_tpu_torch/csrc/rnn.cu",
        shapes=f"2 x x_proj ({T},{TRAIN_B},{4 * H}) -> hs, cs ({T},{TRAIN_B},{2 * H})", steps=T,
        kernel=lambda: k17.bilstm_rec_cs(*args), plain=lambda: k17.bilstm_rec_cs_plain(*args),
        checks=checks, library=lambda: lstm(x_in),
        library_note="cuDNN nn.LSTM(bidirectional=True) forward, includes the input GEMM; "
        "graph-timed; by shape: nn.LSTM() one direction", tol=1e-4,
        nbytes=_lstm_cs_cost(T, TRAIN_B, H), iters=10,
        timed={key: lambda: k17.bilstm_rec_cs(*lm_args)},
        timed_plain={key: lambda: k17.bilstm_rec_cs_plain(*lm_args)},
        timed_library={key: lambda: lstm1(x1)},
        extra={"bound_ms_by_shape": {key: bound(cost1, lambda: k17.bilstm_rec_cs(*lm_args))[0]},
               "plans_by_shape": {key: k17.lstm_plan(TRAIN_B, TEXTLM_H, 1,
                                                     k17.max_clusters(TEXTLM_H))}})


def _lstm_cs_cost(T, B_, H, ndir=2):
    """Bytes moved by one K1 call with cell states: x_proj in, hs and cs
    out, W_hh per direction."""
    return ndir * 4 * (T * B_ * 4 * H + 4 * H * H + 2 * T * B_ * H)


def _gru_bwd_inputs(randn, unif, T, B_, H, ndir=2):
    """Each direction's W_hh, update gates z (T, B, H) and coefficients
    coef_h (T, B, 3H), the second direction's None for one, and the gradient
    of hs (T, B, ndir*H)."""
    w = [unif(3 * H, H, a=H ** -0.5) for _ in range(ndir)]
    z = [torch.sigmoid(randn(T, B_, H)) for _ in range(ndir)]
    c = [randn(T, B_, 3 * H, scale=0.3) for _ in range(ndir)]
    if ndir == 1:
        w, z, c = w + [None], z + [None], c + [None]
    return w + z + c + [randn(T, B_, ndir * H)]


def _case_gru_bwd(randn, unif, dev):
    """K8 at the CBHG BiGRU's paired-step shape (T=243, B=8, H=80, both
    directions in one launch); also at T=37, B=3, H=50, at T=1, at H=128,
    the largest K2 takes, and one direction. Timed at every shape of
    `K8_SHAPES`, the one-direction shape beside cuDNN's unidirectional GRU
    backward (``library_ms_by_shape``)."""
    from semi_tts_tpu_torch.kernels import rnn as k8

    T, H = PAIRED_T, 80
    args = _gru_bwd_inputs(randn, unif, T, TRAIN_B, H)
    timed, timed_plain, bounds = _timed_by_shape(
        K8_SHAPES, lambda T_, B_, H_, n: _gru_bwd_inputs(randn, unif, T_, B_, H_, n),
        k8.bigru_rec_bwd, k8.bigru_rec_bwd_plain, _gru_bwd_cost)
    others = [_gru_bwd_inputs(randn, unif, 37, 3, 50), _gru_bwd_inputs(randn, unif, 1, 3, H),
              _gru_bwd_inputs(randn, unif, 20, 5, 128), _gru_bwd_inputs(randn, unif, 37, 3, H, 1)]
    _, gru1, x1 = _gru_one_dir(randn, unif, GRU_LM_T, TRAIN_B, GRU_LM_H, dev)
    gru = torch.nn.GRU(H, H, bidirectional=True).to(dev)
    x = randn(T, TRAIN_B, H).requires_grad_(True)
    with torch.enable_grad():
        y, _ = gru(x)
    gy = randn(*y.shape)
    leaves = [x] + list(gru.parameters())
    return dict(
        name="bigru_rec_bwd", replaces="semi_tts_tpu/ops/rnn.py:244 (_gru_rec_bwd, the backward "
        "scan of the custom VJP of _gru_rec), both directions",
        source="semi_tts_tpu_torch/csrc/rnn.cu",
        shapes=f"2 x z ({T},{TRAIN_B},{H}), 2 x coef_h ({T},{TRAIN_B},{3 * H}), W_hh ({3 * H},{H})",
        steps=T, kernel=lambda: k8.bigru_rec_bwd(*args), plain=lambda: k8.bigru_rec_bwd_plain(*args),
        checks=[(lambda a=a: k8.bigru_rec_bwd(*a), lambda a=a: k8.bigru_rec_bwd_plain(*a))
                for a in others],
        library=lambda: torch.autograd.grad(y, leaves, gy, retain_graph=True),
        library_timing="eager",
        library_note="the backward of cuDNN nn.GRU(bidirectional=True): also the input GEMM's "
        "data and weight gradients and dW_hh (CUDA events, eager); by shape: nn.GRU() one "
        "direction", tol=1e-4,
        timed_library={**{shape_key(*sh): _rnn_library_backward(torch.nn.GRU, randn, dev, *sh, H)
                          for sh in K8_SHAPES if sh[3] == 2},
                       shape_key(GRU_LM_T, TRAIN_B, GRU_LM_H, 1): _library_backward(gru1, x1, randn)},
        nbytes=_gru_bwd_cost(T, TRAIN_B, H), iters=10,
        timed=timed, timed_plain=timed_plain, extra={"plan": k8.gru_bwd_plan(TRAIN_B, H, 2),
                                                     "bound_ms_by_shape": bounds})


@contextlib.contextmanager
def k9_span(k9, span):
    """K9 launched with ``span`` positions a CTA in place of its plan's."""
    plan = k9.attention_bwd_plan

    def forced(B, L, A, D, C, F_, K):
        S = -(-L // span)
        return dict(plan(B, L, A, D, C, F_, K), span=span, spans=S, grid=(S, B),
                    part_floats=B * S * k9._bwd_part_floats(span, A, C, F_, K))

    k9.attention_bwd_plan = forced
    try:
        yield
    finally:
        k9.attention_bwd_plan = plan


def _case_attention_bwd(randn, unif, dev):
    """K9, one decoder step's attention backward at the paired step's shapes
    (B=8, L=32 tokens); also at L=45 and B=3, at L=5 (nearly every tap of
    the 31-wide location conv reaches the padding), with a padding mask, at
    L=280, at L=1 and without location features; at the text-first step's
    shape (B=16, L=32), the speech-first step's (B=16, L=133), at L=700 (a
    15 s unpaired utterance's memory) and at L=1,187 (the longest one K3 cluster holds
    at these widths); with every span of `SPANS` in place of the plan's (at
    L=45 masked and at B=16 L=133); and at A=1024 F=64, where loc_lin does
    not fit in shared memory. Timed at every shape a step gives it, beside
    the plain version and the bound (``ms_by_shape``, ``plain_ms_by_shape``,
    ``bound_ms_by_shape``; ``plans``: each shape's span, spans, grid and
    shared memory). The forward's weights and context come from K3 on the
    same inputs."""
    from semi_tts_tpu_torch.kernels import attention as k9

    L, A, D, C, F_, K = 32, 256, 512, 2, 32, 31
    wts = (unif(F_, C, K, a=0.3), unif(A, F_, a=0.3), unif(A, a=0.1))
    wide = (unif(64, C, K, a=0.3), unif(1024, 64, a=0.3), unif(1024, a=0.1))

    def inputs(B_, L, mask=False, loc=True, wts=wts):
        A = wts[2].shape[0]
        pq, pm, mem = randn(B_, A), randn(B_, L, A, scale=0.5), randn(B_, L, D)
        w = torch.softmax(randn(B_, L), -1)
        hist = torch.stack([w, w + torch.softmax(randn(B_, L), -1)], 1).contiguous()
        lw, ll = wts[:2] if loc else (None, None)
        m = None
        if mask:
            lengths = L - 12 + torch.arange(B_, device=dev) % 13
            m = torch.arange(L, device=dev)[None, :] >= lengths[:, None]
        context, weights = k9.attention_step(pq, pm, mem, hist, lw, ll, wts[2], m)
        return (pq, pm, mem, hist, lw, ll, wts[2], weights, context, randn(B_, D), randn(B_, L))

    args = inputs(TRAIN_B, L)
    text_first, cycle = inputs(2 * TRAIN_B, L), inputs(2 * TRAIN_B, 133)
    long, longest = inputs(2, 700), inputs(2, 1187)
    masked, wide_args = inputs(3, 45, mask=True), inputs(3, 45, mask=True, wts=wide)
    if k9.attention_bwd_plan(3, 45, 1024, D, C, 64, K)["stage_lin"]:
        raise SystemExit("chip_smoke: K9's plan stages loc_lin at A=1024 F=64")
    others = [inputs(3, 45), inputs(TRAIN_B, 5), masked, inputs(3, 280), inputs(5, 1),
              inputs(3, 45, loc=False), text_first, cycle, long, longest, wide_args]
    checks = [(lambda a=a: k9.attention_step_bwd(*a), lambda a=a: k9.attention_step_bwd_plain(*a))
              for a in others]

    def at_span(P, a):
        with k9_span(k9, P):
            return k9.attention_step_bwd(*a)

    checks += [(lambda P=P, a=a: at_span(P, a), lambda a=a: k9.attention_step_bwd_plain(*a))
               for P in k9.SPANS for a in (masked, cycle)]

    def cost(B_, L):  # bytes moved by one call
        return 4 * (2 * (B_ * A + B_ * L * A + B_ * L * D + B_ * C * L + F_ * C * K + A * F_ + A)
                    + 2 * B_ * L + B_ * D)

    by_shape = {f"B={a[0].shape[0]} L={a[1].shape[1]}": a
                for a in (args, text_first, cycle, long, longest)}
    timed = {n: lambda a=a: k9.attention_step_bwd(*a) for n, a in by_shape.items()}
    timed_plain = {n: lambda a=a: k9.attention_step_bwd_plain(*a) for n, a in by_shape.items()}
    plans = {n: k9.attention_bwd_plan(a[0].shape[0], a[1].shape[1], A, D, C, F_, K)
             for n, a in by_shape.items()}
    B_ = TRAIN_B
    return dict(
        name="attention_step_bwd", replaces="semi_tts_tpu/models/attention.py:39 (autodiff of "
        "attention_step in the decoder's training scan, models/decoder.py:227; with the "
        "wgrad_probes of :91-127 as one GEMM per cell)",
        source="semi_tts_tpu_torch/csrc/attention.cu",
        shapes=f"B={B_} L={L} A={A} D={D} C={C} F={F_} K={K}",
        kernel=lambda: k9.attention_step_bwd(*args),
        plain=lambda: k9.attention_step_bwd_plain(*args), checks=checks, timed=timed,
        timed_plain=timed_plain,
        extra={"plans": {n: {k: p[k] for k in ("span", "spans", "grid", "smem_bytes")}
                         for n, p in plans.items()},
               "bound_ms_by_shape": {n: bound(cost(a[0].shape[0], a[1].shape[1]), f)[0]
                                     for (n, a), f in zip(by_shape.items(), timed.values())}},
        library=None, library_note=NO_LIBRARY, tol=1e-4, nbytes=cost(B_, L), iters=200)


def _trim_merge_inputs(randn, dev, B_, T, C=43, D=64, blank_row=False, long_runs=False,
                       ties=False):
    """(p_code, latent) shaped as the speech-first step's unpaired rows:
    softmax outputs over the 43 tokens and codebook latents. ``blank_row``:
    row 0's blank class wins everywhere; ``long_runs``: rows of runs of 5 to
    9 frames of one token (longer than max_frames_per_phn = 3); ``ties``:
    two classes (one of them the blank in places) exactly equal at the top."""
    p = torch.softmax(randn(B_, T, C, scale=3.0), -1)
    if blank_row:
        p[0, :, 0] = 1.0
    if long_runs:
        tok = (torch.arange(T, device=dev)[None, :] // (5 + torch.arange(B_, device=dev)[:, None] % 5)
               * 7 + 3) % C
        p = torch.full((B_, T, C), 0.01, device=dev).scatter_(2, tok[..., None], 0.9)
    if ties:
        p = torch.full((B_, T, C), 0.01, device=dev)
        p[:, :, 4] = p[:, :, 9] = 0.4
        p[:, T // 3:T // 2, 0] = 0.4
    return p, randn(B_, T, D)


def _case_trim_merge(randn, unif, dev):
    """B6 at the speech-first step's shapes: the unpaired rows' p_code
    (8, 133, 43) and quantized latents (8, 133, 64), max_frames_per_phn 3.
    Also at T=1, at T=680 (a 15 s utterance), with an all-blank row, with
    runs longer than max_frames_per_phn and with exact ties. The checks
    compare the trimmed latents, the lengths, the per-frame slots and
    counts, and ``ok``; the timed calls are the kernel and its plain version
    alone, also at every shape of `B6_SHAPES` (``ms_by_shape``,
    ``plain_ms_by_shape``, ``bound_ms_by_shape``; ``plans``:
    `trim_merge_plan` at each). T=1,500 takes the split route (the tokens
    over the card, the scans a CTA a row, the means over the card)."""
    from semi_tts_tpu_torch.kernels import quantize as b6

    B_, T, C, D_ = TRAIN_B, 133, 43, 64
    p, lat = _trim_merge_inputs(randn, dev, B_, T)

    def pair(p, lat):
        def ok_too(fn):
            out = fn(p, lat, 3)
            return out + ((out[1] > 0).all().float(),)
        return (lambda: ok_too(b6.trim_merge), lambda: ok_too(b6.trim_merge_plain))

    cases = [_trim_merge_inputs(randn, dev, 3, 1), _trim_merge_inputs(randn, dev, 2, 680),
             _trim_merge_inputs(randn, dev, 3, 50, blank_row=True),
             _trim_merge_inputs(randn, dev, 5, 60, long_runs=True),
             _trim_merge_inputs(randn, dev, 2, 40, ties=True),
             _trim_merge_inputs(randn, dev, 2, 1500, long_runs=True)]  # the split route
    by_shape = {f"B={b} T={t}": _trim_merge_inputs(randn, dev, b, t) for b, t in B6_SHAPES}
    return dict(
        name="trim_merge", replaces="semi_tts_tpu/ops/quantize.py:26 (trim_merge_segments: "
        "argmax, segment-id scan, segment_sum means, cumsum compaction)",
        source="semi_tts_tpu_torch/csrc/quantize.cu",
        shapes=f"p_code ({B_},{T},{C}), latent ({B_},{T},{D_}) -> trimmed ({B_},{T},{D_})",
        kernel=lambda: b6.trim_merge(p, lat, 3), plain=lambda: b6.trim_merge_plain(p, lat, 3),
        checks=[pair(*c) for c in [(p, lat)] + cases],
        library=None, library_note=NO_LIBRARY, tol=1e-6,
        nbytes=_trim_merge_cost(B_, T, C, D_), iters=200,
        timed={k: lambda a=a: b6.trim_merge(*a, 3) for k, a in by_shape.items()},
        timed_plain={k: lambda a=a: b6.trim_merge_plain(*a, 3) for k, a in by_shape.items()},
        extra={"bound_ms_by_shape": {
                   f"B={b} T={t}": bound(_trim_merge_cost(b, t, C, D_),
                                         lambda a=by_shape[f"B={b} T={t}"]: b6.trim_merge(*a, 3))[0]
                   for b, t in B6_SHAPES},
               "plans": {f"B={b} T={t}": b6.trim_merge_plan(t, C, D_) for b, t in B6_SHAPES}})


# (B, T) of B6 timed by shape: the flagship speech-first step's unpaired rows
# and the 15.28 s utterance's
B6_SHAPES = ((TRAIN_B, 133), (1, 680))


def _trim_merge_cost(B_, T, C, D_):
    """B6's bytes: p_code, latent and trimmed, lengths, slots and counts."""
    return 4 * (B_ * T * C + 2 * B_ * T * D_ + B_ + 2 * B_ * T)


# (B, T) of B6's backward timed by shape: the flagship speech-first step's
# unpaired rows, both batches' rows, and the 15.28 s utterance's
B6_BWD_SHAPES = ((TRAIN_B, 133), (2 * TRAIN_B, 133), (1, 680))


def _trim_merge_bwd_cost(B_, T, D_):
    """B6 backward's bytes: d_trimmed in, d_latent out, slots and counts."""
    return 4 * (2 * B_ * T * D_ + 2 * B_ * T)


def _case_trim_merge_bwd(randn, unif, dev):
    """B6's backward at the speech-first step's shapes, from the slots and
    counts of the forward; also at T=1, T=680, with an all-blank row, with
    runs longer than max_frames_per_phn, at D=12 and D=3 (float4 and scalar
    loads) and on rows that are not 16-byte aligned (scalar loads). Held to
    the plain version bit for bit (tolerance 0: both divide by the count).
    Timed at every shape of `B6_BWD_SHAPES` (``ms_by_shape``,
    ``plain_ms_by_shape``, ``bound_ms_by_shape``; ``plans``:
    `trim_merge_bwd_plan` at each)."""
    from semi_tts_tpu_torch.kernels import quantize as b6

    def inputs(*a, D=64, **k):
        p, lat = _trim_merge_inputs(randn, dev, *a, D=D, **k)
        _, _, slot, count = b6.trim_merge_plain(p, lat, 3)
        return randn(*lat.shape), slot, count

    def unaligned(B_, T):  # d_trimmed one float into its storage
        d, slot, count = inputs(B_, T)
        return randn(d.numel() + 1)[1:].view(d.shape).copy_(d), slot, count

    B_, T, D_ = TRAIN_B, 133, 64
    args = inputs(B_, T)
    cases = [inputs(3, 1), inputs(2, 680), inputs(3, 50, blank_row=True),
             inputs(5, 60, long_runs=True), inputs(4, 50, D=12), inputs(4, 50, D=3),
             unaligned(B_, T)]
    by_shape = {f"B={b} T={t}": inputs(b, t) for b, t in B6_BWD_SHAPES}
    return dict(
        name="trim_merge_bwd", replaces="semi_tts_tpu/ops/quantize.py:26 (the autodiff of "
        "trim_merge_segments: the transpose of segment_sum and of the compaction scatter)",
        source="semi_tts_tpu_torch/csrc/quantize.cu",
        shapes=f"d_trimmed ({B_},{T},{D_}), slot and count ({B_},{T}) -> d_latent",
        kernel=lambda: b6.trim_merge_bwd(*args), plain=lambda: b6.trim_merge_bwd_plain(*args),
        checks=[(lambda a=a: b6.trim_merge_bwd(*a), lambda a=a: b6.trim_merge_bwd_plain(*a))
                for a in cases],
        library=None, library_note=NO_LIBRARY, tol=0.0,
        nbytes=_trim_merge_bwd_cost(B_, T, D_), iters=200,
        timed={k: lambda a=a: b6.trim_merge_bwd(*a) for k, a in by_shape.items()},
        timed_plain={k: lambda a=a: b6.trim_merge_bwd_plain(*a) for k, a in by_shape.items()},
        extra={"bound_ms_by_shape": {f"B={b} T={t}": bound(
                   _trim_merge_bwd_cost(b, t, D_),
                   lambda a=by_shape[f"B={b} T={t}"]: b6.trim_merge_bwd(*a))[0]
                   for b, t in B6_BWD_SHAPES},
               "plans": {f"B={b} T={t}": b6.trim_merge_bwd_plan(b, t, D_)
                         for b, t in B6_BWD_SHAPES}})


def record_recurrence_shapes():
    """Record every (T, B, H[, ndir]) that the train steps give K7 and K8
    and every (B, T, C, S) they give K6 on the card, into the returned
    {wrapper name: set of shapes}: the autograd Functions of ``ops/rnn.py``
    and ``ops/ctc.py`` call the wrappers by the names they imported, which
    this wraps (the wrappers still count their own launches)."""
    from semi_tts_tpu_torch.ops import ctc as ops_ctc, rnn as ops_rnn

    seen = {"bilstm_rec_bwd": set(), "bigru_rec_bwd": set(), "ctc_alpha": set(),
            "ctc_beta_grad": set()}

    def wrap(module, name, shape_of):
        fn = getattr(module, name)

        def recorded(*a):
            if a[2].is_cuda:
                seen[name].add(shape_of(*a))
            return fn(*a)
        setattr(module, name, recorded)

    wrap(ops_rnn, "bilstm_rec_bwd", lambda w_f, w_b, g_f, g_b, *_: (
        *g_f.shape[:2], w_f.shape[1], 1 if g_b is None else 2))
    wrap(ops_rnn, "bigru_rec_bwd", lambda w_f, w_b, z_f, *_: (
        *z_f.shape[:2], w_f.shape[1], 1 if w_b is None else 2))
    for name in ("ctc_alpha", "ctc_beta_grad"):
        wrap(ops_ctc, name, lambda lp, tg, *_: (*lp.shape, 2 * tg.shape[1] + 1))
    return seen


def _seen_library(name, sh, randn, unif, dev):
    """The PyTorch library call beside a K7, K8 or K6 shape the steps gave
    (the yardsticks of phase 3's ``library_ms_by_shape``): cuDNN's LSTM
    (input 512 both ways, the text LM's 48 one way) or GRU (input H)
    backward, or ``F.ctc_loss`` forward (K6 alpha) or forward and backward
    (K6 beta)."""
    if name == "bilstm_rec_bwd":
        T, B_, H, ndir = sh
        if ndir == 2:
            return _rnn_library_backward(torch.nn.LSTM, randn, dev, T, B_, H, 2, 512)
        return _library_backward(*_lstm_one_dir(randn, unif, T, B_, H, TEXTLM_D, dev)[1:], randn)
    if name == "bigru_rec_bwd":
        T, B_, H, ndir = sh
        if ndir == 2:
            return _rnn_library_backward(torch.nn.GRU, randn, dev, T, B_, H, 2, H)
        return _library_backward(*_gru_one_dir(randn, unif, T, B_, H, dev)[1:], randn)
    return _ctc_library(*_ctc_shape_inputs(randn, dev, *sh), backward=name == "ctc_beta_grad")


def time_seen_shapes(table, dev, seen_shapes):
    """K7, K8 and K6 at each shape the train steps gave them that phase 3
    did not time: held to the plain version and timed as phase 3 times its
    shapes, beside the library call of `_seen_library` (eager, CUDA events);
    ``shapes_seen`` lists every shape the steps gave them."""
    from semi_tts_tpu_torch.kernels import rnn as k

    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def unif(*shape, a):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * a

    from semi_tts_tpu_torch.kernels import ctc as k6

    specs = {"bilstm_rec_bwd": (lambda *sh: _lstm_bwd_inputs(randn, unif, *sh), k.bilstm_rec_bwd,
                                k.bilstm_rec_bwd_plain, _lstm_bwd_cost, shape_key),
             "bigru_rec_bwd": (lambda *sh: _gru_bwd_inputs(randn, unif, *sh), k.bigru_rec_bwd,
                               k.bigru_rec_bwd_plain, _gru_bwd_cost, shape_key),
             "ctc_alpha": (lambda *sh: _ctc_shape_inputs(randn, dev, *sh), k6.ctc_alpha,
                           k6.ctc_alpha_plain, _ctc_alpha_cost, ctc_shape_key),
             "ctc_beta_grad": (lambda *sh: _ctc_beta_args(_ctc_shape_inputs(randn, dev, *sh)),
                               k6.ctc_beta_grad, k6.ctc_beta_grad_plain, _ctc_beta_cost,
                               ctc_shape_key)}
    for row in table:
        if row["name"] not in specs:
            continue
        inputs, kernel, plain, cost, key_of = specs[row["name"]]
        seen = sorted(seen_shapes[row["name"]])
        row["shapes_seen"] = [key_of(*sh) for sh in seen]
        with torch.no_grad():
            for sh in seen:
                key = key_of(*sh)
                if key in row["ms_by_shape"]:
                    continue
                a = inputs(*sh)
                err = max_err(kernel(*a), plain(*a))
                if not err <= row["tol"]:
                    raise SystemExit(f"chip_smoke: {row['name']} disagrees with its plain "
                                     f"version at {key}: {err}")
                row["ms_by_shape"][key] = device_ms(lambda: kernel(*a), 10)
                row["plain_ms_by_shape"][key] = device_ms(lambda: plain(*a), 2)
                row["bound_ms_by_shape"][key] = bound(cost(*sh), lambda: kernel(*a))[0]
                lib = _seen_library(row["name"], sh, randn, unif, dev)
                row.setdefault("library_ms_by_shape", {})[key] = time_ms(lib, 10)


def kernel_cases(dev):
    """One dict per kernel at its serving shapes: the kernel call, its plain
    version, a PyTorch library call or None, tolerance, bytes, FLOPs."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def unif(*shape, a):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * a

    return [case(randn, unif, dev) for case in
            (_case_lstm, _case_gru, _case_attention, _case_gl_project, _case_gl_ola_frame,
             _case_stft_frames, _case_spec_db, _case_ctc_alpha, _case_ctc_beta_grad,
             _case_lstm_cs, _case_lstm_bwd, _case_gru_bwd, _case_attention_bwd,
             _case_trim_merge, _case_trim_merge_bwd)]


def phase_kernels(dev):
    out = []
    with torch.no_grad():
        for c in kernel_cases(dev):
            timed = [(f, c["timed_plain"][k]) for k, f in c.get("timed", {}).items()]
            err = max(max_err(kernel(), plain())
                      for kernel, plain in [(c["kernel"], c["plain"])] + c.get("checks", []) + timed)
            print(f"kernel {c['name']}: max_abs_err {err:.3e} (tol {c['tol']:.0e})", flush=True)
            if not err <= c["tol"]:
                raise SystemExit(f"chip_smoke: {c['name']} disagrees with its plain version")
            ms = device_ms(c["kernel"], c["iters"])
            eager_ms = time_ms(c["kernel"], c["iters"])
            plain_ms = device_ms(c["plain"], max(2, c["iters"] // 10))
            lib_time = time_ms if c.get("library_timing") == "eager" else device_ms
            lib_ms = lib_time(c["library"], c["iters"]) if c["library"] else None
            bound_ms, bound_by = bound(c["nbytes"], c["kernel"])
            row = {"name": c["name"], "route": "cuda", "source": c["source"],
                   "replaces": c["replaces"], "shapes": c["shapes"],
                   "launches": None, "max_abs_err": err, "max_err": err, "tol": c["tol"],
                   "ms": ms, "kernel_ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                   "library": c.get("library_note")}
            if "steps" in c:
                row["ms_per_step"] = ms / c["steps"]
                row["us_per_step"] = 1e3 * ms / c["steps"]
            if "rows" in c:
                row["ms_by_rows"] = {r: device_ms(lambda r=r: c["rows"](r), c["iters"])
                                     for r in c["row_options"]}
            if "timed" in c:
                row["ms_by_shape"] = {k: device_ms(f, max(10, c["iters"] // 4))
                                      for k, f in c["timed"].items()}
            if "timed_plain" in c:
                row["plain_ms_by_shape"] = {k: device_ms(f, max(2, c["iters"] // 40))
                                            for k, f in c["timed_plain"].items()}
            if "timed_library" in c:
                row["library_ms_by_shape"] = {k: lib_time(f, c["iters"])
                                              for k, f in c["timed_library"].items()}
            if "tiles" in c:
                row["ms_by_tile"] = {n: device_ms(lambda n=n: c["tiles"](n), c["iters"])
                                     for n in c["tile_options"]}
            row.update(c.get("extra", {}))
            out.append(row)
    return out


def serving_inputs(B, U, seed=0):
    """(text, sid) shaped like the JAX package's serving benches."""
    rng = np.random.RandomState(seed)
    text = np.zeros((B, U), np.int32)
    text[:, : U - 2] = rng.randint(3, 43, size=(B, U - 2))
    return text, rng.randint(0, 109, size=B).astype(np.int32)


def flagship_config(prenet_dropout=None):
    model = copy.deepcopy(FLAGSHIP_MODEL)
    model["codebook"]["phn_attr_pth"] = os.path.join(HERE, model["codebook"]["phn_attr_pth"])
    if prenet_dropout is not None:
        model["decoder"]["decoder"]["prenet_dropout"] = prenet_dropout
    return {"data": {"corpus": {"vocab_file": os.path.join(HERE, "data/cmu_phn.vocab"),
                                "spkr_map": os.path.join(HERE, "corpus_meta/spkr/lj_vctk.json")},
                     "audio": copy.deepcopy(FLAGSHIP_AUDIO)},
            "model": model}


def flagship_vqvae_config(config):
    from semi_tts_tpu_torch.data.text import load_text_encoder
    from semi_tts_tpu_torch.models import vqvae as V

    corpus = config["data"]["corpus"]
    with open(corpus["spkr_map"]) as f:
        n_spkr = len(json.load(f))
    vocab = load_text_encoder("phoneme", corpus["vocab_file"]).vocab_size
    return V.config_from_yaml(config["model"], n_mels=80, linear_dim=1025, vocab_size=vocab,
                              n_spkr=n_spkr, attr_dim=31)


def write_checkpoint(path, config):
    """A seeded random checkpoint; returns the number of parameters serving
    loads (all of them) and of its ASR half."""
    from semi_tts_tpu_torch.bridge import to_jax_params
    from semi_tts_tpu_torch.models import vqvae as V
    from semi_tts_tpu_torch.train.checkpoint import save_checkpoint

    model = V.VQVAE(flagship_vqvae_config(config), generator=torch.Generator().manual_seed(0))
    params, state = to_jax_params(model)
    save_checkpoint(path, params=params, state=state, opt_state={}, step=0)
    return (sum(p.numel() for p in model.parameters()),
            sum(p.numel() for n, p in model.named_parameters() if n.startswith("asr")))


def phase_serving(build_dir):
    """The serving phase through the server's bounded program LRU and CUDA
    graphs; ``peak_mem_bytes`` is torch.cuda.max_memory_allocated over the
    timed requests with the graphs alive, ``reserved_bytes`` what the
    allocator holds then (the graphs' pool included), ``mem_baseline_bytes``
    what was allocated when its count started (model, caches of earlier
    phases). The eager requests (`eager_request`, the stages run without a
    graph) are timed and profiled beside the graphed ones; ``flops`` are the
    matrix-product FLOPs of one eager request (`utils.flops.matmul_flops`)."""
    from semi_tts_tpu_torch import kernels
    from semi_tts_tpu_torch.serve import TTSServer
    from semi_tts_tpu_torch.utils.flops import matmul_flops

    ckpt = os.path.join(build_dir, "chip_smoke_ckpt.pth")
    try:
        n_params, n_asr = write_checkpoint(ckpt, flagship_config())
        server = TTSServer.from_checkpoint(flagship_config(), ckpt)
        text, sid = serving_inputs(B, U)
        steps = server.decode_steps_for(text)
        kernels.reset_launches()
        server.synthesize(text, sid, key=1)  # warm-up: captures the stages' graphs
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        walls = []
        for i in range(REQUESTS):
            t0 = time.perf_counter()
            out = server.synthesize(text, sid, key=2 + i)  # returns on the host: synchronised
            walls.append(time.perf_counter() - t0)
            if i == 0:
                wav = out
        wrapper_launches = kernels.launch_counts()  # at the capture; a replay moves none
        S = HOP * (steps * 3 - 1)
        if wav.shape != (B, S) or not np.isfinite(wav).all():
            raise SystemExit(f"chip_smoke: bad waveforms {wav.shape}, finite={np.isfinite(wav).all()}")
        if np.abs(wav).max() == 0.0:
            raise SystemExit("chip_smoke: all-zero waveforms")
        peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved()
        wall = float(np.median(walls))
        idle = [n for n in SERVING_KERNELS if wrapper_launches[n] == 0]
        if idle:
            raise SystemExit(f"chip_smoke: kernels not launched on the main path: {idle}")
        eager_walls = []
        for i in range(REQUESTS):
            t0 = time.perf_counter()
            eager_request(server, text, sid, 2 + i, steps)[-1].cpu()
            eager_walls.append(time.perf_counter() - t0)
        eager_wall = float(np.median(eager_walls))
        stage_s = stage_times(server, text, sid, steps)
        profile = profiled_step(lambda: server.synthesize(text, sid, key=99), wall)
        require_seen(profile["kernels_seen"], SERVING_KERNELS, "serving request")
        eager_profile = profiled_step(
            lambda: eager_request(server, text, sid, 99, steps)[-1].cpu(), eager_wall)
        flops = matmul_flops(eager_request, server, text, sid, 99, steps)
        synth, vocode = server.stages(steps, B, U)
        graphs = {"synth": graph_stats(synth), "vocode": graph_stats(vocode)}
        checks = serving_graph_checks(server, (text, sid))
        graphs["full"] = graph_stats(server._full_stage(steps, B, U))
        ref = reference_check(ckpt)
    finally:
        if os.path.exists(ckpt):
            os.remove(ckpt)
    return dict(batch=B, text_len=U, decode_steps=steps, frames=steps * 3, samples=S,
                params=n_params, asr_params=n_asr, wall_s=wall, walls_s=walls, utt_per_s=B / wall,
                eager_wall_s=eager_wall, eager_walls_s=eager_walls,
                busy_s=profile["device_busy_s"], idle_share=profile["idle_share"],
                eager_busy_s=eager_profile["device_busy_s"],
                eager_idle_share=eager_profile["idle_share"],
                device_events=profile["kernel_launches"],
                eager_device_events=eager_profile["kernel_launches"],
                # text and sid in, each graph's copies, replay and clones, the wave out
                host_launches=3 + graphs["synth"]["host_launches"]
                + graphs["vocode"]["host_launches"],
                graphs=graphs, peak_mem_bytes=peak, reserved_bytes=reserved,
                mem_baseline_bytes=base, stage_s=stage_s, profile=profile,
                eager_profile={k: eager_profile[k] for k in ("device_busy_s", "idle_share",
                                                             "kernel_launches")},
                launches=profile["kernels_seen"], wrapper_launches=wrapper_launches,
                graph_checks=checks, reference=ref, flops=flops)


def graph_stats(prog):
    """A graphed program's capture time (its capturing call's eager run included) and host
    launches a call (input copies, the replay, output clones)."""
    return {"capture_s": getattr(prog, "capture_s", None),
            "host_launches": getattr(prog, "host_launches", None)}


def eager_request(server, text, sid, key, steps, full=False):
    """One request through the serving stages run eagerly (no graph), its
    generator seeded with ``key`` as the server seeds its own: the waveform
    (B, S) on the device, after (mel, linear, align) with ``full``."""
    from semi_tts_tpu_torch.serve import full_stage, serving_stages

    t, s = server._place(text, sid)
    g = torch.Generator(device=server.device).manual_seed(int(key))
    synth, vocode = serving_stages(server.cfg, server.audio, server.phn_attr, steps)
    if full:
        mel, lin, align, amp = full_stage(server.cfg, server.phn_attr, steps)(server.model, t, s, g)
        return mel, lin, align, vocode(amp, g)
    return (vocode(synth(server.model, t, s, g), g),)


SERVING_KEYS = (7, 8)


def serving_graph_checks(server, flagship):
    """Graphed against eager on the card, bit for bit: `synthesize` and
    `synthesize_full` at the flagship bucket and at B=4 x U=20, two keys
    each; then a server of `program_cache_size` 1 alternating the two
    buckets (each request evicts the other's graphs and captures its own)
    gives the same waveforms."""
    from semi_tts_tpu_torch.models import vqvae as V
    from semi_tts_tpu_torch.serve import TTSServer

    buckets = {"B=16 U=32": flagship, "B=4 U=20": serving_inputs(4, 20, seed=1)}
    r, out, wavs = server.cfg.n_frames_per_step, {}, {}
    for name, (text, sid) in buckets.items():
        steps = server.decode_steps_for(text)
        enc = np.sum(text != 0, -1)
        # a program's capturing call runs eagerly: capture first, so that
        # every compared request replays
        server.synthesize(text, sid, key=SERVING_KEYS[0])
        server.synthesize_full(text, sid, key=SERVING_KEYS[0])
        for key in SERVING_KEYS:
            wav = server.synthesize(text, sid, key=key)
            want = eager_request(server, text, sid, key, steps)[0].cpu().numpy()
            full = server.synthesize_full(text, sid, key=key)
            mel, lin, align, fwav = (t.cpu().numpy() for t in
                                     eager_request(server, text, sid, key, steps, full=True))
            crop = [align[i][: int(enc[i] * V.FRAME_PHN_RATIO) // r, : enc[i]]
                    for i in range(len(enc))]
            same = {"synthesize": bool(np.array_equal(wav, want)),
                    "full_wav": bool(np.array_equal(full["wav"], fwav)),
                    "full_mel": bool(np.array_equal(full["mel"], mel)),
                    "full_linear": bool(np.array_equal(full["linear"], lin)),
                    "full_align": all(np.array_equal(a, b) for a, b in zip(full["align"], crop))}
            out[f"{name} key {key}"] = dict(decode_steps=steps, **same,
                                            max_abs_err=float(np.abs(wav - want).max()))
            wavs[name, key] = wav
            if not all(same.values()):
                raise SystemExit(f"chip_smoke: graphed and eager serving differ at {name}, key "
                                 f"{key}: {out}")
    small = TTSServer(server.cfg, server.audio, server.phn_attr.cpu(), server.model,
                      device=server.device, program_cache_size=1)
    alternating = []
    for key in SERVING_KEYS:
        for name, (text, sid) in buckets.items():
            alternating.append(bool(np.array_equal(small.synthesize(text, sid, key=key),
                                                   wavs[name, key])))
            if len(small._cache._programs) != 1:
                raise SystemExit("chip_smoke: a server of program_cache_size 1 kept "
                                 f"{len(small._cache._programs)} programs")
    if not all(alternating):
        raise SystemExit(f"chip_smoke: program_cache_size 1 changed the waveforms: {alternating}")
    out["program_cache_size_1"] = alternating
    out["cudnn_nondeterministic"] = loose_cudnn(server, buckets)
    return out


def loose_cudnn(server, buckets):
    """Graphed against eager with cuDNN free to pick non-deterministic
    algorithms (what `TTSServer` turns off with `use_deterministic`): a
    fresh server, the first key at each bucket, the synthesis's amplitude
    and the waveform. Reported, not a gate."""
    from semi_tts_tpu_torch.device import use_deterministic
    from semi_tts_tpu_torch.serve import TTSServer, serving_stages

    srv = TTSServer(server.cfg, server.audio, server.phn_attr.cpu(), server.model,
                    device=server.device, program_cache_size=2)
    key, out = SERVING_KEYS[0], {}
    try:
        torch.backends.cudnn.deterministic = False
        for name, (text, sid) in buckets.items():
            steps = srv.decode_steps_for(text)
            srv.synthesize(text, sid, key=key)  # the capture; the next request replays
            wav = srv.synthesize(text, sid, key=key)
            want = eager_request(srv, text, sid, key, steps)[0].cpu().numpy()
            t, s_ = srv._place(text, sid)
            amp = srv.stages(steps, *t.shape)[0](t, s_, seed=key).cpu().numpy()
            g = torch.Generator(device=srv.device).manual_seed(key)
            eager_amp = serving_stages(srv.cfg, srv.audio, srv.phn_attr, steps)[0](
                srv.model, t, s_, g).cpu().numpy()
            out[name] = {"amp_same": bool(np.array_equal(amp, eager_amp)),
                         "wav_same": bool(np.array_equal(wav, want)),
                         "wav_max_abs_err": float(np.abs(wav - want).max())}
    finally:
        use_deterministic()
    return out


def stage_times(server, text, sid, steps):
    """Wall seconds of the synthesis and vocoder graphs of one more request,
    each ended by a synchronise."""
    t, s = server._place(text, sid)
    synth, vocode = server.stages(steps, *t.shape)
    with server._run:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        amp = synth(t, s, seed=3)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vocode(amp)
        torch.cuda.synchronize()
    return {"synth": t1 - t0, "vocode": time.perf_counter() - t1}


def reference_check(ckpt, text=None, sid=None, steps=4):
    """A request (a small one, unless ``text`` and ``sid`` are given) of
    ``steps`` decode steps through the card's kernels and through the plain
    path on the CPU, on the same checkpoint, prenet dropout 0 and the same
    phases."""
    from semi_tts_tpu_torch.serve import TTSServer, serving_stages

    config = flagship_config(prenet_dropout=0.0)
    gpu = TTSServer.from_checkpoint(config, ckpt)
    cpu = TTSServer.from_checkpoint(config, ckpt, device="cpu")
    if text is None:
        text, sid = serving_inputs(2, 10, seed=3)
    out = {}
    amps = []
    stages = {srv: serving_stages(srv.cfg, srv.audio, srv.phn_attr, steps) for srv in (gpu, cpu)}
    for srv in (gpu, cpu):
        t, s = srv._place(text, sid)
        amps.append(stages[srv][0](srv.model, t, s).cpu())
    rel = float(((amps[0] - amps[1]).abs() / amps[1].abs().clamp_min(1e-3)).max())
    phases = (torch.rand(amps[1].shape, generator=torch.Generator().manual_seed(4)) * 2 - 1) * math.pi
    wavs = [stages[srv][1](a.to(srv.device), phases=phases.to(srv.device)).cpu()
            for srv, a in ((gpu, amps[1]), (cpu, amps[1]))]
    out["amp_max_rel_err"] = rel
    out["amp_tol_rel"] = 1e-3
    out["wav_max_abs_err"] = float((wavs[0] - wavs[1]).abs().max())
    out["wav_tol"] = 1e-3
    if not (rel <= out["amp_tol_rel"] and out["wav_max_abs_err"] <= out["wav_tol"]):
        raise SystemExit(f"chip_smoke: card and CPU reference disagree: {out}")
    return out


@torch.no_grad()
def featurizer_line(dev):
    """The port's clean `featurize` (K5 + two fp32 GEMMs) beside torch.stft
    (center, reflect) + abs + the mel GEMM on the same pre-emphasized waves,
    at equal row lengths (8 x 3.0 s, where the two reflect pads agree):
    device time of each, and the largest difference of the normalized mel."""
    from semi_tts_tpu_torch.ops.features import (REF_LEVEL_DB, AudioFeaturizer, amp_to_db,
                                                 normalize_db, preemphasis)

    audio = audio_config()
    feat = AudioFeaturizer(audio, dev)
    waves = torch.from_numpy(numpy_waves([TRAIN_S] * TRAIN_B, TRAIN_S, seed=7)).to(dev)
    lengths = torch.full((TRAIN_B,), TRAIN_S, dtype=torch.int32, device=dev)
    pre = preemphasis(waves, audio.preemphasis_coeff)
    window = torch.hann_window(audio.win_length, device=dev)

    def library():
        spec = torch.stft(pre, audio.n_fft, audio.hop_length, audio.win_length, window,
                          center=True, pad_mode="reflect", return_complex=True).abs()
        return spec.transpose(1, 2) @ feat.mel_fb_t

    mel = feat.featurize(waves, lengths)[0]
    want = normalize_db(amp_to_db(library()) - REF_LEVEL_DB)
    err = max_err(mel, want)
    if not err <= 1e-3:
        raise SystemExit(f"chip_smoke: featurize disagrees with torch.stft ({err})")
    return {"shapes": f"waves ({TRAIN_B},{TRAIN_S}) -> mel {tuple(mel.shape)}",
            "ms": device_ms(lambda: feat.featurize(waves, lengths), 20),
            "library_ms": device_ms(library, 20),
            "library": "torch.stft(center=True, pad_mode='reflect') + abs + mel matmul, "
                       "graph-timed", "max_abs_err_mel": err, "tol": 1e-3}


def training_batch(seed, dev, lengths=(TRAIN_S,) * TRAIN_B, U_=32):
    """(waves, wave_len, text, sid) on ``dev`` from a numpy seed: texts of
    24..32 tokens in 3..42, padded with 0; waves padded to 3.0 s or to the
    longest row."""
    rng = np.random.RandomState(seed)
    text = np.zeros((len(lengths), U_), np.int64)
    for b in range(len(lengths)):
        n = rng.randint(24, U_ + 1)
        text[b, :n] = rng.randint(3, 43, size=n)
    waves = numpy_waves(lengths, max(TRAIN_S, max(lengths)), seed)
    return (torch.from_numpy(waves).to(dev), torch.tensor(lengths, dtype=torch.int32, device=dev),
            torch.from_numpy(text).to(dev), torch.from_numpy(rng.randint(0, 109, len(lengths))).to(dev))


def _lstm_names(names, wide):
    """``names`` with the LSTM recurrences' wrappers replaced by the wide
    routes' (K1 with or without cell states -> K1w, K7 -> K7w) where
    ``wide``."""
    to = {"bilstm_rec": "lstm_rec_wide", "bilstm_rec_cs": "lstm_rec_wide",
          "bilstm_rec_bwd": "lstm_rec_bwd_wide"}
    return tuple(dict.fromkeys(to.get(n, n) if wide else n for n in names))


def phase_training(dev, rnn_dim=None):
    """AsrTrainer at flagship width: a warm-up step (then validate_asr), five
    timed steps, the launches of one step and of the validation, one
    profiled step, and one step on the card against the CPU plain path.
    ``rnn_dim`` overrides the encoder's ``model.encoder.rnn_dim``: at 512
    its BiLSTM takes the wide routes, K1w and K7w, once a layer each."""
    from semi_tts_tpu_torch import kernels
    from semi_tts_tpu_torch.kernels.rnn import lstm_route
    from semi_tts_tpu_torch.models import vqvae as V
    from semi_tts_tpu_torch.ops.features import AudioFeaturizer
    from semi_tts_tpu_torch.train.optim import Optimizer
    from semi_tts_tpu_torch.train.steps import StepBuilder
    from semi_tts_tpu_torch.train.train_asr import AsrTrainer, make_asr_step
    from semi_tts_tpu_torch.utils.metrics import read_phn_attr

    config = flagship_config()
    if rnn_dim is not None:
        config["model"]["encoder"]["rnn_dim"] = rnn_dim
    cfg = flagship_vqvae_config(config)
    wide = lstm_route(cfg.encoder.rnn_dim) == "wide"
    train_kernels, valid_kernels = (_lstm_names(TRAINING_KERNELS, wide),
                                    _lstm_names(VALIDATION_KERNELS, wide))
    phn_attr = torch.from_numpy(read_phn_attr(config["model"]["codebook"]["phn_attr_pth"])).to(dev)
    model = V.VQVAE(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    builder = StepBuilder(cfg, AudioFeaturizer(audio_config(), dev), phn_attr)
    opt = Optimizer(model.parameters(), lr=1e-3, lr_scheduler="decay")
    batch = training_batch(0, dev)
    dev_batch = training_batch(1, dev, lengths=RAGGED)
    marks, launches, logged, mem = [], {}, [], {}

    def batches():
        for i in range(1 + TRAIN_STEPS):
            if i == 1:  # after the warm-up step and its validation, outside the timed steps
                gc.collect()
                torch.cuda.reset_peak_memory_stats()
                mem["base"] = torch.cuda.memory_allocated()
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            yield batch

    trainer = AsrTrainer(model, builder, opt, pair_iter=batches(), dev_set=[dev_batch],
                         max_step=1 + TRAIN_STEPS, valid_step=10 ** 9, progress_step=1,
                         log=lambda *a: logged.append(a))
    capture_first(trainer)
    kernels.reset_launches()
    trainer.exec()
    launches["run"] = kernels.launch_counts()
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved()
    walls = [b - a for a, b in zip(marks[1:], marks[2:])]
    losses = [v for _, n, v in logged if n == "txt_loss/pair"]
    gnorms = [v for _, n, v in logged if n == "grad_norm"]
    per_first = [v for _, n, v in logged if n == "per/dev"]
    kernels.reset_launches()
    per = trainer.validate_asr()
    launches["validate"] = kernels.launch_counts()
    if len(losses) != 1 + TRAIN_STEPS or not np.isfinite(losses + gnorms + per_first + [per]).all():
        raise SystemExit(f"chip_smoke: training went non-finite: {losses} {gnorms} {per}")
    for path, names in (("run", train_kernels), ("validate", valid_kernels)):
        idle = [n for n in names if launches[path][n] == 0]
        if idle:
            raise SystemExit(f"chip_smoke: kernels not launched on the {path} path: {idle}")
    profile = profiled_step(lambda: trainer._train_step(batch), float(np.median(walls)),
                            picked=K6_KERNELS)
    seen = profile["kernels_seen"]
    require_seen(seen, train_kernels, "ASR train step")
    if wide and not (seen["lstm_rec_wide"] == seen["lstm_rec_bwd_wide"] == 2
                     and not any(seen[n] for n in NARROW_RECURRENCES)):
        raise SystemExit(f"chip_smoke: the ASR step at rnn_dim {rnn_dim} did not run K1w and "
                         f"K7w once a layer, and no narrow recurrence: {seen}")
    ref = training_reference(model, cfg, phn_attr, dev)
    graph = graph_check(model, opt, lambda o: make_asr_step(builder, o),
                        lambda fn, m, n: fn(m, n, *batch), 100)
    return dict(batch=TRAIN_B, samples=TRAIN_S, text_len=32, steps=1 + TRAIN_STEPS,
                params=sum(p.numel() for p in model.parameters()),
                asr_params=sum(p.numel() for p in model.asr.parameters()),
                wall_s=float(np.median(walls)), walls_s=walls, eager_wall_s=graph["eager_wall_s"],
                busy_s=profile["device_busy_s"], idle_share=profile["idle_share"],
                peak_mem_bytes=peak, reserved_bytes=reserved, mem_baseline_bytes=mem["base"],
                graphs=step_graphs(trainer._step_fn),
                losses=losses, grad_norms=gnorms, dev_per=per, dev_per_after_step1=per_first[0],
                launches=profile["kernels_seen"], wrapper_launches=launches["run"],
                launches_validate=launches["validate"], profile=profile, graph_check=graph,
                reference=ref)


K6_KERNELS = ("ctc_alpha", "ctc_beta")  # K6's kernels in a profile, by name

# Each wrapper's device kernel, by its demangled name in a profile: the
# evidence that a path's graph replays a kernel (a wrapper's Python counter
# moves when its kernel is captured, and a graph credits it on each replay).
KERNEL_NAMES = {"bilstm_rec": r"lstm_rec_kernel<[^>]*false>",
                "bilstm_rec_cs": r"lstm_rec_kernel<[^>]*true>",
                "bilstm_rec_bwd": r"lstm_bwd_kernel", "bigru_rec": r"gru_rec_kernel",
                "bigru_rec_bwd": r"gru_bwd_kernel",
                "attention_step": r"attention_step_kernel|attention_split_kernel",
                "attention_step_bwd": r"attention_bwd_kernel", "gl_project": r"gl_project_kernel",
                "gl_ola_frame": r"gl_ola_frame_kernel", "stft_frames": r"stft_frames_kernel",
                "spec_db": r"spec_db_kernel", "ctc_alpha": r"ctc_alpha_kernel",
                "ctc_beta_grad": r"ctc_beta_grad_kernel",
                # a call of either route: the row kernel, or the split route's scans
                "trim_merge": r"trim_merge_kernel|trim_merge_scan_kernel",
                "trim_merge_bwd": r"trim_merge_bwd_kernel",
                "lstm_rec_wide": r"rec_wide_kernel<4>|lstm_wide_fwd_cluster_kernel",
                "lstm_rec_bwd_wide": r"lstm_wide_bwd_kernel|lstm_wide_bwd_cluster_kernel",
                "gru_rec_wide": r"rec_wide_kernel<3>|gru_wide_fwd_cluster_kernel",
                "gru_rec_bwd_wide": r"gru_wide_bwd_kernel|gru_wide_bwd_cluster_kernel",
                # the long-length routes (phase 13)
                "attention_step_split": r"attention_split_kernel",
                "ctc_alpha_shared": r"ctc_alpha_kernel<", "ctc_beta_grad_shared": r"ctc_beta_grad_kernel<",
                "ctc_alpha_cluster": r"ctc_alpha_cluster_kernel",
                "ctc_beta_grad_cluster": r"ctc_beta_grad_cluster_kernel",
                "ctc_alpha_chain": r"ctc_alpha_chain_kernel",
                "ctc_beta_grad_chain": r"ctc_beta_grad_chain_kernel",
                # B6's split route (phase 13), each of its three kernels
                "trim_merge_tokens": r"trim_merge_tokens_kernel",
                "trim_merge_scan": r"trim_merge_scan_kernel",
                "trim_merge_means": r"trim_merge_means_kernel"}


def kernels_seen(by_name):
    """{wrapper: device kernels of its name} in a profile's ``by_name``."""
    return {w: sum(n for k, (n, _) in by_name.items() if re.search(pat, k))
            for w, pat in KERNEL_NAMES.items()}


UNSEEN = []  # kernels a profiled replay did not show, by path: fatal at the end of the run


def require_seen(seen, names, what):
    """Record every kernel of ``names`` that did not run in a profiled
    replay; `main` fails the run at its end if any did not, after every
    phase has run and printed what it saw."""
    idle = [n for n in names if not seen[n]]
    if idle:
        print(f"chip_smoke: kernels not seen in a profiled replay of the {what}: {idle}",
              flush=True)
        UNSEEN.append([what, idle])


PROFILE_LEAD = 256  # spin kernels launched in a profile before the profiled call


def _lead_in():
    """PROFILE_LEAD short spin kernels, synchronised: the device records a
    profile drops first (seen on the card: a replay's first kernels, and all
    of a short replay's, went missing after earlier profiles) are these,
    and `profiled_step` leaves them out by name."""
    for _ in range(PROFILE_LEAD):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


def profiled_step(run_step, wall, picked=()):
    """One more step (``run_step()``) under torch.profiler: device busy
    time, idle share against the unprofiled median step wall, the busiest
    kernel names, and the launches and device time of the kernels whose
    names hold one of ``picked``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _lead_in()
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    by_name, lead = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "spin_kernel" in e.name:
            lead += 1
        elif e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:16]
    return {"profiled_wall_s": profiled_wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
            "kernel_launches": sum(n for n, _ in by_name.values()),
            "lead_in_recorded": lead, "kernels_seen": kernels_seen(by_name),
            "top_device_ms": [[name[:70], n, us / 1e3] for name, (n, us) in top],
            "picked_ms": {p: [sum(n for k, (n, _) in by_name.items() if p in k),
                              sum(us for k, (_, us) in by_name.items() if p in k) / 1e3]
                          for p in picked}}


def memory_now():
    """What the allocator holds and what the whole card has in use (graphs'
    executables and library workspaces included), in bytes."""
    free, total = torch.cuda.mem_get_info()
    return {"allocated_bytes": torch.cuda.memory_allocated(),
            "reserved_bytes": torch.cuda.memory_reserved(), "device_used_bytes": total - free}


def capture_first(trainer):
    """A trainer's steps capture a shape's graph at its first call (the
    default is its second), so that the timed steps after the warm-up are
    replays; the CLI phase runs the default."""
    for step in [trainer._step_fn, *trainer._cycle_fns.values()]:
        step.capture_at = 1


GRAPH_STEPS = 3  # graphed and eager steps from one copied state (one would miss stale state)


def model_state(model, opt):
    """(name, tensor) of every parameter, BatchNorm statistic and optimizer
    state tensor."""
    names = ([n for n, _ in model.named_parameters()]
             + [f"buffer {n}" for n, _ in model.named_buffers()]
             + [f"optimizer {n}" for n in ("count", "schedule_count", *opt.moment_names,
                                          "notfinite_count", "total_notfinite", "last_finite")])
    return list(zip(names, list(model.parameters()) + list(model.buffers())
                    + opt.state_tensors()))


def _rel(a, b, scale):
    return float(torch.linalg.vector_norm((a - b).double())) / max(
        float(torch.linalg.vector_norm(scale.double())), 1e-30)


def graph_check(model, opt, make, call, step0):
    """A train step's CUDA graph against the same step run eagerly, from
    one copy of ``model``'s and ``opt``'s state: GRAPH_STEPS steps of each
    (step numbers ``step0``...; ``make(optimizer)`` gives the step program,
    whose first call captures its graph, ``call(fn, model, step_no)`` runs
    ``fn``, the program or its ``eager``). Every metric, parameter,
    BatchNorm statistic and optimizer moment and count must be equal bit for
    bit; where one is not, each differing leaf is named and held to the
    card-vs-CPU gates (a loss to 1e-4 of itself, a state leaf in L2 to 1e-3
    of its change over the steps; counts exactly). The last graphed step is
    rerun from a copy of its state and must repeat bit for bit. Returns the
    eager walls (median), an eager step's profile, the matrix-product FLOPs
    of one more eager step (``flops``, `utils.flops.matmul_flops`), the
    graph's capture time and host launches a call."""
    from semi_tts_tpu_torch.utils.flops import matmul_flops

    (mg, og), (me, oe) = copy.deepcopy((model, opt)), copy.deepcopy((model, opt))
    start = [t.detach().clone() for _, t in model_state(me, oe)]
    sg, se = make(og), make(oe)
    sg.capture_at = 1  # the first step runs eagerly and captures; the others replay
    mets_g, mets_e, eager_walls = [], [], []
    for i in range(GRAPH_STEPS):
        if i == GRAPH_STEPS - 1:
            before = [t.detach().clone() for _, t in model_state(mg, og)]
        mets_g.append(call(sg, mg, step0 + i))
    after = [t.detach().clone() for _, t in model_state(mg, og)]
    with torch.no_grad():
        for (_, t), b in zip(model_state(mg, og), before):
            t.copy_(b)
    again = call(sg, mg, step0 + GRAPH_STEPS - 1)
    rerun = all(torch.equal(t, a) for (_, t), a in zip(model_state(mg, og), after)) and all(
        torch.equal(again[k], mets_g[-1][k]) for k in again)
    for i in range(GRAPH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mets_e.append(call(se.eager, me, step0 + i))
        torch.cuda.synchronize()
        eager_walls.append(time.perf_counter() - t0)
    differing, held = [], True
    for i, (g, e) in enumerate(zip(mets_g, mets_e)):
        for k in g:
            if not torch.equal(g[k], e[k]):
                scalar = k.endswith("_loss") or k == "grad_norm"
                err = _rel(g[k].float(), e[k].float(), e[k].float()) if scalar else None
                differing.append([f"step {i} {k}", err])
                held = held and scalar and err <= 1e-4
    for (name, g), (_, e), s0 in zip(model_state(mg, og), model_state(me, oe), start):
        if not torch.equal(g, e):
            exact = not g.is_floating_point()
            err = None if exact else _rel(g, e, e - s0)
            differing.append([name, err])
            held = held and not exact and err <= 1e-3
    prog = sg.programs()[0]
    eager_wall = float(np.median(eager_walls))
    eager_prof = profiled_step(lambda: call(se.eager, me, step0 + GRAPH_STEPS), eager_wall)
    flops = matmul_flops(call, se.eager, me, step0 + GRAPH_STEPS + 1)
    out = dict(steps=GRAPH_STEPS, bit_for_bit=not differing, rerun_bit_for_bit=rerun,
               differing=differing[:20], held_to_gates=held, eager_wall_s=eager_wall,
               eager_walls_s=eager_walls, eager_busy_s=eager_prof["device_busy_s"],
               eager_idle_share=eager_prof["idle_share"],
               eager_device_events=eager_prof["kernel_launches"], flops=flops, **graph_stats(prog))
    del mg, og, me, oe, sg, se, prog
    gc.collect()
    if not rerun or not held:
        raise SystemExit(f"chip_smoke: a graphed step and its eager twin disagree: {out}")
    return out


def step_graphs(step):
    """Capture time and host launches of each graph a step program holds."""
    return [graph_stats(p) for p in step.programs()]


def tree_equal(a, b):
    """Equal pytrees of tensors, bit for bit (None where both are None)."""
    from torch.utils import _pytree as pytree

    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    return sa == sb and all((x is None and y is None) or torch.equal(x, y)
                            for x, y in zip(la, lb))


def shapes_of(args):
    return [list(t.shape) for t in args if isinstance(t, torch.Tensor)]


def timed_wall(fn, reps):
    """Median host wall of ``reps`` synchronised calls of ``fn``."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


PROGRAM_REPS = 5  # timed replays of a no-grad program (3 eager calls beside them)


def other_inputs(args):
    """Inputs of the same shapes and dtypes with other values: every tensor's
    rows in reverse order, floating tensors also scaled by 0.9."""
    def other(t):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.flip(0)
        return t * 0.9 if t.is_floating_point() else t
    return tuple(other(t) for t in args)


def program_check(prog, calls, what, kernels, seed=11):
    """A `graphs.NoGradProgram`'s CUDA graph against its eager twin: at each
    of ``calls`` (``(args, static)`` pairs, one batch shape each) the graph,
    captured at its first call, and ``prog.eager`` on the same inputs and
    seed give outputs equal bit for bit, on the captured inputs and then on
    others of the same shapes (`other_inputs`: a replay must read its new
    inputs), and a replay on the first inputs repeats its outputs; the
    capture's bytes (`GraphOwner.graph_bytes`: the allocator's pool and the
    card outside it) and time. At the first call's shape: the replay's and
    the eager call's walls, a profiled replay (busy, idle, device events;
    ``kernels`` must run in it, by name), a profiled eager call and the
    eager call's matrix-product FLOPs (``flops``, `utils.flops.matmul_flops`)."""
    from semi_tts_tpu_torch.utils.flops import matmul_flops

    prog.capture_at = 1
    owner = prog.owner(next(t.device for t in calls[0][0] if isinstance(t, torch.Tensor)))
    rows = []
    for args, static in calls:
        n = len(owner.graph_bytes)
        got = prog(*args, seed=seed, **static)
        want = prog.eager(*args, seed=seed, **static)
        args_b = other_inputs(args)
        got_b = prog(*args_b, seed=seed + 1, **static)
        want_b = prog.eager(*args_b, seed=seed + 1, **static)
        again = prog(*args, seed=seed, **static)
        same = tree_equal(got, want) and tree_equal(got_b, want_b)
        repeat = tree_equal(got, again)
        rows.append(dict(shapes=shapes_of(args), static={k: v for k, v in static.items()
                                                         if isinstance(v, (int, float))},
                         bit_for_bit=same, rerun_bit_for_bit=repeat,
                         other_inputs_differ=not tree_equal(got, got_b),
                         graph_bytes=owner.graph_bytes[n] if len(owner.graph_bytes) > n else None,
                         **graph_stats(prog.programs()[-1])))
        if not (same and repeat):
            raise SystemExit(f"chip_smoke: the {what} program's graph and its eager twin "
                             f"disagree: {rows}")
    args, static = calls[0]
    graphed = lambda: prog(*args, seed=seed, **static)
    eager = lambda: prog.eager(*args, seed=seed, **static)
    wall, eager_wall = timed_wall(graphed, PROGRAM_REPS), timed_wall(eager, 3)
    replay, eager_prof = profiled_step(graphed, wall), profiled_step(eager, eager_wall)
    require_seen(replay["kernels_seen"], kernels, f"{what} program")
    return dict(calls=rows, wall_s=wall, eager_wall_s=eager_wall, flops=matmul_flops(eager),
                busy_s=replay["device_busy_s"], idle_share=replay["idle_share"],
                device_events=replay["kernel_launches"],
                eager_busy_s=eager_prof["device_busy_s"], eager_idle_share=eager_prof["idle_share"],
                eager_device_events=eager_prof["kernel_launches"],
                launches=replay["kernels_seen"], top_device_ms=replay["top_device_ms"])


def _reference_batch(device):
    """`training_reference`'s default batch: B=2 rows of 3.0 s and 2.5 s."""
    return training_batch(3, device, lengths=(TRAIN_S, TRAIN_S - 11025))


def training_reference(model, cfg, phn_attr, dev, batch=_reference_batch, seed=11,
                       what="ASR training steps"):
    """One step's loss and gradients through the card's kernels and through
    the plain path on the CPU: the same weights and BN statistics, dropout
    0, the rows ``batch(device)`` gives (two), and the same SNRs, stretch
    rate and noise (numpy draws from ``seed``) given to both; each side's
    wall (``card_s``, ``cpu_s``)."""
    from semi_tts_tpu_torch.ops.features import AudioFeaturizer
    from semi_tts_tpu_torch.train.steps import StepBuilder
    from semi_tts_tpu_torch.train.train_asr import asr_loss_and_grads

    cfg0 = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, dropout=0.0))
    cpu_model = copy.deepcopy(model).cpu()
    rng = np.random.RandomState(seed)
    snrs = rng.uniform(10, 100, size=2).astype(np.float32)
    noise = rng.randn(2, batch(torch.device("cpu"))[0].shape[1]).astype(np.float32)
    rate = float(np.float32(rng.uniform(0.9, 1.1)))

    def run(m, device):
        builder = StepBuilder(cfg0, AudioFeaturizer(audio_config(), device), phn_attr.to(device))
        waves, wave_len, text, _ = batch(device)
        aug = (torch.from_numpy(snrs).to(device), rate, torch.from_numpy(noise).to(device))
        t0 = time.perf_counter()
        loss, _, grads = asr_loss_and_grads(builder, m, waves, wave_len, text, None, augment=aug)
        loss = float(loss)
        return loss, [None if g is None else g.cpu() for g in grads], time.perf_counter() - t0

    (loss_g, grads_g, s_g), (loss_c, grads_c, s_c) = run(model, dev), run(cpu_model,
                                                                          torch.device("cpu"))
    spread, _ = card_spread(model, lambda m: run(m, dev)[1], grads_g)
    return checked({"loss_card": loss_g, "loss_cpu": loss_c,
                    "loss_rel_err": abs(loss_g - loss_c) / abs(loss_c), "loss_tol_rel": 1e-4,
                    **compare_grads(model, grads_g, grads_c), "card_spread": spread,
                    "card_s": s_g, "cpu_s": s_c}, what)


# Conv biases in front of a train-mode BatchNorm: BN's mean subtraction
# makes their exact gradient 0, so what both sides hold is rounding noise.
ZERO_GRAD_LEAVES = re.compile(r"^(asr|tts\.encoder)\.convs\.\d+\.b$")


def leaf_errors(names, grads_a, grads_b):
    """{leaf: (L2 error / L2 norm, largest error / largest value)} of
    ``grads_a`` against ``grads_b``, the zero-gradient leaves left out."""
    if [g is None for g in grads_a] != [g is None for g in grads_b]:
        raise SystemExit("chip_smoke: two runs reach different parameters")
    return {n: (float(torch.linalg.vector_norm(a - b)) / max(float(torch.linalg.vector_norm(b)), 1e-30),
                float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
            for n, a, b in zip(names, grads_a, grads_b)
            if a is not None and not ZERO_GRAD_LEAVES.match(n)}


def worst_leaves(rel):
    """The worst leaf of `leaf_errors` by each measure."""
    l2, mx = max(rel, key=lambda n: rel[n][0]), max(rel, key=lambda n: rel[n][1])
    return {"worst_leaf_l2": l2, "worst_leaf_l2_rel_err": rel[l2][0],
            "worst_leaf_max": mx, "worst_leaf_max_rel_err": rel[mx][1]}


# Leaves of the paired step whose gradient passes a ReLU or a max-pool on its
# way back from the loss: the CBHG before its GRU, the TTS encoder's convs,
# the text embedding (the codebook) in front of them, the decoder's prenet,
# and the speaker embedding and AdaIN std layer (a ReLU). Where the card and
# the CPU round an input to opposite sides of such a kink, one position's
# term of the gradient jumps: these leaves are not a smooth function of the
# weights, and the card's own gradient moves as far on weights an ulp off
# (``card_spread``).
KINKED_LEAVES = re.compile(r"^(tts\.postnet\.cbhg\.(banks|projs|pre_highway|highways)\."
                           r"|tts\.encoder\.(convs|bn)\.|tts\.decoder\.(prenet|pseudo_std)\."
                           r"|codebook\.|spkr_embed$)")


# A kinked leaf is held by itself, in L2, to max(tol, KINK_K x the card's own
# ulp spread of that leaf): card and CPU differ in rounding by more than an
# ulp of the weights, so they may cross a few more kinks than one ulp move
# does. Measured on the card (PERF.md), a kinked leaf's card-vs-CPU error
# came to at most 1.0x its own largest ulp spread (2.113e-3 against
# 2.113e-3, the same leaf).
KINK_K = 3.0


def compare_grads(model, grads_g, grads_c, tol=1e-3, kinked=None, spread=None):
    """The card's gradients against the CPU's: the largest error of all
    within ``tol`` x the largest gradient of all, and each leaf but the
    zero-gradient ones within ``tol`` x that leaf's size in the L2 norm; a
    ``kinked`` leaf within max(``tol``, KINK_K x ``spread[leaf]``), its own
    L2 ulp spread on the card (`card_spread`). Reports the worst leaf of
    all, by L2 and by largest element, the worst smooth leaf, and the
    kinked leaf nearest its bound."""
    names = [n for n, _ in model.named_parameters()]
    leaves = [(a, b) for a, b in zip(grads_g, grads_c) if a is not None]
    gmax = max(float(b.abs().max()) for _, b in leaves)
    gerr = max(float((a - b).abs().max()) for a, b in leaves)
    rel = leaf_errors(names, grads_g, grads_c)
    kinks = {n for n in rel if kinked is not None and kinked.match(n)}
    bound = {n: max(tol, KINK_K * spread[n]) if n in kinks else tol for n in rel}
    held = {n: v for n, v in rel.items() if n not in kinks}
    worst = max(held, key=lambda n: held[n][0])
    out = {"grad_max_abs_err": gerr, "grad_max_abs": gmax, "grad_tol": tol * gmax,
           **{"grad_" + k: v for k, v in worst_leaves(rel).items()},
           "grad_held_worst_leaf": worst, "grad_held_worst_l2_rel_err": held[worst][0],
           "grad_leaf_tol_rel_l2": tol, "grad_leaves_held": len(held),
           "grad_leaves_checked": len(rel)}
    if kinks:
        k = max(kinks, key=lambda n: rel[n][0] / bound[n])
        out.update(kink_k=KINK_K, kinked_leaves=len(kinks), kinked_nearest_leaf=k,
                   kinked_nearest_l2_rel_err=rel[k][0], kinked_nearest_bound=bound[k],
                   kinked_worst_leaf=max(kinks, key=lambda n: rel[n][0]))
    out["grads_ok"] = gerr <= tol * gmax and all(rel[n][0] <= bound[n] for n in rel)
    return out


SPREAD_DRAWS = 4


def card_spread(model, grads_fn, grads_g, kinked=None, draws=SPREAD_DRAWS, seed=0, at=()):
    """How far the card's own gradients move, leaf by leaf, in a second run
    on the same inputs (``rerun``, which must repeat bit for bit:
    ``rerun_identical``) and in ``draws`` runs on weights moved by one ulp
    each, up or down at random (``ulp``: kinks that the rounding crosses,
    which any two fp32 implementations meet; draw ``s`` from the generator
    seeded ``1000 * seed + s``). The worst leaf by each measure of
    `compare_grads`, and in L2 the worst of the leaves not ``kinked``.
    Returns (report, {leaf: largest L2 ulp spread}); with ``at`` (draw
    counts), the report's ``by_draws`` holds that dict after each."""
    names = [n for n, _ in model.named_parameters()]
    again = grads_fn(model)
    out = {"rerun": worst_leaves(leaf_errors(names, again, grads_g)),
           "rerun_identical": all(a is None and b is None or torch.equal(a, b)
                                  for a, b in zip(again, grads_g))}
    worst, out["by_draws"] = {}, {}
    for s in range(draws):
        moved = copy.deepcopy(model)
        gen = torch.Generator().manual_seed(1000 * seed + s)
        with torch.no_grad():
            for p in moved.parameters():
                up = (torch.rand(p.shape, generator=gen) < 0.5).to(p.device)
                p.copy_(torch.where(up, torch.nextafter(p, torch.full_like(p, math.inf)),
                                    torch.nextafter(p, torch.full_like(p, -math.inf))))
        for n, (l2, mx) in leaf_errors(names, grads_fn(moved), grads_g).items():
            a, b = worst.get(n, (0.0, 0.0))
            worst[n] = (max(a, l2), max(b, mx))
        if s + 1 in at:
            out["by_draws"][s + 1] = {n: v[0] for n, v in worst.items()}
        del moved
    held = [n for n in worst if kinked is None or not kinked.match(n)]
    held_worst = max(held, key=lambda n: worst[n][0])
    out["ulp"] = {**worst_leaves(worst), "held_worst_leaf": held_worst,
                  "held_worst_l2_rel_err": worst[held_worst][0], "draws": draws}
    return out, {n: v[0] for n, v in worst.items()}


def checked(res, what):
    """Raise unless ``res`` (a card-vs-CPU check) passed: loss, gradients,
    and a card rerun that repeats bit for bit."""
    if not (res["loss_rel_err"] <= res["loss_tol_rel"] and res["grads_ok"]
            and res["card_spread"]["rerun_identical"]):
        raise SystemExit(f"chip_smoke: card and CPU {what} disagree: {res}")
    return res


FLAGSHIP_FREQ_LOSS = dict(sample_rate=FLAGSHIP_AUDIO["sample_rate"], n_mels=80, loss="mse",
                          differential_loss=True, emphasize_linear_low=True)


def phase_paired(dev):
    """VqvaeTrainer at flagship width with the unpaired weights 0 (every step
    is the paired step): a warm-up step (then `validate`), five timed steps,
    `validate` again, the kernel launches of one step and of a validation,
    one profiled step, and one step on the card against the CPU plain path."""
    from semi_tts_tpu_torch import kernels
    from semi_tts_tpu_torch.models import vqvae as V
    from semi_tts_tpu_torch.ops.features import AudioFeaturizer
    from semi_tts_tpu_torch.train.optim import Optimizer
    from semi_tts_tpu_torch.train.steps import StepBuilder
    from semi_tts_tpu_torch.train.train_vqvae import VqvaeTrainer
    from semi_tts_tpu_torch.utils.metrics import read_phn_attr

    config = flagship_config()
    cfg = flagship_vqvae_config(config)
    phn_attr = torch.from_numpy(read_phn_attr(config["model"]["codebook"]["phn_attr_pth"])).to(dev)
    model = V.VQVAE(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    builder = StepBuilder(cfg, AudioFeaturizer(audio_config(), dev), phn_attr,
                          freq_loss_kwargs=FLAGSHIP_FREQ_LOSS)
    opt = Optimizer(model.parameters(), lr=1e-3, lr_scheduler="decay")
    batch = training_batch(0, dev)
    dev_batch = training_batch(1, dev, lengths=RAGGED)
    marks, launches, logged, mem = [], {}, [], {}

    def batches():
        for i in range(1 + TRAIN_STEPS):
            if i == 1:  # after the warm-up step and its validation, outside the timed steps
                gc.collect()
                torch.cuda.reset_peak_memory_stats()
                mem["base"] = torch.cuda.memory_allocated()
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            yield batch

    trainer = VqvaeTrainer(model, builder, opt, pair_iter=batches(), dev_set=[dev_batch],
                           max_step=1 + TRAIN_STEPS, valid_step=10 ** 9, progress_step=1,
                           log=lambda *a: logged.append(a))
    capture_first(trainer)
    kernels.reset_launches()
    trainer.exec()
    launches["run"] = kernels.launch_counts()
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved()
    walls = [b - a for a, b in zip(marks[1:], marks[2:])]
    per_step = {k: [v for _, n, v in logged if n == name]
                for k, name in (("asr_loss", "txt_loss/pair"), ("mel_loss", "speech_loss/mel"),
                                ("linear_loss", "speech_loss/linear"), ("grad_norm", "grad_norm"))}
    kernels.reset_launches()
    dev_tts, dev_per = trainer.validate()
    launches["validate"] = kernels.launch_counts()
    values = sum(per_step.values(), []) + [dev_tts, dev_per]
    if any(len(v) != 1 + TRAIN_STEPS for v in per_step.values()) or not np.isfinite(values).all():
        raise SystemExit(f"chip_smoke: paired training went non-finite: {per_step} {dev_tts} {dev_per}")
    for path, names in (("run", PAIRED_STEP_KERNELS), ("validate", VALIDATION_KERNELS)):
        idle = [n for n in names if launches[path][n] == 0]
        if idle:
            raise SystemExit(f"chip_smoke: kernels not launched on the paired {path} path: {idle}")
    profile = profiled_step(lambda: trainer._train_step(batch), float(np.median(walls)))
    require_seen(profile["kernels_seen"], PAIRED_STEP_KERNELS, "paired train step")
    ref = paired_reference(model, cfg, phn_attr, dev)
    graph = graph_check(model, opt, builder.make_paired_step,
                        lambda fn, m, n: fn(m, n, 1.0, *batch), 100)
    return dict(batch=TRAIN_B, samples=TRAIN_S, text_len=32, decode_steps=PAIRED_T // 3,
                steps=1 + TRAIN_STEPS, params=sum(p.numel() for p in model.parameters()),
                wall_s=float(np.median(walls)), walls_s=walls, eager_wall_s=graph["eager_wall_s"],
                busy_s=profile["device_busy_s"], idle_share=profile["idle_share"],
                peak_mem_bytes=peak, reserved_bytes=reserved, mem_baseline_bytes=mem["base"],
                graphs=step_graphs(trainer._step_fn), **per_step, dev_tts_loss=dev_tts,
                dev_per=dev_per, best_tts_loss=trainer.best_tts_loss, best_per=trainer.best_per,
                launches=profile["kernels_seen"], wrapper_launches=launches["run"],
                launches_validate=launches["validate"], profile=profile, graph_check=graph,
                reference=ref)


def no_dropout(cfg):
    """``cfg`` with every dropout 0: the ASR's, the TTS encoder's, the
    prenet's and the decoder cells'."""
    d = cfg.tts.decoder
    dec0 = dataclasses.replace(d, prenet_dropout=0.0, query_dropout=0.0, dec_dropout=0.0)
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, dropout=0.0),
                               tts=dataclasses.replace(cfg.tts, enc_dropout=0.0, decoder=dec0))


def paired_reference(model, cfg, phn_attr, dev):
    """One paired step's loss and gradients through the card's kernels and
    through the plain path on the CPU: the same weights and BN statistics,
    every dropout 0 (the prenet's included), tf_rate 1, B=2 rows of 3.0 s and
    2.5 s, and the same SNRs, stretch rate and noise (numpy draws) given to
    both."""
    from semi_tts_tpu_torch.ops.features import AudioFeaturizer
    from semi_tts_tpu_torch.train.steps import StepBuilder

    cfg0 = no_dropout(cfg)
    cpu_model = copy.deepcopy(model).cpu()
    rng = np.random.RandomState(12)
    lengths = (TRAIN_S, TRAIN_S - 11025)
    snrs = rng.uniform(10, 100, size=2).astype(np.float32)
    noise = rng.randn(2, TRAIN_S).astype(np.float32)
    rate = float(np.float32(rng.uniform(0.9, 1.1)))

    def run(m, device):
        builder = StepBuilder(cfg0, AudioFeaturizer(audio_config(), device), phn_attr.to(device),
                              freq_loss_kwargs=FLAGSHIP_FREQ_LOSS)
        waves, wave_len, text, sid = training_batch(4, device, lengths=lengths)
        aug = (torch.from_numpy(snrs).to(device), rate, torch.from_numpy(noise).to(device))
        t0 = time.perf_counter()
        loss, mets, grads = builder.paired_loss_and_grads(m, waves, wave_len, text, sid, 1.0, None,
                                                          augment=aug)
        return (float(loss), [None if g is None else g.cpu() for g in grads],
                {k: float(mets[k]) for k in ("asr_loss", "mel_loss", "linear_loss")},
                time.perf_counter() - t0)

    (loss_g, grads_g, mets_g, s_g), (loss_c, grads_c, mets_c, s_c) = (
        run(model, dev), run(cpu_model, torch.device("cpu")))
    spread, by_leaf = card_spread(model, lambda m: run(m, dev)[1], grads_g, KINKED_LEAVES)
    return checked({"loss_card": loss_g, "loss_cpu": loss_c,
                    "loss_rel_err": abs(loss_g - loss_c) / abs(loss_c), "loss_tol_rel": 1e-4,
                    "losses_card": mets_g, "losses_cpu": mets_c,
                    **compare_grads(model, grads_g, grads_c, kinked=KINKED_LEAVES, spread=by_leaf),
                    "card_s": s_g, "cpu_s": s_c, "card_spread": spread}, "paired steps")


# the flagship YAML's unpaired speech weight; no shipped YAML sets the text weight
CYCLE_WEIGHTS = dict(unpair_speech=10.0, unpair_text=1.0)
CYCLE_STEPS = 9   # 0 paired, 1 text-first, 2 speech-first (warm-ups); 3-8 timed, three of each
LONG_S = 336924   # 15.28 s, the longest utterance of data/partition_tables/*.csv
PAIRED, SPEECH_FIRST, TEXT_FIRST = "paired", "speech_first", "text_first"
CYCLE_KERNELS = ("trim_merge", "trim_merge_bwd")
# K1 with cell states, K7, K2, K8, K3, K9, K5, K6 and, in the speech-first step, B6
STEP_KERNELS = {SPEECH_FIRST: PAIRED_STEP_KERNELS + CYCLE_KERNELS, TEXT_FIRST: PAIRED_STEP_KERNELS}
OWN_KERNELS = ("trim_merge_kernel", "trim_merge_tokens_kernel", "trim_merge_scan_kernel",
               "trim_merge_means_kernel", "trim_merge_bwd_kernel", "attention_bwd",
               "stft_frames_kernel")


def phase_cycles(dev):
    """VqvaeTrainer at flagship width with the flagship's unpaired speech
    weight (10) and an unpaired text weight of 1, both cycles from step 0:
    step 0 paired, then text-first on odd and speech-first on even steps,
    over B=8 x 3.0 s x U=32 paired and unpaired batches; steps 0-2 warm up,
    3-8 are timed (median wall of each kind). Peak memory, the losses and
    counters of every step, the kernel launches of one step of each kind
    (each kernel of its path must launch; K6 twice in the text-first step),
    one profiled step of each kind (with B6's and K9's own device time; the
    same step number is profiled again and the next step of its kind once
    more, ``launches_by_step``, to show how far the profiler's count of
    device events moves between profiles), one step of each kind on the
    card against the CPU plain path, and a speech-first step whose unpaired
    row is 15.28 s long (K3 and K9 at L ~ 680)."""
    from semi_tts_tpu_torch import kernels
    from semi_tts_tpu_torch.train.train_vqvae import VqvaeTrainer

    model, builder, opt = cycle_setup(dev)
    cfg, phn_attr = builder.cfg, builder.phn_attr
    batch, u_batch = training_batch(0, dev), training_batch(2, dev)
    marks, kinds, launches, logged, mem = [], [], {}, [], {}

    def batches():
        for i in range(CYCLE_STEPS):
            if i == 3:  # after the warm-up steps, outside the timed ones
                gc.collect()
                torch.cuda.reset_peak_memory_stats()
                mem["base"] = torch.cuda.memory_allocated()
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            kinds.append(trainer.step_kind())
            yield batch

    trainer = VqvaeTrainer(model, builder, opt, pair_iter=batches(),
                           unpair_iter=iter([u_batch] * CYCLE_STEPS),
                           dev_set=[training_batch(1, dev, lengths=RAGGED)], max_step=CYCLE_STEPS,
                           valid_step=10 ** 9, progress_step=1, log=lambda *a: logged.append(a))
    capture_first(trainer)
    kernels.reset_launches()
    trainer.exec()
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    run_launches = kernels.launch_counts()
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved()
    want = ["paired"] + [TEXT_FIRST if i % 2 else SPEECH_FIRST for i in range(1, CYCLE_STEPS)]
    if kinds != want:
        raise SystemExit(f"chip_smoke: the trainer ran {kinds}, not {want}")
    walls = [b - a for a, b in zip(marks, marks[1:])]
    timed = {k: [walls[i] for i in range(3, CYCLE_STEPS) if kinds[i] == k]
             for k in (SPEECH_FIRST, TEXT_FIRST)}
    per_step = {}
    for step, name, value in logged:
        per_step.setdefault(name, []).append(value)
    if not np.isfinite([v for vs in per_step.values() for v in vs]).all():
        raise SystemExit(f"chip_smoke: the cycles went non-finite: {per_step}")
    if len(per_step["txt_loss/unpair"]) != 4 or len(per_step["speech_loss/unpair"]) != 4:
        raise SystemExit(f"chip_smoke: the cycles' losses were not logged: {per_step}")
    idle = [n for n in CYCLE_KERNELS + PAIRED_STEP_KERNELS if run_launches[n] == 0]
    if idle:
        raise SystemExit(f"chip_smoke: kernels not launched in the cycles' run: {idle}")
    wall = {k: float(np.median(v)) for k, v in timed.items()}
    profile = {}
    for kind, steps in ((SPEECH_FIRST, (10, 10, 12)), (TEXT_FIRST, (11, 11, 13))):
        runs = []
        for step in steps:
            trainer.step = step
            runs.append(profiled_step(lambda: trainer._train_step(batch, u_batch), wall[kind],
                                      picked=OWN_KERNELS))
        profile[kind] = dict(runs[0], launches_by_step=[[s, r["kernel_launches"]]
                                                        for s, r in zip(steps, runs)])
        require_seen(profile[kind]["kernels_seen"], STEP_KERNELS[kind], f"{kind} step")
        launches[kind] = profile[kind]["kernels_seen"]
    if min(launches[TEXT_FIRST]["ctc_alpha"], launches[TEXT_FIRST]["ctc_beta_grad"]) < 2:
        raise SystemExit(f"chip_smoke: the text-first step's replay ran K6 once: "
                         f"{launches[TEXT_FIRST]}")
    ref = cycles_reference(model, cfg, phn_attr, dev)
    graph = {kind: graph_check(model, opt, make,
                               lambda fn, m, n: fn(m, n, 1.0, *batch, *u_batch), 100)
             for kind, make in ((SPEECH_FIRST, builder.make_speech_first_step),
                                (TEXT_FIRST, builder.make_text_first_step))}
    graphs = {kind: step_graphs(trainer._cycle_fns[kind]) for kind in (SPEECH_FIRST, TEXT_FIRST)}
    long = long_memory_step(trainer, dev)
    shapes = corpus_shapes(trainer, dev)
    return dict(batch=TRAIN_B, unpaired_batch=TRAIN_B, samples=TRAIN_S, text_len=32,
                steps=CYCLE_STEPS, kinds=kinds, weights=CYCLE_WEIGHTS, wall_s=wall,
                walls_s=walls, eager_wall_s={k: v["eager_wall_s"] for k, v in graph.items()},
                busy_s={k: v["device_busy_s"] for k, v in profile.items()},
                idle_share={k: v["idle_share"] for k, v in profile.items()},
                peak_mem_bytes=peak, reserved_bytes=reserved, mem_baseline_bytes=mem["base"],
                graphs=graphs, per_step=per_step, token_usage=trainer.token_usage.tolist(),
                launches=launches, wrapper_launches=run_launches, profile=profile,
                graph_check=graph, reference=ref, long_memory=long, corpus_shapes=shapes)


def cycles_reference(model, cfg, phn_attr, dev):
    """One speech-first and one text-first step's loss and gradients through
    the card's kernels and through the plain path on the CPU: the same
    weights and BN statistics, every dropout 0, tf_rate 1, B = 2 + 2 rows
    (3.0 s and 2.5 s paired, 2.8 s and 3.0 s unpaired), the same SNRs,
    stretch rates and noise for both batches; the CPU's speech-first step
    segments by the card's unpaired argmax tokens (``tokens=``), and the
    frames where its own argmax differs are counted (``flipped_frames``).
    Each beside the card's own rerun (which must repeat bit for bit) and ulp
    spread, which also sets the kinked leaves' bounds."""
    from semi_tts_tpu_torch.ops.features import AudioFeaturizer
    from semi_tts_tpu_torch.train.steps import StepBuilder, Weights

    cfg0 = no_dropout(cfg)
    cpu_model = copy.deepcopy(model).cpu()
    rng = np.random.RandomState(13)
    lengths = {"pair": (TRAIN_S, TRAIN_S - 11025), "unpair": (TRAIN_S - 4410, TRAIN_S)}
    draws = {k: (rng.uniform(10, 100, size=2).astype(np.float32),
                 float(np.float32(rng.uniform(0.9, 1.1))),
                 rng.randn(2, TRAIN_S).astype(np.float32)) for k in lengths}

    def run(m, device, kind, tokens=None):
        builder = StepBuilder(cfg0, AudioFeaturizer(audio_config(), device), phn_attr.to(device),
                              weights=Weights(**CYCLE_WEIGHTS), freq_loss_kwargs=FLAGSHIP_FREQ_LOSS)
        pair = training_batch(5, device, lengths=lengths["pair"])
        unpair = training_batch(6, device, lengths=lengths["unpair"])
        aug, u_aug = ((torch.from_numpy(d[0]).to(device), d[1], torch.from_numpy(d[2]).to(device))
                      for d in (draws["pair"], draws["unpair"]))
        t0 = time.perf_counter()
        if kind == SPEECH_FIRST:
            loss, mets, grads = builder.speech_first_loss_and_grads(
                m, 2, 1.0, pair, unpair, None, augment=aug, u_augment=u_aug,
                tokens=None if tokens is None else tokens.to(device))
        else:
            loss, mets, grads = builder.text_first_loss_and_grads(m, 1.0, pair, unpair, None,
                                                                  augment=aug)
        return (float(loss), [None if g is None else g.cpu() for g in grads],
                {k: v.cpu() for k, v in mets.items() if v.numel() <= 4096},
                time.perf_counter() - t0)

    out = {}
    for kind in (SPEECH_FIRST, TEXT_FIRST):
        loss_g, grads_g, mets_g, s_g = run(model, dev, kind)
        tokens = mets_g.get("unpair_pred")
        loss_c, grads_c, mets_c, s_c = run(cpu_model, torch.device("cpu"), kind, tokens)
        spread, by_leaf = card_spread(model, lambda m: run(m, dev, kind, tokens)[1], grads_g,
                                      KINKED_LEAVES)
        losses = [k for k in mets_g if k.endswith("_loss")]
        res = {"loss_card": loss_g, "loss_cpu": loss_c,
               "loss_rel_err": abs(loss_g - loss_c) / abs(loss_c), "loss_tol_rel": 1e-4,
               "losses_card": {k: float(mets_g[k]) for k in losses},
               "losses_cpu": {k: float(mets_c[k]) for k in losses},
               **compare_grads(model, grads_g, grads_c, kinked=KINKED_LEAVES, spread=by_leaf),
               "card_s": s_g, "cpu_s": s_c, "card_spread": spread}
        if kind == SPEECH_FIRST:
            res.update(flipped_frames=int((mets_c["unpair_pred"] != tokens).sum()),
                       unpair_ok=[bool(mets_g["unpair_ok"]), bool(mets_c["unpair_ok"])])
        else:
            res["ctc_nan"] = [bool(mets_g["ctc_nan"]), bool(mets_c["ctc_nan"])]
        out[kind] = checked(res, f"{kind} steps")
    return out


def long_memory_step(trainer, dev):
    """One speech-first train step through its CUDA graph with B = 1 + 1
    rows: a 3.0 s paired utterance and a 15.28 s unpaired one, whose
    trimmed latents (padded to the ASR encoder's length) are the attention
    memory: K3 and K9 at L ~ 680 (K9 in spans of 12 positions), 409 decode
    steps. The first call captures the graph (``first_s``, ``capture_s``);
    a second replays it under the profiler (``wall_s``, its kernels by
    name: K3, K9 and B6 must run). Its losses, gradient norm and the
    parameters after must be finite."""
    from semi_tts_tpu_torch import kernels
    from semi_tts_tpu_torch.kernels.attention import attention_bwd_plan

    step = trainer._cycle_fns[SPEECH_FIRST]
    pair = training_batch(7, dev, lengths=(TRAIN_S,))
    unpair = training_batch(8, dev, lengths=(LONG_S,))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    step(trainer.model, 2, 1.0, *pair, *unpair)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = kernels.launch_counts()  # the capture's
    res = {}
    prof = profiled_step(lambda: res.update(step(trainer.model, 4, 1.0, *pair, *unpair)), first)
    mets = res
    d = trainer.builder.cfg.tts.decoder
    L = mets["unpair_pred"].shape[1]
    losses = {k: float(v) for k, v in mets.items() if k.endswith("_loss")}
    finite = np.isfinite(list(losses.values()) + [float(mets["grad_norm"])]).all() and all(
        bool(torch.isfinite(p).all()) for p in trainer.model.parameters())
    plan = attention_bwd_plan(2, L, d.attn_dim, d.enc_embed_dim, 2, d.n_location_filters,
                              d.location_kernel_size)
    prog = step.programs()[-1]  # the most recently used: this step's graph
    out = dict(samples=[TRAIN_S, LONG_S], memory_len=L,
               k9_span=plan["span"], decode_steps=mets["pair_align"].shape[1], losses=losses,
               grad_norm=float(mets["grad_norm"]), unpair_ok=bool(mets["unpair_ok"]),
               unpair_len=int(mets["unpair_pred_len"][0]), first_s=first,
               wall_s=prof["profiled_wall_s"], busy_s=prof["device_busy_s"],
               device_events=prof["kernel_launches"], **graph_stats(prog),
               kernels_seen={k: prof["kernels_seen"][k] for k in LONG_KERNELS},
               wrapper_launches={k: launches[k] for k in LONG_KERNELS})
    if not finite:
        raise SystemExit(f"chip_smoke: the long-memory speech-first step failed: {out}")
    require_seen(prof["kernels_seen"], LONG_KERNELS, "15.28 s speech-first step")
    return out


LONG_KERNELS = ("attention_step", "attention_step_bwd", "trim_merge", "trim_merge_bwd")
CORPUS_TABLE = "data/partition_tables/semi-multi-spkr-sd0.csv"  # the flagship's
CORPUS_SHAPES = 8  # its most frequent speech-first shapes, captured, their bytes a graph read
BUDGET_GRAPHS = 2  # the budget of the demonstration: the next shape must run eagerly


def corpus_shapes(trainer, dev):
    """The speech-first step at the CORPUS_SHAPES shapes that the flagship's
    partition table gives most often (`data/step_shapes.py` over 20,000
    steps: (wave, text) of the paired and the unpaired batch), through a
    fresh step program of the default policy on a `GraphOwner` of its own:
    each shape's first call (eager), second (capture and replay) and third
    (replay), timed, with what each capture cost the card (``graph_bytes``:
    the allocator's pool and the card outside it) and the memory after it
    (the first row: before any). The budget: once BUDGET_GRAPHS shapes are
    captured, the owner's budget is set to what they cost, and the next
    shape's second call must run eagerly (``over_budget_calls``), equal bit
    for bit (metrics and state) to its eager twin from a copy of the state,
    with nothing evicted; then the budget is lifted and its third call
    captures. The losses must be finite."""
    from collections import Counter

    from semi_tts_tpu_torch.data.step_shapes import step_keys
    from semi_tts_tpu_torch.graphs import GraphOwner

    keys = step_keys(os.path.join(HERE, CORPUS_TABLE), 20_000)
    count = Counter(k for kind, k in keys if kind == SPEECH_FIRST)
    owner = GraphOwner(dev)
    default_budget = owner.budget_bytes
    builder, model = trainer.builder, trainer.model
    step = builder.make_speech_first_step(trainer.optimizer, seed=1)
    step.owner = lambda device: owner
    rows, budget = [memory_now()], None

    def timed(call, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mets = step(model, 2 + 2 * call, 1.0, *args)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(v)) for k, v in mets.items() if k.endswith("_loss")):
            raise SystemExit(f"chip_smoke: a corpus-shape step went non-finite: {mets}")
        return mets, time.perf_counter() - t0

    for n, (((pw, pt), (uw, ut)), times_seen) in enumerate(count.most_common(CORPUS_SHAPES)):
        args = (*training_batch(30 + n, dev, lengths=(pw,) * TRAIN_B, U_=pt),
                *training_batch(40 + n, dev, lengths=(uw,) * TRAIN_B, U_=ut))
        walls = [timed(0, *args)[1]]
        if n == BUDGET_GRAPHS:
            owner.budget_bytes = owner.spent()
            before, graphs = list(step.programs()), len(owner.graph_bytes)
            twin_model, twin_opt = copy.deepcopy((model, trainer.optimizer))
            twin = builder.make_speech_first_step(twin_opt, seed=1)
            got, wall = timed(1, *args)
            want = twin.eager(twin_model, 4, 1.0, *args)
            equal = tree_equal(got, want) and all(
                torch.equal(a, b) for (_, a), (_, b) in zip(model_state(model, trainer.optimizer),
                                                            model_state(twin_model, twin_opt)))
            budget = dict(budget_bytes=owner.budget_bytes, over_budget_calls=owner.over_budget_calls,
                          eager_wall_s=wall, bit_for_bit=equal,
                          evicted=[p for p in before if p not in step.programs()],
                          captured=len(owner.graph_bytes) - graphs)
            del twin_model, twin_opt, twin, want
            if not (equal and owner.over_budget_calls == 1 and not budget["evicted"]
                    and not budget["captured"] and len(step.programs()) == BUDGET_GRAPHS):
                raise SystemExit(f"chip_smoke: past the budget, the shape {n} did not run "
                                 f"eagerly as its twin: {budget}")
            owner.budget_bytes = default_budget
        walls += [timed(call, *args)[1] for call in (1, 2)]
        rows.append(dict(memory_now(), shape=[[pw, pt], [uw, ut]],
                         share_of_steps=times_seen / sum(count.values()), eager_s=walls[0],
                         capture_call_s=walls[1], capture_s=graph_stats(step.programs()[-1])["capture_s"],
                         replay_s=walls[2], graph_bytes=owner.graph_bytes[-1],
                         graphs=len(step.programs())))
    per_graph = [r["graph_bytes"] for r in rows[1:]]
    return dict(shapes=rows, budget=budget, default_budget_bytes=default_budget,
                graph_bytes_total=owner.spent(),
                pool_bytes_median=float(np.median([b["pool"] for b in per_graph])),
                outside_bytes_median=float(np.median([b["outside"] for b in per_graph])))


# phase 8, the CLI's solvers: a corpus of CLI_SPLITS utterances of 2-4 s
CLI_SPLITS = (("paired", 16), ("unpaired", 16), ("dev", 8), ("test", 8))
CLI_STEPS, CLI_VALID = 4, 2
CLI_STEADY = 40                 # steps the same run goes on for, without validation
CLI_STEADY_TIMED = 12           # the last of them: the steady state
CLI_SPEAKERS = ("p225", "p226", "p227", "p228", "p229", "p230", "p231", "p232")
CLI_GEN_KERNELS = SERVING_KERNELS + ("stft_frames", "spec_db")
CLI_TRAIN_KERNELS = PAIRED_STEP_KERNELS + CYCLE_KERNELS


def write_cli_corpus(root, seed=0):
    """A synthetic VCTK-layout corpus under ``root`` from a numpy generator:
    harmonic waves with noise of 2-4 s at 22,050 Hz written with the port's
    `wavio`, a partition table, and a map table of 20-32 phonemes each from
    the repo's vocabulary; returns the YAML ``data.corpus`` block."""
    from semi_tts_tpu_torch.data import wavio

    rng = np.random.RandomState(seed)
    sr = FLAGSHIP_AUDIO["sample_rate"]
    with open(os.path.join(HERE, "data/cmu_phn.vocab")) as f:
        vocab = [line.strip() for line in f if line.strip()]
    rows, phones = [",speaker,split,duration"], ["\tphn_seq\tspkr"]
    n = 0
    for split, count in CLI_SPLITS:
        for _ in range(count):
            spk = CLI_SPEAKERS[n % len(CLI_SPEAKERS)]
            fid = f"{spk}_{n:03d}"
            n += 1
            dur = rng.uniform(2.0, 4.0)
            t = np.arange(int(dur * sr)) / sr
            f0 = rng.uniform(90, 250)
            wav = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
            wav = 0.2 * wav / np.abs(wav).max() + 0.01 * rng.randn(len(t))
            os.makedirs(os.path.join(root, "wavs", spk), exist_ok=True)
            wavio.write(os.path.join(root, "wavs", spk, fid + ".wav"), wav, sr)
            rows.append(f"{fid},{spk},{split},{dur:.2f}")
            phones.append(f"{fid}\t{' '.join(rng.choice(vocab, rng.randint(20, 33)))}\t{spk}")
    for name, lines in (("partition.csv", rows), ("map_table.csv", phones)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    return {"name": "vctk", "path": os.path.join(root, "wavs"), "bucketing": False,
            "batch_size": TRAIN_B, "spkr_map": os.path.join(HERE, "corpus_meta/spkr/lj_vctk.json"),
            "partition_table": os.path.join(root, "partition.csv"),
            "map_table": os.path.join(root, "map_table.csv"),
            "vocab_file": os.path.join(HERE, "data/cmu_phn.vocab")}


def cli_config(root):
    """config/semi-multi-spkr-paired-data.yaml at its widths over the
    synthetic corpus: its hparas but CLI_STEPS steps validated every
    CLI_VALID, an unpaired text weight of 1 beside its speech weight of 10
    (so that all three step kinds run) and a fixed learning rate of 1e-3
    (the Noam warm-up's first steps would move the dev losses by noise
    alone, and the checkpoint policy writes on an improvement)."""
    config = flagship_config()
    config["data"]["corpus"] = write_cli_corpus(root)
    config["hparas"] = {"valid_step": CLI_VALID, "max_step": CLI_STEPS, "asr_weight": 1.0,
                        "tts_weight": 1.0, "unpair_text_start_step": 0, "unpair_text_weight": 1.0,
                        "unpair_speech_start_step": 0, "unpair_speech_weight": 10.0,
                        "optimizer": "Adam", "lr": 0.001, "lr_scheduler": "fixed",
                        "freq_loss_type": "mse", "differential_loss": True,
                        "emphasize_linear_low": True, "tf_start": 1.0, "tf_end": 1.0,
                        "tf_step": 50000}
    return config


def cli_paras(root, **kw):
    """The CLI's flags as `semi_tts_tpu_torch.__main__` gives them to a solver."""
    import argparse

    from semi_tts_tpu_torch.__main__ import parser

    paras = parser().parse_args(["--config", os.path.join(root, "cli.yaml"), "--name", "cli",
                                 "--logdir", os.path.join(root, "log"),
                                 "--ckpdir", os.path.join(root, "ckpt"), "--no-msg"])
    paras.gpu, paras.pin_memory, paras.verbose = True, False, False
    return argparse.Namespace(**{**vars(paras), **kw})


LISTEN = 6  # train_vqvae.LISTEN_N_EXAMPLES: the rows whose figures and audio are logged
# the tags the JAX trainer logs at step 1 (progress) and at every validation, and
# only at step 1's validation (the ground truth)
STEP1_TAGS = {f"pair_align{i}" for i in range(LISTEN)} | {"per"}
VALID_TAGS = ({f"{k}{i}" for k in ("hyp_text", "mel_spec", "linear_spec", "dv_align",
                                   "mel_wave", "linear_wave") for i in range(LISTEN)}
              | {"codebook", "speech_loss", "per"})
GT_TAGS = ({f"truth_text{i}" for i in range(LISTEN)}
           | {f"{k}{i}_gt" for k in ("mel_spec", "linear_spec", "mel_wave", "linear_wave")
              for i in range(LISTEN)})
PROFILE_STEPS = 8  # profile_window(0, 8): steps 4..7, replays of one batch's graph


class RecordingWriter:
    """Stands in for tensorboardX's SummaryWriter on the card: keeps each
    call's (method, tag, step, shape of what was logged), and the first
    wave logged under each tag."""

    def __init__(self):
        self.calls, self.waves = [], {}

    def _keep(self, method, tag, step, value):
        shape = list(np.shape(value)) if not isinstance(value, (str, dict)) else len(value)
        self.calls.append((method, tag, step, shape))

    def add_image(self, tag, img, global_step=None, dataformats="CHW"):
        if not np.isfinite(img).all() or dataformats != "HWC":
            raise SystemExit(f"chip_smoke: image {tag} is not a finite HWC array")
        self._keep("add_image", tag, global_step, img)

    def add_embedding(self, mat, metadata=None, tag="default", global_step=None, **kw):
        if len(metadata) != len(mat) or not np.isfinite(mat).all():
            raise SystemExit(f"chip_smoke: embedding {tag}: {np.shape(mat)}, {len(metadata)} labels")
        self._keep("add_embedding", tag, global_step, mat)

    def add_audio(self, tag, snd, global_step=None, sample_rate=44100):
        self.waves.setdefault(tag, np.asarray(snd).reshape(-1))
        self._keep("add_audio", tag, global_step, snd)

    def add_text(self, tag, text, global_step=None):
        self._keep("add_text", tag, global_step, text)

    def add_scalars(self, tag, values, global_step=None):
        self._keep("add_scalars", tag, global_step, values)

    def close(self):
        pass

    def tags(self, step):
        return {tag for _, tag, st, _ in self.calls if st == step}


@contextlib.contextmanager
def media_stand_ins(figure_inputs):
    """What the card's machine may lack for the trainer's media logs:
    without ``soundfile`` (which tensorboardX's audio needs) an empty module
    stands in, so that `write_log` hands the audio to the recording writer;
    without matplotlib the figures are drawn as blank images. Either way
    every array handed to `feat_to_fig` (and every count vector handed to
    `data_to_bar`) is recorded into ``figure_inputs`` and must be finite."""
    from semi_tts_tpu_torch.utils import viz

    saved = sys.modules.get("soundfile")
    try:
        import soundfile  # noqa: F401
    except ImportError:
        sys.modules["soundfile"] = types.ModuleType("soundfile")
    try:
        import matplotlib  # noqa: F401
        drawn = True
    except ImportError:
        drawn = False
        print("cli: matplotlib is not installed: the figures' inputs are checked, blank "
              "images are logged", flush=True)
    feat_to_fig, data_to_bar = viz.feat_to_fig, viz.data_to_bar

    def fig(feat):
        a = np.asarray(feat)
        figure_inputs.append(["feat_to_fig", list(a.shape), bool(np.isfinite(a).all())])
        return feat_to_fig(feat) if drawn else (np.zeros((1000, 1600, 3)), "HWC")

    def bar(counts, gt_counts, tok_size, tick, **kw):
        figure_inputs.append(["data_to_bar", int(np.sum(counts)), int(np.sum(gt_counts))])
        if drawn or int(np.sum(gt_counts)) == 0:
            return data_to_bar(counts, gt_counts, tok_size, tick, **kw)
        return np.zeros((1000, 1600, 3)), "HWC"

    viz.feat_to_fig, viz.data_to_bar = fig, bar
    try:
        yield drawn
    finally:
        viz.feat_to_fig, viz.data_to_bar = feat_to_fig, data_to_bar
        if saved is None:
            sys.modules.pop("soundfile", None)


def check_media(writer, validations, figure_inputs, steps):
    """Raise unless step 1 and every validation logged the JAX trainer's
    tags and K4 launched in each validation whose Griffin-Lim program held
    no graph before it (one that did replays K4); returns the missing tags
    (none)."""
    missing = {}
    for st in steps:
        want = VALID_TAGS | ((STEP1_TAGS | GT_TAGS) if st == 1 else set())
        lost = sorted(want - writer.tags(st))
        if lost:
            missing[st] = lost
    if missing:
        raise SystemExit(f"chip_smoke: the CLI's run did not log {missing}")
    idle = [v for v in validations if not (v["gl_project"] and v["gl_ola_frame"])
            and v["graphs_before"][1] < 1]
    if idle or not validations:
        raise SystemExit(f"chip_smoke: K4 did not launch in a validation: {validations}")
    bad = [f for f in figure_inputs if f[0] == "feat_to_fig" and not f[2]]
    if bad:
        raise SystemExit(f"chip_smoke: non-finite figure inputs: {bad[:4]}")


def dev_audio_check(rec):
    """The first dev wave batch the trainer vocoded on the card against the
    plain Griffin-Lim on the CPU, same amplitudes and phases (those the
    program drew from its generator reseeded with the call's seed): the
    largest difference over the largest sample (the serving gate: 1e-3)."""
    from semi_tts_tpu_torch.ops.griffin_lim import random_phases, specgram_to_waveform

    amp = rec["amp"]
    phases = random_phases(amp.shape, torch.Generator(device=amp.device).manual_seed(rec["seed"]),
                           amp.device)
    want = specgram_to_waveform(amp.cpu(), phases=phases.cpu(), **rec["kw"])
    got = rec["out"].cpu()
    err = float((got - want).abs().max() / want.abs().max())
    if not err <= 1e-3:
        raise SystemExit(f"chip_smoke: dev audio differs from the plain Griffin-Lim: {err}")
    return {"rows": int(got.shape[0]), "samples": int(got.shape[1]), "rel_err": err}


def profile_run(root, config):
    """``--profile`` through `VqvaeSolver`: PROFILE_STEPS paired steps on one
    batch (step 0 eager, 1 captures, the rest replay; the window is
    `profile_window`'s), no writer. The trace in the run's log directory
    must name K3 and K9 among its device kernels; the step walls inside the
    window against the replays before it."""
    from semi_tts_tpu_torch.train.train_vqvae import VqvaeSolver
    from semi_tts_tpu_torch.utils.timer import profile_window

    config = copy.deepcopy(config)
    config["hparas"].update(max_step=PROFILE_STEPS, valid_step=10 ** 9,
                            unpair_speech_weight=0.0, unpair_text_weight=0.0)
    solver = VqvaeSolver(config, cli_paras(root, name="cli_profile", profile=True), "train")
    solver.log = None
    solver.load_data()
    solver.set_model()
    trainer, walls = solver.trainer, []
    trainer.pair_iter = itertools.repeat(next(trainer.pair_iter))
    run_step = trainer._train_step

    def step(batch, unpaired=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mets = run_step(batch, unpaired)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return mets

    trainer._train_step = step
    t0 = time.perf_counter()
    solver.exec()
    exec_wall = time.perf_counter() - t0
    traces = glob.glob(os.path.join(solver.logdir, "*.pt.trace.json"))
    if len(traces) != 1:
        raise SystemExit(f"chip_smoke: --profile wrote {traces} into {solver.logdir}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            n, us = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n + 1, us + float(e.get("dur", 0.0)))
    seen = kernels_seen(by_name)
    require_seen(seen, ("attention_step", "attention_step_bwd"), "--profile trace")
    first, end = profile_window(0, PROFILE_STEPS)
    replays, profiled = walls[2:first], walls[first:end]
    graphs = trainer._step_fn.programs()
    if len(graphs) != 1:
        raise SystemExit(f"chip_smoke: the --profile run made {len(graphs)} graphs, not 1")
    return dict(steps=PROFILE_STEPS, window=[first, end], trace_bytes=os.path.getsize(traces[0]),
                device_kernels=sum(n for n, _ in by_name.values()),
                kernels_seen={k: seen[k] for k in ("attention_step", "attention_step_bwd")},
                step_walls_s=walls, replay_wall_s=float(np.median(replays)),
                profiled_wall_s=float(np.median(profiled)),
                overhead_s=float(np.median(profiled) - np.median(replays)),
                exec_wall_s=exec_wall, trace_export_s=exec_wall - sum(walls))


def native_decode_check(root, capacity):
    """The native decoder over the synthetic corpus's files in batches of
    TRAIN_B, bit for bit against `wavio`, and each batch's decode time
    beside `wavio`'s (host only)."""
    from semi_tts_tpu_torch import native
    from semi_tts_tpu_torch.data import wavio

    paths = sorted(glob.glob(os.path.join(root, "wavs", "*", "*.wav")))
    nat, py = [], []
    native.wav_read_batch(paths[:1], capacity)  # builds and loads the library
    for i in range(0, len(paths), TRAIN_B):
        batch = paths[i:i + TRAIN_B]
        t0 = time.perf_counter()
        arr, lens, srs = native.wav_read_batch(batch, capacity, channel=0, n_threads=4)
        nat.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ref = [wavio.read(p) for p in batch]
        py.append(time.perf_counter() - t0)
        for j, (w, sr) in enumerate(ref):
            if not (lens[j] == w.shape[1] and srs[j] == sr
                    and np.array_equal(arr[j, :lens[j]], w[0])):
                raise SystemExit(f"chip_smoke: the native decoder differs from wavio on {batch[j]}")
    return dict(files=len(paths), batch=TRAIN_B, capacity=capacity,
                native_ms_per_batch=1e3 * float(np.median(nat)),
                wavio_ms_per_batch=1e3 * float(np.median(py)), bit_for_bit=True)


def state_of(solver):
    """Copies of a solver's parameters, buffers and optimizer state."""
    opt = solver.optimizer
    return ([t.detach().clone() for t in list(solver.model.parameters())
             + list(solver.model.buffers())]
            + [t.clone() for t in (opt.mu, opt.nu, opt.count, opt.schedule_count,
                                   opt.notfinite_count, opt.total_notfinite, opt.last_finite)])


def phase_cli(bare_walls, keep, keep_specs):
    """The CLI's solvers at flagship width on a synthetic corpus, through
    `load_data -> set_model -> exec`: `VqvaeSolver` trains CLI_STEPS steps
    (paired, text-first, speech-first, text-first) validating every
    CLI_VALID, with the loader's batches (finite losses; the checkpoints
    are the ones the policy names for the logged dev metrics, at least one
    tts_* or asr_*); a second solver resumes from the checkpoint of step 2
    (its parameters, BN statistics, optimizer state and step equal the
    first's at that step, bit for bit) and repeats the step that followed,
    on the same batches, bit for bit (loss and parameters); then
    `SpecgramGenerator` with --gen-wav on the test split (every file, finite,
    of the expected shape). The kernel launches of the training and of the
    generation; the solver's step wall (the loader's next batch and the
    step) beside the bare steps' of phases 6 and 7; the generation's wall
    per utterance; peak memory. Copies the checkpoint it resumed from to
    ``keep`` and the generated spectrograms into ``keep_specs``.

    The training solver logs to a `RecordingWriter` (with `media_stand_ins`),
    so the JAX trainer's figures, dev audio and projector run on the card
    whatever is installed: step 1 and every validation must log their tags
    (`check_media`), K4 must launch in each validation that does not replay
    graphs, and the first dev wave batch must match the plain Griffin-Lim on
    the CPU (`dev_audio_check`). The eval step and the dev audio are programs
    of the trainer's `GraphOwner`: the first validation runs them eagerly,
    the second captures the eval step, the third (step CLI_STEPS) must run
    no kernel wrapper (all replays). After the steady steps, one validation
    with and one without the writer are timed (no checkpoint written), one
    is profiled (the eval and Griffin-Lim kernels by name), the eval step
    at two dev batch shapes and the featurizer are held to their eager
    twins (`program_check`), then ``--profile`` (`profile_run`) and the
    native decoder (`native_decode_check`). `SpecgramGenerator` runs three
    passes over the test split: the first eager, the second captures, the
    third replays (no wrapper launches) and is profiled; every file of the
    later passes equals the first's byte for byte."""
    import tempfile

    from semi_tts_tpu_torch import kernels
    from semi_tts_tpu_torch.ops.features import featurize_program
    from semi_tts_tpu_torch.data import wavio
    from semi_tts_tpu_torch.models import vqvae as V
    from semi_tts_tpu_torch.train.gen_specgram import SpecgramGenerator
    from semi_tts_tpu_torch.train.train_vqvae import VqvaeSolver

    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    figure_inputs, wave_rec = [], []
    with tempfile.TemporaryDirectory() as root, media_stand_ins(figure_inputs) as drawn:
        config = cli_config(root)
        solver = VqvaeSolver(config, cli_paras(root), "train")
        writer = solver.log = RecordingWriter()
        solver.load_data()
        solver.set_model()
        trainer, walls, logged, saved, at, kinds = solver.trainer, [], [], [], {}, {}
        run_step, pairs, save, log = trainer._train_step, trainer.pair_iter, trainer.save, trainer.log
        run_validate, log_waves, vocoder = trainer.validate, trainer._log_waves, trainer._vocoder
        validations, audio = [], {"s": 0.0, "launches": {}}

        def validate():
            before = kernels.launch_counts()
            graphs_before = (len(trainer._eval_step.programs()), len(vocoder.programs()))
            audio.update(s=0.0, launches=dict.fromkeys(before, 0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_validate()
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            validations.append(dict(step=trainer.step, media=trainer.media,
                                    wall_s=time.perf_counter() - t0, dev_audio_s=audio["s"],
                                    gl_project=after["gl_project"] - before["gl_project"],
                                    gl_ola_frame=after["gl_ola_frame"] - before["gl_ola_frame"],
                                    launched=sum(after.values()) - sum(before.values()),
                                    launches={k: after[k] - before[k] for k in after
                                              if after[k] != before[k]},
                                    graphs_before=graphs_before,
                                    graphs_after=(len(trainer._eval_step.programs()),
                                                  len(vocoder.programs())),
                                    audio_launches=dict(audio["launches"])))
            return out

        def timed_log_waves(*a, **k):
            before = kernels.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            log_waves(*a, **k)
            torch.cuda.synchronize()
            audio["s"] += time.perf_counter() - t0
            for n, v in kernels.launch_counts().items():
                audio["launches"][n] += v - before[n]

        def recorded_vocoder(amp, seed=None, **kw):
            out = vocoder(amp, seed=seed, **kw)
            if not wave_rec:
                wave_rec.append(dict(amp=amp.clone(), seed=seed, kw=kw, out=out.clone(),
                                     step=trainer.step))
            return out

        trainer.validate, trainer._log_waves = validate, timed_log_waves
        trainer._vocoder = recorded_vocoder

        def timed_batches():
            while True:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                batch = next(pairs)
                walls.append([time.perf_counter() - t0])
                yield batch

        def programs():
            return sum(len(f.programs()) for f in [trainer._step_fn, *trainer._cycle_fns.values()])

        def train_step(batch, unpaired=None):
            kinds[trainer.step_kind()] = (trainer.step, batch, unpaired)
            if trainer.step == 2:
                at.update(args=(batch, unpaired), state=state_of(solver))
                if not any(n.endswith("_2.pth") for n in os.listdir(solver.ckpdir)):
                    solver.save("resume_2.pth", float("nan"))
            n, t0 = programs(), time.perf_counter()
            mets = run_step(batch, unpaired)
            torch.cuda.synchronize()
            walls[-1] += [time.perf_counter() - t0, trainer.step_kind(), programs() > n]
            if trainer.step == 2:
                at.update(loss=mets["total_loss"].clone(), after=state_of(solver))
            return mets

        trainer.pair_iter, trainer._train_step = timed_batches(), train_step
        trainer.save = lambda name, score: (saved.append(name), save(name, score))
        trainer.log = lambda step, name, value: (logged.append((step, name, value)),
                                                 log(step, name, value))
        kernels.reset_launches()
        solver.exec()
        wrapper_launches = {"train": kernels.launch_counts()}  # eager first calls and captures
        check_media(writer, validations, figure_inputs,
                    sorted({v["step"] for v in validations}))
        dev_audio = dict(dev_audio_check(wave_rec[0]), step=wave_rec[0]["step"])
        logged_wave = writer.waves["mel_wave0"]
        if not np.array_equal(logged_wave, wave_rec[0]["out"][0].cpu().numpy()):
            raise SystemExit("chip_smoke: the logged dev wave is not the vocoded one")
        values = [v for _, _, v in logged if isinstance(v, (int, float))]
        if trainer.step != CLI_STEPS or not np.isfinite(values).all():
            raise SystemExit(f"chip_smoke: the CLI's training failed: step {trainer.step}, {logged}")
        dev_metrics = {(st, n): v for st, n, v in logged if n in ("speech_loss/dev", "per/dev")}
        want, best_tts, best_per = [], 100.0, 2.0
        for st in sorted({st for st, _ in dev_metrics}):
            if dev_metrics[st, "speech_loss/dev"] < best_tts:
                best_tts = dev_metrics[st, "speech_loss/dev"]
                want += [f"tts_{st}.pth"] if st > 1 else []
            if dev_metrics[st, "per/dev"] < best_per:
                best_per = dev_metrics[st, "per/dev"]
                want += [f"asr_{st}.pth"] if st > 1 else []
        written = sorted(n for n in os.listdir(solver.ckpdir) if n != "resume_2.pth")
        if saved != want or written != sorted(want) or not want:
            raise SystemExit(f"chip_smoke: the CLI wrote {written} (saved {saved}), the policy "
                             f"names {want}")
        ckpt = next(os.path.join(solver.ckpdir, n) for n in sorted(os.listdir(solver.ckpdir))
                    if n.endswith("_2.pth"))
        shutil.copy(ckpt, keep)

        resumed = VqvaeSolver(config, cli_paras(root, name="cli_resumed", load=ckpt), "train")
        resumed.load_data()
        resumed.set_model()
        capture_first(resumed.trainer)  # the repeat runs a graph, step 2 ran eagerly (first call)
        loaded_same = resumed.trainer.step == 2 and all(
            torch.equal(a, b) for a, b in zip(state_of(resumed), at["state"]))
        mets = resumed.trainer._train_step(*at["args"])
        repeated = torch.equal(mets["total_loss"], at["loss"]) and all(
            torch.equal(a, b) for a, b in zip(state_of(resumed), at["after"]))
        if not (loaded_same and repeated):
            raise SystemExit(f"chip_smoke: the resume from {os.path.basename(ckpt)} is not bit for "
                             f"bit: loaded {loaded_same}, next step {repeated}")
        # the same run goes on to steady state: CLI_STEADY more steps, no validation
        trainer.max_step, trainer.valid_step = CLI_STEPS + CLI_STEADY, 10 ** 9
        trainer.exec()
        steady = [w[0] + w[1] for w in walls[-CLI_STEADY_TIMED:]]
        mem = dict(memory_now(), graphs=programs())
        trainer.save = lambda name, score: None  # the timed validations write no checkpoint
        for media in (True, False, True, False):
            trainer.media = media
            trainer.validate()
        trainer.media = True
        timed_valid = {k: float(np.median([v["wall_s"] for v in validations[-4:]
                                           if v["media"] == m]))
                       for k, m in (("writer_s", True), ("no_writer_s", False))}
        timed_valid["dev_audio_s"] = float(np.median([v["dev_audio_s"] for v in validations[-4:]
                                                      if v["media"]]))
        replayed = [v for v in validations if v["step"] == CLI_STEPS][0]  # the third validation
        if replayed["launched"] or min(replayed["graphs_before"]) < 1:
            raise SystemExit(f"chip_smoke: the CLI's validation at step {CLI_STEPS} did not "
                             f"replay the eval and Griffin-Lim graphs: {replayed}")
        valid_profile = profiled_step(trainer.validate, timed_valid["writer_s"])
        require_seen(valid_profile["kernels_seen"], VALIDATION_KERNELS + ("gl_project", "gl_ola_frame"),
                     "CLI's validation")
        builder = solver.builder
        dev_batch = next(iter(trainer.dev_set))
        half = tuple(t[:TRAIN_B // 2] for t in dev_batch)
        programs_checked = {
            "eval": program_check(builder.make_eval_step(),
                                  [((trainer.model, *dev_batch), {}), ((trainer.model, *half), {})],
                                  "eval step", VALIDATION_KERNELS),
            "featurize": program_check(featurize_program(builder.feat, builder.graph_owner),
                                       [(dev_batch[:2], {}), (half[:2], {})], "featurize",
                                       ("stft_frames", "spec_db"))}
        owner = builder.graph_owner(solver.device)
        trainer_graphs = dict(graph_bytes=owner.graph_bytes, spent_bytes=owner.spent(),
                              budget_bytes=owner.budget_bytes,
                              over_budget_calls=owner.over_budget_calls,
                              eval=step_graphs(trainer._eval_step),
                              dev_audio=step_graphs(vocoder))
        replays = {}  # one replay of each step kind's graph, profiled
        for kind, (st, batch, unpaired) in sorted(kinds.items()):
            trainer.step = st
            run_step(batch, unpaired)  # a shape seen once captures here, not under the profiler
            replays[kind] = profiled_step(lambda: run_step(batch, unpaired), float(np.median(steady)))
        seen = {n: sum(r["kernels_seen"][n] for r in replays.values()) for n in KERNEL_NAMES}
        require_seen(seen, CLI_TRAIN_KERNELS, "CLI's train steps")
        graphs = {k: step_graphs(f) for k, f in [("paired", trainer._step_fn),
                                                 *trainer._cycle_fns.items()]}
        for s in (solver, resumed):
            if s.log is not None:
                s.log.close()
        capacity = solver.pair_set.bucket_samples[-1]
        del resumed, solver, trainer, run_step, at
        gc.collect()
        profile = profile_run(root, config)
        gc.collect()
        decoder = native_decode_check(root, capacity)

        gen = SpecgramGenerator(config, cli_paras(root, load=ckpt, gen_specgram=True,
                                                  gen_wav=True), "test")
        gen.load_data()
        gen.set_model()
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen.exec()
        torch.cuda.synchronize()
        gen_wall = time.perf_counter() - t0
        wrapper_launches["gen_specgram"] = kernels.launch_counts()  # eager: each a run
        out_dir = gen.logdir + "_0k"
        gen_passes = []
        for k in (2, 3):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen.gen_specgram("test", f"{out_dir}_pass{k}")
            torch.cuda.synchronize()
            gen_passes.append(dict(wall_s=time.perf_counter() - t0,
                                   launched=sum(kernels.launch_counts().values())))
        gen_profile = profiled_step(lambda: gen.gen_specgram("test", f"{out_dir}_pass4"),
                                    gen_passes[-1]["wall_s"])
        require_seen(gen_profile["kernels_seen"], CLI_GEN_KERNELS, "gen_specgram pass")
        differ = [f for k in (2, 3, 4) for f in sorted(os.listdir(out_dir))
                  if not filecmp.cmp(os.path.join(out_dir, f),
                                     os.path.join(f"{out_dir}_pass{k}", f), shallow=False)]
        gen_graphs = dict(eval=step_graphs(gen._eval_step), vocoder=step_graphs(gen._vocoder),
                          graph_bytes=gen.builder.graph_owner(gen.device).graph_bytes)
        if differ or gen_passes[-1]["launched"] or not (gen_graphs["eval"] and gen_graphs["vocoder"]):
            raise SystemExit(f"chip_smoke: gen_specgram's graphed passes: files differing "
                             f"{differ[:4]}, {gen_passes}, graphs {gen_graphs}")
        r, audio = gen.model_cfg.n_frames_per_step, gen.featurizer.cfg
        texts = {fid: sum(1 for v in gen.tokenizer.file_to_seq(fid) if v != 0)
                 for fid in (f.split("-")[0] for f in os.listdir(out_dir))}
        for fid, n_tok in texts.items():
            mel, spec, align = (np.load(os.path.join(out_dir, f"{fid}-{k}.npy"))
                                for k in ("mel", "spec", "align"))
            wav, sr = wavio.read(os.path.join(out_dir, f"{fid}-pred.wav"))
            dec = int(n_tok * V.FRAME_PHN_RATIO) // r
            ok = (mel.shape[1] == audio.num_mels and spec.shape == (mel.shape[0], audio.num_freq)
                  and mel.shape[0] % r == 0 and align.shape == (min(dec, mel.shape[0] // r), n_tok)
                  and wav.shape == (1, audio.hop_length * (mel.shape[0] - 1))
                  and sr == audio.sample_rate
                  and all(np.isfinite(a).all() for a in (mel, spec, align, wav)))
            if not ok:
                raise SystemExit(f"chip_smoke: gen_specgram wrote bad files for {fid}: mel "
                                 f"{mel.shape}, spec {spec.shape}, align {align.shape}, wav {wav.shape}")
        if len(texts) != dict(CLI_SPLITS)["test"]:
            raise SystemExit(f"chip_smoke: gen_specgram wrote {len(texts)} utterances")
        os.makedirs(keep_specs, exist_ok=True)
        for f in glob.glob(os.path.join(out_dir, "*-spec.npy")):
            shutil.copy(f, keep_specs)
    for path, names in (("train", CLI_TRAIN_KERNELS + VALIDATION_KERNELS),
                        ("gen_specgram", CLI_GEN_KERNELS)):
        idle = [n for n in names if wrapper_launches[path][n] == 0]
        if idle:
            raise SystemExit(f"chip_smoke: kernels not launched on the CLI's {path} path: {idle}")
    steps = [w[0] + w[1] for w in walls[:CLI_STEPS]]
    return dict(corpus={k: v for k, v in CLI_SPLITS}, batch=TRAIN_B, steps=CLI_STEPS,
                valid_step=CLI_VALID, step_wall_s=float(np.median(steps)), step_walls_s=steps,
                steady_steps=CLI_STEADY, steady_step_wall_s=float(np.median(steady)),
                steady_step_mean_s=float(np.mean(steady)), steady_step_walls_s=steady,
                steady_memory=mem,
                step_log=[[round(w[0] + w[1], 6), w[2], w[3]] for w in walls],
                loader_s=[w[0] for w in walls], bare_step_wall_s=bare_walls,
                checkpoints=want, resumed_from=os.path.basename(ckpt), resume_bit_for_bit=True,
                graphs=graphs, replays={k: {n: r[n] for n in ("profiled_wall_s", "device_busy_s",
                                                              "kernel_launches")}
                                        for k, r in replays.items()},
                dev=[[st, n, v] for (st, n), v in sorted(dev_metrics.items())],
                gen_utterances=len(texts), gen_wall_s=gen_wall,
                gen_wall_per_utterance_s=gen_wall / len(texts),
                gen_graphed={"passes": gen_passes, "graphs": gen_graphs,
                             "wall_per_utterance_s": gen_passes[-1]["wall_s"] / len(texts),
                             "busy_s": gen_profile["device_busy_s"],
                             "idle_share": gen_profile["idle_share"],
                             "device_events": gen_profile["kernel_launches"]},
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                launches={"train": seen, "gen_specgram": gen_profile["kernels_seen"],
                          "validation": valid_profile["kernels_seen"]},
                validation_replay={k: valid_profile[k] for k in
                                   ("profiled_wall_s", "device_busy_s", "idle_share",
                                    "kernel_launches", "top_device_ms")},
                programs=programs_checked, trainer_graphs=trainer_graphs,
                wrapper_launches=wrapper_launches,
                media={"figures_drawn": drawn, "calls": len(writer.calls),
                       "tags_by_step": {st: len(writer.tags(st))
                                        for st in sorted({c[2] for c in writer.calls})},
                       "figure_inputs": len(figure_inputs), "dev_audio": dev_audio},
                validations=validations, validate_wall_s=timed_valid, profile=profile,
                native_decoder=decoder)


PRETRAIN_STEPS, PRETRAIN_VALID = 4, 2   # 1 warm-up and 3 timed steps of each LM
LM_KERNELS = {"text": ("bilstm_rec_cs", "bilstm_rec_bwd"),
              "speech": ("stft_frames", "spec_db", "bigru_rec", "bigru_rec_bwd")}
LM_ABSENT = {"text": (), "speech": ("attention_step", "attention_step_bwd")}
LM_DEV_KERNELS = {"text": ("bilstm_rec",), "speech": ("stft_frames", "spec_db", "bigru_rec")}
# the audio LM's leaves behind a ReLU or max-pool (`KINKED_LEAVES` without the tts prefix)
LM_KINKED = re.compile(r"^(postnet\.cbhg\.(banks|projs|pre_highway|highways)\."
                       r"|decoder\.(prenet|pseudo_std)\.)")
NDIR_WRAPPERS = ("bilstm_rec_cs", "bilstm_rec_bwd", "bigru_rec", "bigru_rec_bwd")


@contextlib.contextmanager
def directions_launched():
    """Yields a list that collects (wrapper, number of directions) for every
    call of the recurrences' wrappers through ``ops/rnn.py`` on the card."""
    from semi_tts_tpu_torch.ops import rnn as ops_rnn

    calls, saved = [], {n: getattr(ops_rnn, n) for n in NDIR_WRAPPERS}

    def wrap(name, fn):
        def recorded(*a):  # a[0], a[1]: the forward and reversed direction's W_hh
            if a[0].is_cuda:
                calls.append((name, 1 if a[1] is None else 2))
            return fn(*a)
        return recorded

    for n, fn in saved.items():
        setattr(ops_rnn, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(ops_rnn, n, fn)


def lm_reference(solver, batch, mode):
    """One LM step's loss and gradients through the card's kernels and
    through the plain path on the CPU: the same weights and BN statistics,
    every dropout 0, the same batch (the speech LM's first 2 rows) and
    coins; held as `paired_reference` holds the paired step."""
    from semi_tts_tpu_torch.ops.features import AudioFeaturizer
    from semi_tts_tpu_torch.train.losses import freq_loss
    from semi_tts_tpu_torch.train.train_lm import audiolm_loss_and_grads, textlm_loss_and_grads

    model = copy.deepcopy(solver.model)
    if mode == "speech":
        model.cfg = dataclasses.replace(model.cfg, prenet_dropout=0.0, query_dropout=0.0,
                                        dec_dropout=0.0)
    cpu_model = copy.deepcopy(model).cpu()
    waves, wave_len, text, _ = batch
    floss = functools.partial(freq_loss, **solver.freq_loss_kwargs())

    def run(m, device):
        if mode == "text":
            t = text.to(device).long()
            loss, grads = textlm_loss_and_grads(m, t, (t != 0).sum(-1))
        else:  # coins of 0: the teacher's frame at every step (tf_rate 1)
            feat = AudioFeaturizer(solver.featurizer.cfg, device)
            steps = waves.shape[1] // feat.cfg.hop_length + 1
            loss, grads = audiolm_loss_and_grads(
                m, feat, floss, waves[:2].to(device), wave_len[:2].to(device), None,
                coins=torch.zeros(steps, 2))
        return float(loss), [None if g is None else g.cpu() for g in grads]

    (loss_g, grads_g), (loss_c, grads_c) = run(model, solver.device), run(cpu_model, "cpu")
    kinked = LM_KINKED if mode == "speech" else None
    spread, by_leaf = card_spread(model, lambda m: run(m, solver.device)[1], grads_g, kinked)
    return checked({"loss_card": loss_g, "loss_cpu": loss_c,
                    "loss_rel_err": abs(loss_g - loss_c) / abs(loss_c), "loss_tol_rel": 1e-4,
                    **compare_grads(model, grads_g, grads_c, kinked=kinked, spread=by_leaf),
                    "card_spread": spread}, f"{mode} LM steps")


def pretrain_lm(root, config, mode):
    """``--pretrain-<mode>`` through its solver: PRETRAIN_STEPS steps
    validated every PRETRAIN_VALID, the launches and directions of step 0
    (its shape's first call, eager), the walls of steps 1.., peak memory,
    the card-vs-CPU step. The step and the dev loss are programs of the
    solver's `GraphOwner` (`lm_programs`). Returns (line, checkpoint path)."""
    from semi_tts_tpu_torch import kernels
    from semi_tts_tpu_torch.train.train_lm import AudioLmSolver, TextLmSolver

    cls = TextLmSolver if mode == "text" else AudioLmSolver
    solver = cls(config, cli_paras(root, name=f"lm_{mode}"), "train")
    solver.load_data()
    solver.set_model()
    run_step, walls, seen, losses = solver.train_step, [], {}, []

    def train_step(batch):
        if solver.step == 1:
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with directions_launched() as dirs:
            mets = run_step(batch)
            torch.cuda.synchronize()
        if solver.step >= 1:
            walls.append(time.perf_counter() - t0)
        if solver.step == 0:
            seen.update(launches=kernels.launch_counts(), dirs=dirs, batch=batch)
        losses.append(mets["total_loss"])
        return mets

    solver.train_step = train_step
    solver.exec()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    ckpt = os.path.join(solver.ckpdir, "best_mel.pth" if mode == "speech" else "best_acc.pth")
    if solver.step != PRETRAIN_STEPS or not np.isfinite(losses).all() or not os.path.exists(ckpt):
        raise SystemExit(f"chip_smoke: {mode} LM pretraining failed: step {solver.step}, "
                         f"losses {losses}, checkpoint {os.path.exists(ckpt)}")
    launches, dirs = seen["launches"], seen["dirs"]
    idle = [n for n in LM_KERNELS[mode] if launches[n] == 0]
    present = [n for n in LM_ABSENT[mode] if launches[n]]
    if mode == "text":
        bad = (launches["bilstm_rec_cs"] != 1 or launches["bilstm_rec_bwd"] != 1
               or sorted(dirs) != [("bilstm_rec_bwd", 1), ("bilstm_rec_cs", 1)])
    else:
        bad = any(n != 2 for w, n in dirs if w.startswith("bigru"))
    if idle or present or bad:
        raise SystemExit(f"chip_smoke: the {mode} LM step launched {launches} (directions {dirs}): "
                         f"idle {idle}, present {present}")
    batch = seen["batch"]
    solver.train_step = run_step
    programs = lm_programs(solver, batch, mode)
    ref = lm_reference(solver, batch, mode)
    line = dict(steps=PRETRAIN_STEPS, valid_step=PRETRAIN_VALID, batch=int(batch[0].shape[0]),
                shape=list(batch[2 if mode == "text" else 0].shape),
                params=sum(p.numel() for p in solver.model.parameters()),
                run_walls_s=walls, losses=losses, best_dev=solver.best_dev, peak_mem_bytes=peak,
                eager_launches=launches, directions=dirs, reference=ref, **programs)
    if solver.log is not None:
        solver.log.close()
    return line, ckpt


def lm_programs(solver, batch, mode):
    """An LM solver's programs on the card, on ``batch``: `graph_check` of
    its step (3 graphed against 3 eager steps from one copied state, and a
    rerun); the solver's own step program replayed on the batch (the wall,
    a median of TRAIN_STEPS replays, and a profiled replay that must run
    the LM's kernels, by name, and not the absent ones); the dev loss's
    program held to its eager twin (`program_check`); the owner's graph
    bytes."""
    from semi_tts_tpu_torch.graphs import NoGradProgram
    from semi_tts_tpu_torch.train.train_lm import make_audiolm_step, make_textlm_step

    def owner(device):
        return solver.graph_owner

    def make(opt):
        if mode == "speech":
            return make_audiolm_step(solver.featurizer, opt, solver.floss, owner,
                                     seed=solver.paras.seed)
        return make_textlm_step(opt, owner)

    args = solver._args(batch)
    check = graph_check(solver.model, solver.optimizer, make,
                        lambda fn, m, n: fn(m, n, *args), 100)
    step = solver._step
    for n in range(2):  # past the shape's first call (eager) and its capture
        step(solver.model, 200 + n, *args)
    wall = timed_wall(lambda: step(solver.model, 210, *args), TRAIN_STEPS)
    profile = profiled_step(lambda: step(solver.model, 211, *args), wall)
    seen = profile["kernels_seen"]
    require_seen(seen, LM_KERNELS[mode], f"{mode} LM step")
    if any(seen[n] for n in LM_ABSENT[mode]):
        raise SystemExit(f"chip_smoke: the {mode} LM step's replay ran {LM_ABSENT[mode]}: {seen}")
    dev_batch = next(iter(solver.dev_set))
    dev_args = solver._args(tuple(torch.from_numpy(dev_batch[k]).to(solver.device)
                                  for k in ("waves", "wave_len", "text", "sid")))
    dev = program_check(NoGradProgram(solver._dev.body, owner), [((solver.model, *dev_args), {})],
                        f"{mode} LM dev loss", LM_DEV_KERNELS[mode])
    return dict(wall_s=wall, eager_wall_s=check["eager_wall_s"], busy_s=profile["device_busy_s"],
                idle_share=profile["idle_share"], device_events=profile["kernel_launches"],
                eager_busy_s=check["eager_busy_s"], eager_idle_share=check["eager_idle_share"],
                eager_device_events=check["eager_device_events"], launches=seen,
                profile=profile, graph_check=check, graphs=step_graphs(step), dev=dev,
                graph_bytes=solver.graph_owner.graph_bytes,
                over_budget_calls=solver.graph_owner.over_budget_calls)


def phase_pretrain(card, asr_ckpt):
    """LM pretraining at flagship width on the synthetic CLI corpus:
    ``--pretrain-text`` (the text LM over the codebook table, one LSTM
    direction of 256 units: K1 with cell states and K7, one launch each,
    ndir=1) and ``--pretrain-speech`` (the decoder in pretrain mode at 1024
    units, the CBHG and the 1,025-bin head: K5, K2 and K8, and no attention
    kernel), each through its solver (`pretrain_lm`); then their
    checkpoints and the CLI phase's ``asr_ckpt`` grafted into a
    `VqvaeSolver` (every grafted leaf and the postnet's BN statistics equal
    to the files' bit for bit, the TTS text encoder equal to a cold
    solver's), which trains 2 steps."""
    from semi_tts_tpu_torch.bridge import _flatten, to_jax_params
    from semi_tts_tpu_torch.train.checkpoint import load_checkpoint
    from semi_tts_tpu_torch.train.train_vqvae import VqvaeSolver

    out = {"card": card}
    with tempfile.TemporaryDirectory() as root:
        config = cli_config(root)
        config["hparas"].update(max_step=PRETRAIN_STEPS, valid_step=PRETRAIN_VALID)
        ckpts = {}
        for mode in ("text", "speech"):
            out[mode], ckpts[mode] = pretrain_lm(root, config, mode)
            gc.collect()
        config["hparas"].update(max_step=2, valid_step=10 ** 9)
        cold = VqvaeSolver(config, cli_paras(root, name="cold"), "train")
        cold.load_data()
        cold.set_model()
        cold_p, cold_s = to_jax_params(cold.model)
        del cold
        grafted = copy.deepcopy(config)
        grafted["model"].update(pretrained_emb=ckpts["text"], pretrained_tts=ckpts["speech"],
                                pretrained_asr=asr_ckpt)
        warm = VqvaeSolver(grafted, cli_paras(root, name="warm"), "train")
        warm.load_data()
        warm.set_model()
        got_p, got_s = to_jax_params(warm.model)
        emb, tts, asr = (load_checkpoint(ckpts["text"]), load_checkpoint(ckpts["speech"]),
                         load_checkpoint(asr_ckpt))
        pairs = [("codebook/learnable_table", got_p["codebook"]["learnable_table"],
                  emb["model"]["codebook"]["learnable_table"]),
                 ("tts/decoder", got_p["tts"]["decoder"], tts["model"]["tts"]["decoder"]),
                 ("tts/postnet", got_p["tts"]["postnet"], tts["model"]["tts"]["postnet"]),
                 ("state tts/postnet", got_s["tts"]["postnet"], tts["state"]["tts"]["postnet"]),
                 ("asr", got_p["asr"], asr["model"]["asr"]),
                 ("state asr", got_s["asr"], asr["state"]["asr"]),
                 ("cold tts/encoder", got_p["tts"]["encoder"], cold_p["tts"]["encoder"]),
                 ("cold state tts/encoder", got_s["tts"]["encoder"], cold_s["tts"]["encoder"])]
        graft = {}
        for name, a, b in pairs:
            fa, fb = _flatten(a), _flatten(b)
            graft[name] = len(fa)
            if sorted(fa) != sorted(fb) or not all(np.array_equal(fa[k], fb[k]) for k in fa):
                raise SystemExit(f"chip_smoke: the graft of {name} is not bit for bit")
        warm.exec()
        finite = all(torch.isfinite(p).all() for p in warm.model.parameters())
        if warm.trainer.step != 2 or not finite:
            raise SystemExit(f"chip_smoke: the fine-tune after the graft failed: step "
                             f"{warm.trainer.step}, finite {finite}")
        out["graft"] = dict(leaves=graft, fine_tune_steps=warm.trainer.step)
        if warm.log is not None:
            warm.log.close()
    return out


# The wide routes of the recurrences (K1w, K7w, K2w, K8w), each held to its
# plain version and timed at these (T, B, H, ndir): RNNLM's layer (B=8 x 47
# inputs, one direction of 512 units), the ASR BiLSTM at rnn_dim 512 (T=133,
# both directions), 1,024 units, and just past the narrow plans (292 units,
# and 258, not a multiple of 4; the GRU's 129). The first is the row's own.
WIDE_LSTM_SHAPES = ((47, 8, 512, 1), (133, 8, 512, 2), (32, 8, 1024, 1), (40, 5, 292, 2),
                    (40, 5, 258, 2))
WIDE_GRU_SHAPES = ((47, 8, 512, 1), (32, 8, 1024, 1), (40, 5, 129, 2))
# The design of each wide route at each shape it is held at
# (`wide_design_plan` on an H100): the cluster design at their rows' shapes and
# at B=64 (K7w's and K8w's partials (2, B, H) past shared memory: 32 batch rows
# at a time; K1w and K2w 8 chunks of 8 batch rows), the first (grid) design where a
# CTA's G*U rows of W_hh and its buffers do not fit shared memory (1,024
# units in both directions)
WIDE_MORE_SHAPES = ((40, 64, 512, 2), (32, 8, 1024, 2))
K1W_DESIGNS = K7W_DESIGNS = {**{sh: "cluster" for sh in WIDE_LSTM_SHAPES},
                             (40, 64, 512, 2): "cluster", (32, 8, 1024, 2): "grid"}
K2W_DESIGNS = K8W_DESIGNS = {**{sh: "cluster" for sh in WIDE_GRU_SHAPES},
                             (40, 64, 512, 2): "cluster", (32, 8, 1024, 2): "grid"}
WIDE_DESIGNS = {"lstm": K1W_DESIGNS, "lstm_bwd": K7W_DESIGNS, "gru": K2W_DESIGNS,
                "gru_bwd": K8W_DESIGNS}
WIDE_KERNELS = ("lstm_rec_wide", "lstm_rec_bwd_wide", "gru_rec_wide", "gru_rec_bwd_wide")
NARROW_RECURRENCES = ("bilstm_rec", "bilstm_rec_cs", "bilstm_rec_bwd", "bigru_rec",
                      "bigru_rec_bwd")
RNNLM_B, RNNLM_U = 8, 48   # the CLI corpus's longest text: 48 tokens, 47 inputs
ASR_WIDE_RNN_DIM = 512     # model.encoder.rnn_dim of the ASR step (c)


def _wide_specs(randn, unif, dev):
    """The wide routes' rows: inputs at a (T, B, H, ndir), the wrapper that
    routes there, its plain version, bytes moved, the library yardstick."""
    from semi_tts_tpu_torch.kernels import rnn as k

    def one_dir(a, per_dir):  # keep the forward direction's tensors alone
        return [t if i % 2 == 0 else None for i, t in enumerate(a[:2 * per_dir])] + a[2 * per_dir:]

    def lstm_in(T, B_, H, n):
        a = _lstm_inputs(randn, unif, T, B_, H)
        return a if n == 2 else one_dir(a, 2)

    def gru_in(T, B_, H, n):
        a = _gru_inputs(randn, unif, T, B_, H)
        return a if n == 2 else one_dir(a, 3)

    def forward(cls):
        def make(T, B_, H, n):
            module, x = cls(H, H, bidirectional=n == 2).to(dev), randn(T, B_, H)
            return lambda: module(x)
        return make

    def backward(cls):
        return lambda T, B_, H, n: _rnn_library_backward(cls, randn, dev, T, B_, H, n, H)

    note = ("cuDNN nn.{}(H, H), bidirectional where ndir=2, at each shape; the input GEMM "
            "included; {}")
    return [
        dict(name="lstm_rec_wide", kernel=k.bilstm_rec_cs, plain=k.bilstm_rec_cs_plain,
             inputs=lstm_in, cost=_lstm_cs_cost, shapes=WIDE_LSTM_SHAPES + WIDE_MORE_SHAPES,
             plan="lstm",
             library=forward(torch.nn.LSTM), timing=device_ms,
             note=note.format("LSTM", "forward, graph-timed"),
             replaces="tools/proto_pallas_rnn.py:33 (pallas_lstm_rec, pallas_call at :61); "
             "semi_tts_tpu/ops/rnn.py:95 (_lstm_rec_fwd), past K1's plans (H > 288 or "
             "H % 4 != 0)"),
        dict(name="lstm_rec_bwd_wide", kernel=k.bilstm_rec_bwd, plain=k.bilstm_rec_bwd_plain,
             inputs=lambda *sh: _lstm_bwd_inputs(randn, unif, *sh), cost=_lstm_bwd_cost,
             shapes=WIDE_LSTM_SHAPES + WIDE_MORE_SHAPES, plan="lstm_bwd",
             library=backward(torch.nn.LSTM),
             timing=time_ms,
             note=note.format("LSTM", "backward: data and weight gradients (CUDA events, eager)"),
             replaces="semi_tts_tpu/ops/rnn.py:114 (_lstm_rec_bwd, the backward scan), past "
             "K7's plans"),
        dict(name="gru_rec_wide", kernel=k.bigru_rec, plain=k.bigru_rec_plain, inputs=gru_in,
             cost=_gru_cost, shapes=WIDE_GRU_SHAPES + WIDE_MORE_SHAPES, plan="gru",
             library=forward(torch.nn.GRU),
             timing=device_ms,
             note=note.format("GRU", "forward, graph-timed"),
             replaces="semi_tts_tpu/ops/rnn.py:225 (_gru_rec_fwd), past K2's plan (H > 128)"),
        dict(name="gru_rec_bwd_wide", kernel=k.bigru_rec_bwd, plain=k.bigru_rec_bwd_plain,
             inputs=lambda *sh: _gru_bwd_inputs(randn, unif, *sh), cost=_gru_bwd_cost,
             shapes=WIDE_GRU_SHAPES + WIDE_MORE_SHAPES, plan="gru_bwd",
             library=backward(torch.nn.GRU),
             timing=time_ms,
             note=note.format("GRU", "backward: data and weight gradients (CUDA events, eager)"),
             replaces="semi_tts_tpu/ops/rnn.py:244 (_gru_rec_bwd, the backward scan), past "
             "K8's plan")]


def wide_kernel_rows(dev):
    """The kernels line's rows of the wide routes: each held to its plain
    version at 1e-4 at every shape of its list, a rerun and two replays of a
    CUDA graph of it bit for bit, timed there (graph-replayed), beside its
    plain version, its bound and the cuDNN yardstick; the row's own numbers
    at its first shape; the plan of K1w, K7w and K8w at each shape must take
    the design of `WIDE_DESIGNS`, so that both designs of each are held.
    Also K1w without cell states (both wrappers) and K2w through `gru_rec`,
    one direction reversed."""
    from semi_tts_tpu_torch.kernels import rnn as k

    g = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def unif(*shape, a):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * a

    rows = []
    with torch.no_grad():
        w, _, x, _ = _lstm_inputs(randn, unif, 40, 5, 258)
        bi = _lstm_inputs(randn, unif, 40, 5, 292)
        wg, _, bg, _, xg, _ = _gru_inputs(randn, unif, 40, 5, 129)
        extra = {"lstm_rec reversed T=40 B=5 H=258": max_err(k.lstm_rec(True, w, x),
                                                             k.lstm_rec_plain(True, w, x)),
                 "bilstm_rec T=40 B=5 H=292": max_err(k.bilstm_rec(*bi), k.bilstm_rec_plain(*bi)),
                 "gru_rec reversed T=40 B=5 H=129": max_err(k.gru_rec(True, wg, bg, xg),
                                                            k.gru_rec_plain(True, wg, bg, xg))}
        for spec in _wide_specs(randn, unif, dev):
            by = {n: {} for n in ("err", "ms", "plain", "bound", "library", "plan", "rerun",
                                  "replays")}
            for sh in spec["shapes"]:
                key, a = shape_key(*sh), spec["inputs"](*sh)
                run = lambda a=a: spec["kernel"](*a)
                first = run()
                by["err"][key] = max_err(first, spec["plain"](*a))
                # a rerun and two graph replays bit for bit (fixed summation
                # orders, no atomics on values)
                again = run()
                by["rerun"][key] = all(torch.equal(x, y) for x, y in zip(
                    first if isinstance(first, tuple) else (first,),
                    again if isinstance(again, tuple) else (again,)) if x is not None)
                by["replays"][key] = graph_replays_equal(run, first)
                if not (by["err"][key] <= 1e-4 and by["rerun"][key] and by["replays"][key]):
                    raise SystemExit(f"chip_smoke: {spec['name']} disagrees with its plain "
                                     f"version, its rerun or its graph replays at {key}: "
                                     f"{by['err'][key]}, rerun equal {by['rerun'][key]}, "
                                     f"replays equal {by['replays'][key]}")
                by["ms"][key] = device_ms(run, 10)
                by["plain"][key] = device_ms(lambda a=a: spec["plain"](*a), 2)
                by["bound"][key] = bound(spec["cost"](*sh), run)
                by["library"][key] = spec["timing"](spec["library"](*sh), 10)
                by["plan"][key] = k.wide_design_plan(spec["plan"], sh[1], sh[2], sh[3], dev)
                want = WIDE_DESIGNS.get(spec["plan"], {}).get(sh, "grid")
                if by["plan"][key]["design"] != want:
                    raise SystemExit(f"chip_smoke: {spec['name']}'s plan at {key} took the "
                                     f"{by['plan'][key]['design']} design, not {want}: "
                                     f"{by['plan'][key]}")
            main = shape_key(*spec["shapes"][0])
            print(f"kernel {spec['name']}: max_abs_err {max(by['err'].values()):.3e} (tol 1e-4)",
                  flush=True)
            rows.append({"name": spec["name"], "route": "cuda",
                         "source": "semi_tts_tpu_torch/csrc/rnn_wide.cu",
                         "replaces": spec["replaces"], "shapes": main, "launches": None,
                         "max_abs_err": max(by["err"].values()), "tol": 1e-4,
                         "ms": by["ms"][main], "plain_ms": by["plain"][main],
                         "bound_ms": by["bound"][main][0], "bound_by": by["bound"][main][1],
                         "library_ms": by["library"][main], "library": spec["note"],
                         "us_per_step": 1e3 * by["ms"][main] / spec["shapes"][0][0],
                         "ms_by_shape": by["ms"], "plain_ms_by_shape": by["plain"],
                         "bound_ms_by_shape": {n: b[0] for n, b in by["bound"].items()},
                         "library_ms_by_shape": by["library"],
                         "max_abs_err_by_shape": by["err"], "plans_by_shape": by["plan"],
                         "rerun_equal_by_shape": by["rerun"],
                         "replays_equal_by_shape": by["replays"]})
    if not max(extra.values()) <= 1e-4:
        raise SystemExit(f"chip_smoke: a wide route disagrees with its plain version: {extra}")
    rows[0]["checks"] = extra
    return rows


def rnnlm_step(opt, owner):
    """A train step of `RNNLM` (no solver builds one) as `make_textlm_step`
    makes the text LM's: ``step(model, step_no, text)`` -> dict(total_loss,
    grad_norm), `rnnlm_loss` on int text (B, U) padded with 0, its
    gradients and ``opt``'s update; a `graphs.StepProgram`."""
    from semi_tts_tpu_torch.graphs import StepProgram
    from semi_tts_tpu_torch.models.lm import rnnlm_loss

    def step(model, step_no, text, *, generator):
        text = text.long()
        loss = rnnlm_loss(model, text, (text != 0).sum(-1))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return dict(total_loss=loss.detach(), grad_norm=opt.step(grads))

    return StepProgram(step, opt, 0, owner)


def rnnlm_text(vocab, seed=0):
    """RNNLM_B texts of 40..RNNLM_U tokens in 3..vocab-1, the first of
    RNNLM_U, padded with 0 (int32)."""
    rng = np.random.RandomState(seed)
    text = np.zeros((RNNLM_B, RNNLM_U), np.int32)
    for b in range(RNNLM_B):
        n = RNNLM_U if b == 0 else rng.randint(40, RNNLM_U + 1)
        text[b, :n] = rng.randint(3, vocab, size=n)
    return torch.from_numpy(text)


def rnnlm_reference(model, text, dev, cell):
    """One RNNLM step's loss and gradients through the card's kernels and
    through the plain path on the CPU on the same weights and text, held as
    `lm_reference` holds the LM steps."""
    from semi_tts_tpu_torch.models.lm import rnnlm_loss

    def run(m, device):
        t = text.to(device).long()
        loss = rnnlm_loss(m, t, (t != 0).sum(-1))
        return float(loss), [g.cpu() for g in torch.autograd.grad(loss, list(m.parameters()))]

    (loss_g, grads_g), (loss_c, grads_c) = run(model, dev), run(copy.deepcopy(model).cpu(), "cpu")
    spread, _ = card_spread(model, lambda m: run(m, dev)[1], grads_g)
    return checked({"loss_card": loss_g, "loss_cpu": loss_c,
                    "loss_rel_err": abs(loss_g - loss_c) / abs(loss_c), "loss_tol_rel": 1e-4,
                    **compare_grads(model, grads_g, grads_c), "card_spread": spread},
                   f"RNNLM-{cell} steps")


def rnnlm_phase(dev, cell):
    """Step (a) (``cell`` "lstm") or (b) ("gru"): `RNNLM` at its default
    width (512 units, 2 layers; the phone table's vocabulary, the codebook's
    64 latent dims) trained on B=8 x 48 tokens (T=47) through `rnnlm_step`
    with Adam and the Noam schedule ("warmup"): its shape captured at the
    first call, a replay's wall (median of TRAIN_STEPS), a profiled replay
    whose wide kernels must each run exactly twice (a launch a layer) and
    no narrow recurrence, peak memory, the card against the CPU plain path,
    and `graph_check`."""
    from semi_tts_tpu_torch import kernels
    from semi_tts_tpu_torch.data.text import load_text_encoder
    from semi_tts_tpu_torch.graphs import GraphOwner
    from semi_tts_tpu_torch.models.lm import RNNLM
    from semi_tts_tpu_torch.train.optim import Optimizer

    vocab = load_text_encoder("phoneme", os.path.join(HERE, "data/cmu_phn.vocab")).vocab_size
    model = RNNLM(vocab, 64, module=cell, generator=torch.Generator().manual_seed(0)).to(dev)
    text = rnnlm_text(vocab).to(dev)
    graph_owner = GraphOwner(dev)
    owner = lambda device: graph_owner  # noqa: E731
    opt = Optimizer(model.parameters(), "Adam", 1e-3, "warmup")
    step = rnnlm_step(opt, owner)
    step.capture_at = 1
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses = [float(step(model, 0, text)["total_loss"])]
    wrapper = kernels.launch_counts()
    losses += [float(step(model, n, text)["total_loss"]) for n in (1, 2)]
    wall = timed_wall(lambda: step(model, 3, text), TRAIN_STEPS)
    profile = profiled_step(lambda: step(model, 4, text), wall)
    peak = torch.cuda.max_memory_allocated()
    seen = profile["kernels_seen"]
    want = ("lstm_rec_wide", "lstm_rec_bwd_wide") if cell == "lstm" else ("gru_rec_wide",
                                                                          "gru_rec_bwd_wide")
    require_seen(seen, want, f"RNNLM-{cell} step")
    if any(seen[n] != 2 for n in want) or any(seen[n] or wrapper[n] for n in NARROW_RECURRENCES):
        raise SystemExit(f"chip_smoke: the RNNLM-{cell} step ran {seen} (wrappers {wrapper})")
    if not np.isfinite(losses).all():
        raise SystemExit(f"chip_smoke: the RNNLM-{cell} step went non-finite: {losses}")
    ref = rnnlm_reference(model, text, dev, cell)
    check = graph_check(model, opt, lambda o: rnnlm_step(o, owner),
                        lambda fn, m, n: fn(m, n, text), 100)
    return dict(vocab=vocab, dim=512, layers=2, batch=RNNLM_B, inputs=RNNLM_U - 1,
                params=sum(p.numel() for p in model.parameters()), losses=losses, wall_s=wall,
                eager_wall_s=check["eager_wall_s"], busy_s=profile["device_busy_s"],
                idle_share=profile["idle_share"], device_events=profile["kernel_launches"],
                peak_mem_bytes=peak, launches=seen, wrapper_launches=wrapper, profile=profile,
                graphs=step_graphs(step), graph_check=check, reference=ref)


def phase_wide(card, dev):
    """Phase 12, the wide routes: `wide_kernel_rows`, then steps (a)
    RNNLM-LSTM and (b) RNNLM-GRU (`rnnlm_phase`) and (c) the ASR step at
    rnn_dim 512 (`phase_training`). Returns (rows, the wide line)."""
    from semi_tts_tpu_torch.device import use_deterministic

    use_deterministic()
    rows = wide_kernel_rows(dev)
    line = {"card": card, "rnnlm_lstm": rnnlm_phase(dev, "lstm")}
    gc.collect()
    line["rnnlm_gru"] = rnnlm_phase(dev, "gru")
    gc.collect()
    line["asr_512"] = phase_training(dev, rnn_dim=ASR_WIDE_RNN_DIM)
    gc.collect()
    return rows, line


def flops_line(card, paths):
    """{path: (FLOPs of one eager call, graphed wall)} -> the ``flops``
    line: each path's matrix-product FLOPs (`utils.flops.matmul_flops`),
    its rate over the graphed wall and that rate over FP32_FLOP_PER_S
    (``mfu_fp32``; the port runs fp32 outside the tensor cores)."""
    return dict(card=card, peak_flop_per_s=FP32_FLOP_PER_S,
                paths={n: {"flops": f, "wall_s": w, "flop_per_s": f / w,
                           "mfu_fp32": f / w / FP32_FLOP_PER_S} for n, (f, w) in paths.items()})


def gl_rounds_check(amp, phases, acfg):
    """K4 at every round of one Griffin-Lim of ``amp`` (B, T, F) on the card
    from ``phases``: each round's `gl_project` and `gl_ola_frame` outputs
    against their plain versions on the same inputs -> {kernel: the largest
    max abs error over the rounds}."""
    from semi_tts_tpu_torch.kernels import griffin_lim as k4
    from semi_tts_tpu_torch.ops.features import GFL_ITER
    from semi_tts_tpu_torch.ops.stft import dft_basis, inv_dft_basis

    geo = dict(n_fft=acfg.n_fft, hop=acfg.hop_length, win_length=acfg.win_length)
    mag, dev = amp.abs(), amp.device
    fwd = torch.cat(dft_basis(acfg.n_fft, acfg.win_length, dev), dim=1)
    inv = torch.cat(inv_dft_basis(acfg.n_fft, acfg.win_length, dev), dim=0)
    inv_f = torch.cat([mag * torch.cos(phases), mag * torch.sin(phases)], dim=-1) @ inv
    errs = dict.fromkeys(("gl_project", "gl_ola_frame"), 0.0)
    for i in range(GFL_ITER + 1):
        last = i == GFL_ITER
        frames = k4.gl_ola_frame(inv_f, emit_signal=last, **geo)
        errs["gl_ola_frame"] = max(errs["gl_ola_frame"], max_err(
            frames, k4.gl_ola_frame_plain(inv_f, emit_signal=last, **geo)))
        if last:
            return errs
        reim = frames @ fwd
        proj = k4.gl_project(reim, mag)
        errs["gl_project"] = max(errs["gl_project"], max_err(proj, k4.gl_project_plain(reim, mag)))
        inv_f = proj @ inv


@contextlib.contextmanager
def plain_griffin_lim():
    """Griffin-Lim with K4's plain versions in place of the kernels (the
    same GEMMs on the same device): the reference a vocoded batch on the
    card is held to where the CPU's different summation order would grow
    through the rounds."""
    from semi_tts_tpu_torch.kernels import griffin_lim as k4
    from semi_tts_tpu_torch.ops import griffin_lim as gl

    saved = gl.gl_project, gl.gl_ola_frame
    gl.gl_project, gl.gl_ola_frame = k4.gl_project_plain, k4.gl_ola_frame_plain
    try:
        yield
    finally:
        gl.gl_project, gl.gl_ola_frame = saved


TOOLS_SEED, TOOLS_STEP = 14, 1234


def phase_tools(specs_dir, dev):
    """The tools around the CLI on the card. An upstream-layout ``.pth``
    of a seeded flagship model (the inverse of `torch_import.name_table`,
    BatchNorm statistics moved off their initial values) goes through
    ``util_cli.import_reference_ckpt``; `TTSServer.from_checkpoint` on the
    result serves B x U, bit for bit the waves of the same weights written
    directly, with K1-K4 launched. ``util_cli.gen_wav_from_specgram`` vocodes
    phase 8's spectrograms (one wav each, at the sample rate); the
    Griffin-Lim program is held to its eager twin at the first batch's shape
    and at half its rows (`program_check`); and one batch
    of 16 is checked round by round (`gl_rounds_check`: at every round K4's
    outputs against their plain versions on the same inputs, 1e-4 as in
    phase 3). The whole vocoded batch's distance to the plain Griffin-Lim on
    the card (``rel_err_plain``) and on the CPU (``rel_err_cpu``) is
    reported, not gated: on these spectrograms of a barely trained model
    (about half the bins at the dB floor) the 30 rounds amplify a 1-ulp
    difference ~10^4-fold (6e-7 at the first round, 1e-2 at the last
    against the CPU), so only a bit-identical implementation would agree
    to 1e-3."""
    from semi_tts_tpu_torch import kernels
    from semi_tts_tpu_torch.bridge import to_jax_params
    from semi_tts_tpu_torch.data import wavio
    from semi_tts_tpu_torch.models import vqvae as V
    from semi_tts_tpu_torch.ops.features import linear_to_amp
    from semi_tts_tpu_torch.ops.griffin_lim import (griffin_lim_program, random_phases,
                                                    specgram_to_waveform)
    from semi_tts_tpu_torch.serve import TTSServer
    from semi_tts_tpu_torch.train import torch_import as TI
    from semi_tts_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from semi_tts_tpu_torch.util_cli import gen_wav_from_specgram as GW
    from semi_tts_tpu_torch.util_cli import import_reference_ckpt as IR

    config = flagship_config()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        cfg, phn_attr = IR.model_config(config)
        model = V.VQVAE(cfg, generator=torch.Generator().manual_seed(TOOLS_SEED))
        g = torch.Generator().manual_seed(TOOLS_SEED)
        with torch.no_grad():
            for name, b in model.named_buffers():
                if name.endswith(".mean") or name.endswith(".var"):
                    b.uniform_(0.5, 1.5, generator=g)
        direct, upstream, imported = (os.path.join(root, n) for n in
                                      ("direct.pth", "upstream.pth", "imported.pth"))
        params, state = to_jax_params(model)
        save_checkpoint(direct, params=params, state=state, opt_state=None, step=TOOLS_STEP)
        sd = TI.inverse_state_dict(model.state_dict(), cfg, phn_attr)
        torch.save({"model": sd, "optimizer": {}, "global_step": TOOLS_STEP}, upstream)
        del model
        t0 = time.perf_counter()
        IR.convert(config, upstream, imported)
        import_s = time.perf_counter() - t0
        if load_checkpoint(imported)["global_step"] != TOOLS_STEP:
            raise SystemExit("chip_smoke: the imported checkpoint lost its step")
        text, sid = serving_inputs(B, U, seed=3)
        server = TTSServer.from_checkpoint(config, direct, device=dev)
        want = server.synthesize(text, sid, key=5)
        del server
        gc.collect()
        kernels.reset_launches()
        server = TTSServer.from_checkpoint(config, imported, device=dev)
        got = server.synthesize(text, sid, key=5)
        served = kernels.launch_counts()
        del server
        gc.collect()
        idle = [n for n in SERVING_KERNELS if served[n] == 0]
        if idle or not np.array_equal(got, want):
            raise SystemExit(f"chip_smoke: imported-checkpoint serving: kernels idle {idle}, "
                             f"bit for bit {np.array_equal(got, want)}")
        out["import"] = dict(upstream_tensors=len(sd), import_s=import_s, served=list(got.shape),
                             bit_for_bit=True, launches=served)

        acfg = GW.audio_config(config)
        wav_dir = os.path.join(root, "wavs")
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = GW.vocode_dir(acfg, specs_dir, wav_dir, batch=16, device=dev, verbose=False)
        tool_wall = time.perf_counter() - t0
        tool_launches = kernels.launch_counts()
        specs = sorted(os.path.basename(f).replace("-spec.npy", ".wav")
                       for f in glob.glob(os.path.join(specs_dir, "*-spec.npy")))
        if sorted(os.listdir(wav_dir)) != specs or len(written) != len(specs) or not specs:
            raise SystemExit(f"chip_smoke: gen_wav_from_specgram wrote {sorted(os.listdir(wav_dir))}"
                             f" for {specs}")
        for f in written:
            w, sr = wavio.read(f)
            if sr != acfg.sample_rate or not np.isfinite(w).all():
                raise SystemExit(f"chip_smoke: gen_wav_from_specgram wrote a bad {f}")
        paths, batch = GW.batches(specs_dir, 16)[0]
        kernels.reset_launches()
        wavs = GW.vocode(batch, acfg, griffin_lim_program(), dev, seed=0)
        per_batch = kernels.launch_counts()
        phases = random_phases(batch.shape, torch.Generator(device=dev).manual_seed(0), dev)
        geo = dict(n_fft=acfg.n_fft, hop=acfg.hop_length, win_length=acfg.win_length,
                   preemphasis_coeff=acfg.preemphasis_coeff)
        amp = linear_to_amp(torch.from_numpy(batch))
        out["griffin_lim"] = program_check(
            griffin_lim_program(), [((amp.to(dev),), geo), ((amp[: len(amp) // 2].to(dev),), geo)],
            "Griffin-Lim", ("gl_project", "gl_ola_frame"))
        rounds = gl_rounds_check(amp.to(dev), phases, acfg)
        with plain_griffin_lim():
            plain = specgram_to_waveform(amp.to(dev), phases=phases, **geo).cpu()
        cpu = specgram_to_waveform(amp, phases=phases.cpu(), **geo)
        worst = max(rounds.values())
        if not worst <= 1e-4 or not (per_batch["gl_project"] and per_batch["gl_ola_frame"]):
            raise SystemExit(f"chip_smoke: gen_wav_from_specgram's batch: K4 against its plain "
                             f"versions round by round {rounds}, launches {per_batch}")
        out["gen_wav"] = dict(files=len(written), batches=len(GW.batches(specs_dir, 16)),
                              wall_s=tool_wall, checked_batch=list(batch.shape),
                              max_abs_err_by_round=rounds,
                              rel_err_plain=float((wavs.cpu() - plain).abs().max()
                                                  / plain.abs().max()),
                              rel_err_cpu=float((wavs.cpu() - cpu).abs().max() / cpu.abs().max()),
                              floor_share=float((batch <= 0).mean()),
                              launches=tool_launches, launches_per_batch=per_batch)
    return out


# ---- phase 11: meshes (`semi_tts_tpu_torch.parallel`) ------------------------

MESH_TIMEOUT_S = 300       # every process group's timeout
MESH_DEADLINE_S = 420      # a spawned world's: its ranks killed and the run failed past it
MESH_REPS = 3              # timed replays of each captured step, mesh and mesh-less alike
MESH_STEPS = {PAIRED: (1, 3, 5), SPEECH_FIRST: (2, 4, 6)}  # GRAPH_STEPS step numbers of each
MESH_SERVE = ((B, U), (3, 20))  # split over two ranks; whole on each (3 rows)
# ulp draws of the one-process step's own spread, which bounds the kinked
# leaves of the mesh check (a mesh changes every reduction order at once:
# BatchNorm's statistics, the gradient's row sums). ``--mesh-study`` reads
# the spread after each of MESH_STUDY_DRAWS draws on each of
# MESH_STUDY_SEEDS: a leaf's spread reads ~4e-5 until a draw crosses one of
# its kinks and 1.6-2.2e-3 after; at 4 draws one seed of three crossed none
# and failed the check, at 8 and at 16 every seed held it (PERF.md §6)
MESH_SPREAD_DRAWS = 8
MESH_STUDY_DRAWS = (4, 8, 16)
MESH_STUDY_SEEDS = (0, 1, 2)


def state_digest(model):
    """sha256 of the bytes of every parameter and buffer of ``model``, in
    order."""
    import hashlib

    h = hashlib.sha256()
    for t in list(model.parameters()) + list(model.buffers()):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _mesh_model(dev):
    """(cfg, phn_attr on ``dev``, the flagship model from seed 0 on ``dev``)."""
    from semi_tts_tpu_torch.models import vqvae as V
    from semi_tts_tpu_torch.utils.metrics import read_phn_attr

    config = flagship_config()
    cfg = flagship_vqvae_config(config)
    phn_attr = torch.from_numpy(read_phn_attr(config["model"]["codebook"]["phn_attr_pth"]))
    model = V.VQVAE(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    return cfg, phn_attr.to(dev), model


def _mesh_builder(cfg, phn_attr, dev, mesh):
    from semi_tts_tpu_torch.ops.features import AudioFeaturizer
    from semi_tts_tpu_torch.train.steps import StepBuilder, Weights

    return StepBuilder(cfg, AudioFeaturizer(audio_config(), dev), phn_attr,
                       weights=Weights(**CYCLE_WEIGHTS), freq_loss_kwargs=FLAGSHIP_FREQ_LOSS,
                       mesh=mesh)


def _mesh_batches(kind, dev):
    """The global batch of a kind's step: B=8 x 3.0 s paired, and for the
    speech-first step 8 unpaired rows more."""
    pair = training_batch(0, dev)
    return pair if kind == PAIRED else pair + training_batch(2, dev)


def _make(builder, kind, opt):
    return (builder.make_paired_step if kind == PAIRED else builder.make_speech_first_step)(opt)


def mesh_captured(dev):
    """(a) One rank over NCCL (``--mesh 1x1``): the graphed paired and
    speech-first steps through the mesh code (the gradient's all-reduce and
    the losses' mean captured in the graph) against the mesh-less graphed
    steps from one copy of the state: GRAPH_STEPS steps of each, every
    metric, parameter, BN statistic and optimizer tensor compared; then
    MESH_REPS more replays of each, timed in turn, the kernels launched on
    the mesh path (the wrappers' counters over its capture), the
    collectives the mesh steps issued (``all_reduce_calls``, counted at the
    Python call: the capture's are in the graph), and one profiled mesh
    replay: its kernels by name and the launches and device time of NCCL's
    kernels (``nccl``: none on an H100, a one-rank all-reduce in place
    launching no kernel)."""
    import datetime

    import torch.distributed as dist

    from semi_tts_tpu_torch import kernels
    from semi_tts_tpu_torch.parallel.mesh import make_mesh
    from semi_tts_tpu_torch.train.optim import Optimizer

    if not dist.is_nccl_available():
        raise SystemExit("chip_smoke: torch.distributed has no NCCL on this machine")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        try:
            mesh = make_mesh(1)
            cfg, phn_attr, model = _mesh_model(dev)
            all_reduce = dist.all_reduce
            calls = []

            def counted(*a, **k):
                calls.append(1)
                return all_reduce(*a, **k)

            for kind in (PAIRED, SPEECH_FIRST):
                batch = _mesh_batches(kind, dev)
                runs = {}
                for name, m in (("mesh", mesh), ("plain", None)):
                    mm = copy.deepcopy(model)
                    opt = Optimizer(mm.parameters(), lr=1e-3, lr_scheduler="decay", mesh=m)
                    step = _make(_mesh_builder(cfg, phn_attr, dev, m), kind, opt)
                    step.capture_at = 1
                    start = [t.detach().clone() for _, t in model_state(mm, opt)]
                    kernels.reset_launches()
                    calls.clear()
                    dist.all_reduce = counted
                    try:
                        mets = [step(mm, n, 1.0, *batch) for n in MESH_STEPS[kind]]
                    finally:
                        dist.all_reduce = all_reduce
                    runs[name] = dict(model=mm, opt=opt, step=step, mets=mets, start=start,
                                      launches=kernels.launch_counts(), calls=len(calls))
                differing, held = [], True
                for i, (g, e) in enumerate(zip(runs["mesh"]["mets"], runs["plain"]["mets"])):
                    for k in g:
                        if not torch.equal(g[k], e[k]):
                            scalar = k.endswith("_loss") or k == "grad_norm"
                            err = _rel(g[k].float(), e[k].float(), e[k].float()) if scalar else None
                            differing.append([f"step {i} {k}", err])
                            held = held and scalar and err <= 1e-4
                mesh_state = model_state(runs["mesh"]["model"], runs["mesh"]["opt"])
                for (name, g), (_, e), s0 in zip(mesh_state, model_state(runs["plain"]["model"],
                                                                         runs["plain"]["opt"]),
                                                 runs["plain"]["start"]):
                    if not torch.equal(g, e):
                        err = None if not g.is_floating_point() else _rel(g, e, e - s0)
                        differing.append([name, err])
                        held = held and err is not None and err <= 1e-3
                walls = {"mesh": [], "plain": []}
                n0 = MESH_STEPS[kind][-1] + 2
                for r in range(MESH_REPS):
                    for name in ("mesh", "plain"):
                        run = runs[name]
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        run["step"](run["model"], n0 + 2 * r, 1.0, *batch)
                        torch.cuda.synchronize()
                        walls[name].append(time.perf_counter() - t0)
                wall = float(np.median(walls["mesh"]))
                run = runs["mesh"]
                prof = profiled_step(lambda: run["step"](run["model"], n0 + 2 * MESH_REPS, 1.0,
                                                         *batch), wall,
                                     picked=("nccl",))
                names = PAIRED_STEP_KERNELS + (CYCLE_KERNELS if kind == SPEECH_FIRST else ())
                idle = [n for n in names if run["launches"][n] == 0]
                if idle:
                    raise SystemExit(f"chip_smoke: kernels not launched on the 1x1 mesh {kind} "
                                     f"step: {idle}")
                require_seen(prof["kernels_seen"], names, f"1x1 mesh {kind} step")
                res = dict(steps=len(MESH_STEPS[kind]), bit_for_bit=not differing,
                           differing=differing[:20], held_to_gates=held,
                           wall_s=wall, walls_s=walls["mesh"],
                           plain_wall_s=float(np.median(walls["plain"])),
                           plain_walls_s=walls["plain"], busy_s=prof["device_busy_s"],
                           idle_share=prof["idle_share"],
                           all_reduce_calls=run["calls"],
                           plain_all_reduce_calls=runs["plain"]["calls"],
                           nccl=dict(zip(("launches", "device_ms"), prof["picked_ms"]["nccl"])),
                           top_device_ms=prof["top_device_ms"][:8],
                           launches=prof["kernels_seen"], wrapper_launches=run["launches"],
                           graphs=step_graphs(run["step"]),
                           total_loss=[float(m["total_loss"]) for m in run["mets"]])
                if not held:
                    raise SystemExit(f"chip_smoke: the 1x1 mesh {kind} step and the mesh-less "
                                     f"one disagree: {res}")
                if not run["calls"] or runs["plain"]["calls"]:
                    raise SystemExit(f"chip_smoke: the 1x1 mesh {kind} step issued "
                                     f"{run['calls']} all-reduces, the mesh-less one "
                                     f"{runs['plain']['calls']}")
                out[kind] = res
                del runs, run
                gc.collect()
        finally:
            dist.destroy_process_group()
    return out


def _mesh_world(n, target, args, what):
    """``target(rank, n, store, out, *args)`` in ``n`` spawned processes
    (``spawn``: this one holds a CUDA context), joined with MESH_DEADLINE_S;
    a rank still running then is killed and the run fails, as does a rank
    that fails. Returns the ranks' pickled results."""
    import multiprocessing as mp
    import pickle

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(n)]
        procs = [ctx.Process(target=target, args=(r, n, os.path.join(tmp, "store"), outs[r])
                             + tuple(args)) for r in range(n)]
        for p in procs:
            p.start()
        end = time.monotonic() + MESH_DEADLINE_S
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if alive:
            raise SystemExit(f"chip_smoke: {what}: ranks {alive} ran past {MESH_DEADLINE_S} s, "
                             "killed")
        results = []
        for r, p in enumerate(procs):
            if p.exitcode != 0 or not os.path.exists(outs[r]):
                raise SystemExit(f"chip_smoke: {what}: rank {r} failed (exit code {p.exitcode})")
            with open(outs[r], "rb") as f:
                results.append(pickle.load(f))
        return results


def _rank_done(out, result):
    import pickle

    import torch.distributed as dist

    with open(out, "wb") as f:
        pickle.dump(result, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def _gloo_rank(rank, n, store, out):
    """(b) on one rank of two over gloo on the one card: the paired and the
    speech-first step (eager) on this rank's rows, then `TTSServer(mesh=)`
    at MESH_SERVE; the wrappers' launches of each path."""
    import datetime

    import torch.distributed as dist

    from semi_tts_tpu_torch import kernels, use_fp32
    from semi_tts_tpu_torch.ops.features import AudioConfig
    from semi_tts_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from semi_tts_tpu_torch.serve import TTSServer
    from semi_tts_tpu_torch.train.optim import Optimizer

    class Recording(Optimizer):
        def reduce(self, g):
            g = super().reduce(g)
            self.g = g.detach().clone()
            return g

    from semi_tts_tpu_torch.device import resolve_device

    torch.cuda.set_device(0)
    use_fp32()
    dev = resolve_device(None)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    kernels.build_all()  # loads the libraries the parent built
    mesh = make_mesh(n)
    res = {"mesh": dict(mesh.shape), "backend": mesh.backend}
    for kind in (PAIRED, SPEECH_FIRST):
        cfg, phn_attr, model = _mesh_model(dev)
        opt = Recording(model.parameters(), lr=1e-3, lr_scheduler="decay", mesh=mesh)
        step = _make(_mesh_builder(cfg, phn_attr, dev, mesh), kind, opt)
        rows = shard_batch(_mesh_batches(kind, dev), mesh)
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mets = step(model, MESH_STEPS[kind][0], 1.0, *rows)
        torch.cuda.synchronize()
        r = dict(wall_s=time.perf_counter() - t0, launches=kernels.launch_counts(),
                 rows=[list(t.shape) for t in rows], graphs=len(step.programs()),
                 mets={k: float(v) for k, v in mets.items() if v.ndim == 0})
        if kind == SPEECH_FIRST:
            r["unpair_pred"] = mets["unpair_pred"].cpu().numpy()
        if rank == 0:
            r["grads"] = opt.g.cpu().numpy()
        res[kind] = r
        del model, opt, step
    cfg, phn_attr, model = _mesh_model(dev)
    server = TTSServer(cfg, audio_config(), phn_attr.cpu().numpy(), model, mesh=mesh)
    res["serving"] = {"state_digest": state_digest(server.model)}
    for b, u in MESH_SERVE:
        text, sid = serving_inputs(b, u, seed=b)
        kernels.reset_launches()
        t0 = time.perf_counter()
        first = server.synthesize(text, sid, key=21)  # eager, then the capture
        t1 = time.perf_counter()
        wav = server.synthesize(text, sid, key=21)  # a replay
        wall = time.perf_counter() - t1
        counted = kernels.launch_counts()
        # one more replay on every rank (a split request gathers), profiled on rank 0
        again = lambda: server.synthesize(text, sid, key=21)
        seen = profiled_step(again, wall)["kernels_seen"] if rank == 0 else again()
        res["serving"][f"B{b}"] = dict(wav=wav if rank == 0 else wav.shape,
                                       first_wall_s=t1 - t0, wall_s=wall,
                                       repeat_bit_for_bit=bool(np.array_equal(first, wav)),
                                       wrapper_launches=counted,
                                       launches=seen if rank == 0 else None)
    _rank_done(out, res)


def spread_study(model, grads_fn, grads_c, grads_g):
    """The ulp spread that bounds the kinked leaves (`card_spread`) after
    each of MESH_STUDY_DRAWS draws, on each of MESH_STUDY_SEEDS: the
    largest kinked spread and its leaf, and `compare_grads` of the mesh's
    gradients ``grads_g`` under that spread (the leaf nearest its bound,
    its error and bound, whether the check holds)."""
    rows = []
    for seed in MESH_STUDY_SEEDS:
        rep, _ = card_spread(model, grads_fn, grads_c, KINKED_LEAVES,
                             draws=max(MESH_STUDY_DRAWS), seed=seed, at=MESH_STUDY_DRAWS)
        for draws, by_leaf in rep["by_draws"].items():
            top = max((n for n in by_leaf if KINKED_LEAVES.match(n)), key=by_leaf.get)
            c = compare_grads(model, grads_g, grads_c, kinked=KINKED_LEAVES, spread=by_leaf)
            rows.append(dict(seed=seed, draws=draws, top_kinked_leaf=top,
                             top_kinked_spread=by_leaf[top],
                             held_worst_spread=max(v for n, v in by_leaf.items()
                                                   if not KINKED_LEAVES.match(n)),
                             nearest_leaf=c["kinked_nearest_leaf"],
                             nearest_l2_rel_err=c["kinked_nearest_l2_rel_err"],
                             nearest_bound=c["kinked_nearest_bound"], grads_ok=c["grads_ok"]))
    return rows


def mesh_gloo(dev, study=False):
    """(b) Two ranks on the one card over gloo (``--mesh 2x1``, eager
    steps): each step on 4 + 4 rows a rank against the one-process step on
    the 8 rows (the loss within 1e-4 relative; the gradients by
    `compare_grads`' gates beside the card's own spread of
    MESH_SPREAD_DRAWS draws; the speech-first step's one-process twin
    follows the ranks' unpaired argmax, ``tokens=``, and its own argmax
    must agree with theirs on every frame, ``flipped_frames`` 0), and
    `TTSServer(mesh=)` (graphed stages) against the single server on a
    fresh copy of the weights, whose parameters and buffers must equal
    the ranks' bit for bit: a rank's first request (its eager run and
    capture) and a replay equal bit for bit, the replay within 1e-3 of the
    single server for the split request and bit for bit for the B=3 one,
    run whole, beside which the error of a single server on the weights
    that the reference gradient runs left (their BatchNorm statistics
    moved) is reported. ``study``: `spread_study` too."""
    from semi_tts_tpu_torch.graphs import step_seed
    from semi_tts_tpu_torch.serve import TTSServer

    ranks = _mesh_world(2, _gloo_rank, (), "the 2x1 gloo mesh")
    out = {"mesh": ranks[0]["mesh"], "backend": ranks[0]["backend"]}
    cfg, phn_attr, model = _mesh_model(dev)
    builder = _mesh_builder(cfg, phn_attr, dev, None)
    for kind in (PAIRED, SPEECH_FIRST):
        names = PAIRED_STEP_KERNELS + (CYCLE_KERNELS if kind == SPEECH_FIRST else ())
        for r, res in enumerate(ranks):
            idle = [k for k in names if res[kind]["launches"][k] == 0]
            if idle:
                raise SystemExit(f"chip_smoke: rank {r} of the 2x1 mesh launched no {idle} in "
                                 f"its {kind} step")
        batch = _mesh_batches(kind, dev)
        step_no = MESH_STEPS[kind][0]
        tokens = (None if kind == PAIRED else torch.from_numpy(np.concatenate(
            [res[kind]["unpair_pred"] for res in ranks])).to(dev))
        flipped = {}

        def grads_fn(m, tokens=tokens):
            gen = torch.Generator(device=dev).manual_seed(step_seed(0, step_no))
            if kind == PAIRED:
                loss, mets, grads = builder.paired_loss_and_grads(m, *batch, 1.0, gen)
            else:
                loss, mets, grads = builder.speech_first_loss_and_grads(
                    m, step_no, 1.0, batch[:4], batch[4:], gen, tokens=tokens)
                flipped["frames"] = int((mets["unpair_pred"] != tokens).sum())
            return loss, grads

        loss, grads_c = grads_fn(model)
        spread, by_leaf = card_spread(model, lambda m: grads_fn(m)[1], grads_c, KINKED_LEAVES,
                                      draws=MESH_SPREAD_DRAWS)
        g = torch.from_numpy(ranks[0][kind]["grads"]).to(dev)
        grads_g = [None if c is None else v.view_as(c) for v, c in
                   zip(g.split([p.numel() for p in model.parameters()]), grads_c)]
        got = ranks[0][kind]["mets"]["total_loss"]
        res = {"rows_a_rank": ranks[0][kind]["rows"][0][0], "loss_mesh": got,
               "loss_one_process": float(loss),
               "loss_rel_err": abs(got - float(loss)) / abs(float(loss)), "loss_tol_rel": 1e-4,
               "losses_by_rank": [x[kind]["mets"] for x in ranks],
               **compare_grads(model, grads_g, grads_c, kinked=KINKED_LEAVES, spread=by_leaf),
               "card_spread": spread, "wall_s": [x[kind]["wall_s"] for x in ranks],
               "graphs": ranks[0][kind]["graphs"],
               "launches": ranks[0][kind]["launches"]}
        if kind == SPEECH_FIRST:
            res["flipped_frames"] = flipped["frames"]
            if flipped["frames"]:
                raise SystemExit(f"chip_smoke: the one-process speech-first step's unpaired "
                                 f"argmax differs from the 2x1 ranks' at {flipped['frames']} "
                                 "frames")
        res["kinked_spread_top"] = sorted(((n, v) for n, v in by_leaf.items()
                                           if KINKED_LEAVES.match(n)), key=lambda kv: -kv[1])[:5]
        if study:
            res["spread_study"] = spread_study(model, lambda m: grads_fn(m)[1], grads_c, grads_g)
        out[kind] = checked(res, f"2x1 mesh and one-process {kind}")
    _, _, fresh = _mesh_model(dev)
    digests = [x["serving"]["state_digest"] for x in ranks]
    if digests != [state_digest(fresh)] * len(ranks):
        raise SystemExit("chip_smoke: the 2x1 server's weights differ from the single server's")
    single = TTSServer(cfg, audio_config(), phn_attr.cpu().numpy(), fresh)
    moved = TTSServer(cfg, audio_config(), phn_attr.cpu().numpy(), model)
    out["serving"] = {"state_digests_equal": True,
                      "moved_bn_state_equal": state_digest(model) == digests[0]}
    for b, u in MESH_SERVE:
        text, sid = serving_inputs(b, u, seed=b)
        want = single.synthesize(text, sid, key=21)
        got = ranks[0]["serving"][f"B{b}"]
        err = float(np.abs(got["wav"] - want).max())
        idle = [k for k in SERVING_KERNELS for x in ranks
                if x["serving"][f"B{b}"]["wrapper_launches"][k] == 0]
        require_seen(got["launches"], SERVING_KERNELS, f"2x1 mesh B={b} request, rank 0")
        res = dict(batch=b, text_len=u, split=b % 2 == 0, wav_max_abs_err=err, wav_tol=1e-3,
                   bit_for_bit=bool(np.array_equal(got["wav"], want)),
                   shapes=[list(np.shape(got["wav"])), list(ranks[1]["serving"][f"B{b}"]["wav"])],
                   wall_s=[x["serving"][f"B{b}"]["wall_s"] for x in ranks],
                   first_wall_s=[x["serving"][f"B{b}"]["first_wall_s"] for x in ranks],
                   repeat_bit_for_bit=[x["serving"][f"B{b}"]["repeat_bit_for_bit"] for x in ranks],
                   launches=got["launches"], wrapper_launches=got["wrapper_launches"])
        if b % 2:
            res["moved_bn_wav_max_abs_err"] = float(np.abs(
                got["wav"] - moved.synthesize(text, sid, key=21)).max())
        if (err > 1e-3 or idle or got["wav"].shape != want.shape
                or not all(res["repeat_bit_for_bit"]) or (b % 2 and not res["bit_for_bit"])):
            raise SystemExit(f"chip_smoke: the 2x1 server and the single one disagree: {res} "
                             f"(kernels not launched: {idle})")
        out["serving"][f"B{b}"] = res
    return out


def _cli_rank(rank, n, store, out, argv, config):
    """(c) one rank of ``python -m semi_tts_tpu_torch --mesh 2x1`` (its
    `parse` and `run`, the YAML's dict given) in a gloo world made here
    first (the CLI's `init_distributed` then joins nothing: NCCL would
    refuse two ranks on one card), recording the train loaders' item
    batches and the checkpoints it writes."""
    import datetime
    from os.path import basename

    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    from semi_tts_tpu_torch import __main__ as cli
    from semi_tts_tpu_torch.data.loader import TTSLoader
    from semi_tts_tpu_torch.train import solver

    batches, saved = [], []
    sharded, save = TTSLoader._sharded_batches, solver.save_checkpoint

    def record_batches(self):
        for items in sharded(self):
            batches.append((self.num_shards, self.shard_id,
                            [basename(str(p)).split(".")[0] for p, _ in items]))
            yield items

    def record_save(path, **kw):
        saved.append(basename(path))
        return save(path, **kw)

    TTSLoader._sharded_batches, solver.save_checkpoint = record_batches, record_save
    t0 = time.perf_counter()
    code = cli.run(cli.parse(argv), config)
    _rank_done(out, dict(code=code, batches=batches, saved=saved,
                         wall_s=time.perf_counter() - t0))


def _stream(loader, n):
    """The first ``n`` item batches (file ids) of ``loader``'s passes."""
    from os.path import basename

    def passes():
        while True:
            for items in loader._sharded_batches():
                yield [basename(str(p)).split(".")[0] for p, _ in items]
    return list(itertools.islice(passes(), n))


def mesh_cli():
    """(c) ``python -m semi_tts_tpu_torch --mesh 2x1`` on phase 8's
    synthetic corpus in two processes over gloo on the one card: CLI_STEPS
    steps validated every CLI_VALID; the ranks' train batches disjoint and
    together the unsharded loader's, dev the same on both; only rank 0
    writes checkpoints, one of which a single-process `VqvaeSolver` loads."""
    from semi_tts_tpu_torch.data import load_dataset
    from semi_tts_tpu_torch.train.checkpoint import load_checkpoint
    from semi_tts_tpu_torch.train.train_vqvae import VqvaeSolver

    with tempfile.TemporaryDirectory() as root:
        config = cli_config(root)
        argv = ["--config", os.path.join(root, "cli.yaml"), "--name", "mesh", "--logdir",
                os.path.join(root, "log"), "--ckpdir", os.path.join(root, "ckpt"), "--no-msg",
                "--mesh", "2x1"]
        ranks = _mesh_world(2, _cli_rank, (argv, config), "the 2x1 CLI")
        out = {"codes": [r["code"] for r in ranks], "wall_s": [r["wall_s"] for r in ranks],
               "saved_by_rank": [sorted(set(r["saved"])) for r in ranks]}
        corpus = config["data"]["corpus"]
        whole = load_dataset(0, True, False, corpus, config["data"]["audio"], seed=0,
                             device="cpu", shard_id=0, num_shards=1)
        split_of = {}
        with open(corpus["partition_table"]) as f:
            for line in f.read().splitlines()[1:]:
                fid, _, split, _ = line.split(",")
                split_of[fid] = split
        ok = out["codes"] == [0, 0] and bool(ranks[0]["saved"]) and not ranks[1]["saved"]
        for k, split in ((0, "unpaired"), (1, "paired")):
            got = [[b for m, s, b in r["batches"] if m == 2 and split_of[b[0]] == split]
                   for r in ranks]
            m = min(map(len, got))
            full = _stream(whole[k], 2 * m)
            merged = [b for pair in zip(got[0][:m], got[1][:m]) for b in pair]
            out[split] = dict(batches_by_rank=[len(g) for g in got], compared=2 * m,
                              union_is_unsharded=merged == full,
                              disjoint=all(not set(a) & set(b) for a, b in zip(got[0], got[1])))
            ok = ok and m > 0 and merged == full and out[split]["disjoint"]
        dev_batches = [[b for m, _, b in r["batches"] if m == 1] for r in ranks]
        out["dev_unsharded"] = bool(dev_batches[0]) and dev_batches[0] == dev_batches[1]
        ckpt = os.path.join(root, "ckpt", "mesh", sorted(set(ranks[0]["saved"]))[0]
                            if ranks[0]["saved"] else "none")
        solver = VqvaeSolver(config, cli_paras(root, load=ckpt), "train")
        solver.load_data()
        solver.set_model()
        out["loaded"] = dict(file=os.path.basename(ckpt), step=solver.step,
                             ckpt_step=load_checkpoint(ckpt)["global_step"])
        ok = ok and out["dev_unsharded"] and solver.step == out["loaded"]["ckpt_step"]
        if solver.log is not None:
            solver.log.close()
        if not ok:
            raise SystemExit(f"chip_smoke: the 2x1 CLI run failed its checks: {out}")
        del solver
        gc.collect()
    return out


def phase_mesh(card, dev, study=False):
    """Phase 11: meshes. (a) `mesh_captured`, (b) `mesh_gloo` (``study``:
    with `spread_study`), (c) `mesh_cli`."""
    t0 = time.perf_counter()
    captured = mesh_captured(dev)
    t1 = time.perf_counter()
    gloo = mesh_gloo(dev, study)
    t2 = time.perf_counter()
    cli = mesh_cli()
    return dict(card=card, captured_1x1=captured, gloo_2x1=gloo, cli_2x1=cli,
                phase_s={"captured": t1 - t0, "gloo": t2 - t1, "cli": time.perf_counter() - t2})


# ------------------------------------------------------------------ phase 13: long lengths

LONG_TEXT_U = 1500              # the long request's text, and the short one beside it
LONG_TEXT_SHORT = 40
LONG_TEXT_STEPS = 50            # decode steps of the requests held to eager and the CPU
LONG_UNPAIRED_S = 661500        # 30.0 s: the speech-first step's unpaired row
ASR_LONG_S, ASR_LONG_U = LONG_S, 600   # (c): B=2 x 15.28 s, U=600 (S=1,201: a cluster a row)
# (c'): graphed ASR steps at U=1,100 over 30 s (S=2,201) and U=2,100 over 60 s (S=4,201)
ASR_ROUTE_STEPS = ((LONG_UNPAIRED_S, 1100, "u1100"), (2 * LONG_UNPAIRED_S, 2100, "u2100"))
# (B, L, widths, masked) of the split K3 and K9 rows; "L30" is the 30 s step's memory
SPLIT_SHAPES = (("B=1 L=1188", 1, 1188, {}, False), ("B=1 L=1501", 1, 1501, {}, False),
                ("B=2 L30", 2, None, {}, False), ("B=16 L=1500 masked", 16, 1500, {}, True),
                ("B=1 L=8000", 1, 8000, {}, False), ("F=0 B=1 L=2000", 1, 2000, dict(F_=0, K=1), False),
                ("A=1024 F=64 B=1 L=1500", 1, 1500, dict(A=1024, F_=64), False))
K3_SHORT = "B=16 L=32"          # the serving shape: the single-cluster kernel, its time kept
K3_SHORT_MS = 0.0086958         # its recorded time (PERF.md section 6), H100 80GB HBM3, 700 W
K6_LONG_S = (1025, 2049, 4097, 8193)  # K6 past the flagship's S, on the plan's routes
# (S, T, target lengths, input lengths) of K6 past 24,576 states: U = 12,288 labels, rows of
# 600 and 500 over T = 700 (the cluster lattice at 8 states a lane); and past the cluster's
# 49,152, where a chain of clusters takes the row: rows of 100 and 80 labels (one live
# cluster a row), and rows of 5,200 and 10,400 over T = 11,000 whose valid states span two
# and three clusters (9,984 states each), so that both links carry alignable values and the
# row's last cluster adds several clusters' class sums; and (B, S, T) of the chain at B=16,
# past one wave of clusters (rows of all 49,152 labels, which T cannot align, and of 20 to 35)
K6_PAST_CLUSTER = ((24577, 700, (600, 500), (700, 650)), (49153, 120, (100, 80), (120, 110)),
                   (49153, 11000, (5200, 10400), (9000, 11000)))
K6_WAVES = (16, 98305, 64)
B6_LONG = ((14529, 43), (20000, 43), (14528, 8000))  # (T, C) of B6's split route, timed
PHASE13_KERNELS = {"a": ("attention_step_split",) + SERVING_KERNELS,
                   "b": ("attention_step_split", "attention_step_bwd", "trim_merge", "trim_merge_bwd",
                         "trim_merge_tokens", "trim_merge_scan", "trim_merge_means")}
# K6's kernels on each of `ctc_plan`'s routes, by `KERNEL_NAMES`
K6_ROUTE_KERNELS = {"shared": ("ctc_alpha_shared", "ctc_beta_grad_shared"),
                    "cluster": ("ctc_alpha_cluster", "ctc_beta_grad_cluster"),
                    "chain": ("ctc_alpha_chain", "ctc_beta_grad_chain")}


def k6_route(B_, S):
    """The route (`ctc_plan`'s ``lattice``) K6 takes at B_ rows of S states."""
    from semi_tts_tpu_torch.kernels import ctc as k6

    return k6.ctc_plan(B_, 1, S, k6.max_cluster())["lattice"]


def _split_inputs(randn, unif, dev, B_, L, widths, masked):
    """K3's inputs at a split shape (flagship widths unless ``widths``):
    ``masked``: ragged lengths, row 1 of 700 positions (its second chunk
    wholly masked at B=16 L=1,500), row 0 whole; K9's cotangents."""
    w = {**dict(A=256, D=512, C=2, F_=32, K=31), **widths}
    A, D, C, F_, K = w["A"], w["D"], w["C"], w["F_"], w["K"]
    pq, pm, mem = randn(B_, A), randn(B_, L, A, scale=0.5), randn(B_, L, D)
    h = torch.softmax(randn(B_, L), -1)
    hist = torch.stack([h, h + torch.softmax(randn(B_, L), -1)], 1).contiguous()
    lw, ll = (unif(F_, C, K, a=0.3), unif(A, F_, a=0.3)) if F_ else (None, None)
    mask = None
    if masked:
        lengths = 1 + (torch.arange(B_, device=dev) * 397) % L
        lengths[0], lengths[1] = L, 700
        mask = torch.arange(L, device=dev)[None, :] >= lengths[:, None]
    return (pq, pm, mem, hist, lw, ll, unif(A, a=0.1)), mask, (randn(B_, D), randn(B_, L)), w


def _split_cost(B_, L, w, bwd=False):
    """Bytes of one K3 (K9: ``bwd``) call: each input read once, each output
    written once, as `_case_attention` and `_case_attention_bwd` count them."""
    A, D, C, F_, K = w["A"], w["D"], w["C"], w["F_"], w["K"]
    ins = B_ * A + B_ * L * A + B_ * L * D + B_ * C * L + F_ * C * K + A * F_ + A
    return 4 * (2 * ins + 2 * B_ * L + B_ * D) if bwd else 4 * (ins + B_ * D + B_ * L)


def _long_row(name, source, replaces, by, main, tol, library, extra=None):
    """A kernels-line row from per-shape numbers ``by`` (err, ms, plain,
    bound, library, and rel where the check is held per output on its own
    scale, `rel_err`, at ``tol``), the row's own numbers at shape ``main``."""
    err = max(by["err"].values())
    rel = max(by["rel"].values()) if by.get("rel") else None
    row = {"name": name, "route": "cuda", "source": source, "replaces": replaces, "shapes": main,
           "launches": None, "max_abs_err": err, "tol": tol, "ms": by["ms"][main],
           "plain_ms": by["plain"][main], "bound_ms": by["bound"][main][0],
           "bound_by": by["bound"][main][1], "library_ms": by["library"].get(main),
           "library": library, "ms_by_shape": by["ms"], "plain_ms_by_shape": by["plain"],
           "bound_ms_by_shape": {k: b[0] for k, b in by["bound"].items()},
           "library_ms_by_shape": by["library"] or None, "max_abs_err_by_shape": by["err"]}
    if rel is not None:
        row.update(max_rel_err=rel, max_rel_err_by_shape=by["rel"], tol_is="rel")
    row.update(extra or {})
    held = f", max_rel_err {rel:.3e}" if rel is not None else ""
    print(f"kernel {name}: max_abs_err {err:.3e}{held} (tol {tol:.0e})", flush=True)
    return row


def _fatal_unless(ok, what, detail):
    if not ok:
        raise SystemExit(f"chip_smoke: {what}: {detail}")


def long_attention_rows(randn, unif, dev, L30):
    """The split K3 (positions over a cluster's CTAs, the cluster of a row's
    last CTA combining the chunks) and K9 at every shape of `SPLIT_SHAPES`
    (``L30``: the 30 s step's memory): each output held to its plain
    version's on its own scale (`rel_err` at
    1e-4: the weights and K9's per-position gradients are ~1/L) and K3
    rerun bit for bit, timed (graph-replayed) beside its plain version and
    bound; K3 at B=16 L=32 must keep the single-cluster plan, and its time
    is reported beside the recorded one, `K3_SHORT_MS` (``within_3pct``:
    reported, not gated, since a shared host's timing noise and a card's
    power limit move it)."""
    from semi_tts_tpu_torch.kernels import attention as k3

    by3 = {n: {} for n in ("err", "rel", "ms", "plain", "bound", "library", "plan")}
    by9 = {n: {} for n in ("err", "rel", "ms", "plain", "bound", "library", "plan")}
    short, _, _, w = _split_inputs(randn, unif, dev, B, U, {}, False)
    plan = k3.attention_plan(B, U, 256, 512, 2, 32, 31)
    _fatal_unless(plan["chunks"] == 0, "K3 at B=16 L=32 left the single-cluster plan", plan)
    short_ms = device_ms(lambda: k3.attention_step(*short), 200)
    for key, B_, L, widths, masked in SPLIT_SHAPES:
        L = L30 if L is None else L
        key = key.replace("L30", f"L={L}")
        a, mask, cot, w = _split_inputs(randn, unif, dev, B_, L, widths, masked)
        plan = k3.attention_plan(B_, L, w["A"], w["D"], w["C"], w["F_"], w["K"])
        _fatal_unless(plan["chunks"] >= 2, f"K3 at {key} did not split", plan)
        fwd = lambda a=a, m=mask: k3.attention_step(*a, m)
        got, again = fwd(), fwd()
        want = k3.attention_step_plain(*a, mask)
        by3["err"][key], by3["rel"][key] = max_err(got, want), rel_err(got, want)
        _fatal_unless(by3["rel"][key] <= 1e-4 and all(torch.equal(x, y) for x, y in zip(got, again)),
                      f"the split K3 disagrees with its plain version or itself at {key}",
                      [by3["err"][key], by3["rel"][key]])
        by3["ms"][key] = device_ms(fwd, 20)
        by3["plain"][key] = device_ms(lambda a=a, m=mask: k3.attention_step_plain(*a, m), 2)
        by3["bound"][key] = bound(_split_cost(B_, L, w), fwd)
        by3["plan"][key] = {k: plan[k] for k in ("chunk", "chunks", "span", "grid", "smem_bytes",
                                                  "stage_memory", "lin_rows")}
        ctx, wts = got
        bargs = a + (wts, ctx) + cot
        bwd = lambda b=bargs: k3.attention_step_bwd(*b)
        got9, want9 = bwd(), k3.attention_step_bwd_plain(*bargs)
        by9["err"][key], by9["rel"][key] = max_err(got9, want9), rel_err(got9, want9)
        _fatal_unless(by9["rel"][key] <= 1e-4, f"K9 disagrees with its plain version at {key}",
                      [by9["err"][key], by9["rel"][key]])
        by9["ms"][key] = device_ms(bwd, 10)
        by9["plain"][key] = device_ms(lambda b=bargs: k3.attention_step_bwd_plain(*b), 2)
        by9["bound"][key] = bound(_split_cost(B_, L, w, bwd=True), bwd)
        p9 = k3.attention_bwd_plan(B_, L, w["A"], w["D"], w["C"], w["F_"], w["K"])
        by9["plan"][key] = {k: p9[k] for k in ("span", "spans", "grid", "smem_bytes", "stage_lin")}
    main = f"B=2 L={L30}"
    note = ("none: no single PyTorch call computes this function (scaled_dot_product_attention "
            "has no location features, tanh energies or history)")
    k3_row = _long_row("attention_step split", "semi_tts_tpu_torch/csrc/attention.cu",
                       "semi_tts_tpu/models/attention.py:39 (attention_step, in the decoder_apply "
                       "step body, models/decoder.py:227), past L = 1,187 at flagship widths",
                       by3, main, 1e-4, note,
                       {"plans": by3["plan"], "kernels": ["attention_split_kernel"],
                        "short_route": {"shape": K3_SHORT, "ms": short_ms, "recorded_ms": K3_SHORT_MS,
                                        "ratio": short_ms / K3_SHORT_MS,
                                        "within_3pct": abs(short_ms / K3_SHORT_MS - 1) <= 0.03}})
    k9_row = _long_row("attention_step_bwd long", "semi_tts_tpu_torch/csrc/attention.cu",
                       "semi_tts_tpu/models/attention.py:39 (autodiff of attention_step in the "
                       "decoder's training scan, models/decoder.py:227), past L = 1,187",
                       by9, main, 1e-4, NO_LIBRARY, {"plans": by9["plan"]})
    return [k3_row, k9_row]


def _k6_long_inputs(randn, dev, S, B_=2):
    """K6's inputs at S states: labels in 3..42 (repeats possible), row 0 of
    U labels and T = U + U/8 + 32 steps (enough for U labels and their
    repeats), row 1 of U - U/5 labels and input length T - U/8 (ragged)."""
    U = (S - 1) // 2
    T = U + U // 8 + 32
    return _ctc_inputs(randn, dev, B_, T, 43, U, seed=S, tl=(U, U - U // 5),
                       il=(T, T - U // 8))


def long_ctc_rows(randn, dev):
    """K6 at every S of `K6_LONG_S`, of `K6_PAST_CLUSTER` and `K6_WAVES`: ``ctc_alpha``
    held to its plain version at 1e-4 (log-domain alphas and NLL, which grow
    with T) on the shared-memory lattice and bit for bit on the cluster and
    chained lattices (the same operations in the same order),
    ``ctc_beta_grad`` at 1e-4 of its largest value (`rel_err`: the 'mean'
    reduction's g makes it ~1/U) and its rerun bit for bit, timed
    (graph-replayed; the plain versions eagerly, a host loop of T steps)
    beside F.ctc_loss (forward; forward + backward) with the rows' targets
    and with targets of all U labels (``library_ms_full_targets_by_shape``:
    the lattice of 2U + 1 states that K6 runs, where the rows' targets give
    F.ctc_loss 2 max(targets) + 1), rows by route: the shared-memory
    lattice, the cluster lattice (with its time a step and its plan's P, K
    and W at each shape) and the chained lattice (also its clusters Q, its
    waves on the card and each row's live clusters; with targets of all U
    labels held to the plain version too, and two graph replays of both
    kernels bit for bit and equal to the eager calls: the tickets, row
    counts and link flags zeroed for each launch). Fatal unless some
    chained shape has alignable rows (finite NLL) over three live clusters
    (a middle cluster both reads and writes a link, forward and backward)
    and some runs in several waves."""
    from semi_tts_tpu_torch.kernels import ctc as k6

    shapes = [(S, _k6_long_inputs(randn, dev, S)) for S in K6_LONG_S]
    shapes += [(S_, _ctc_inputs(randn, dev, 2, T_, 43, (S_ - 1) // 2, seed=S_, tl=tl_, il=il_))
               for S_, T_, tl_, il_ in K6_PAST_CLUSTER]
    B16, S16, T16 = K6_WAVES
    U16 = (S16 - 1) // 2
    shapes.append((S16, _ctc_inputs(randn, dev, B16, T16, 43, U16, seed=S16,
                                    tl=[U16 if b % 2 == 0 else 20 + b for b in range(B16)],
                                    il=[T16 - b % 3 for b in range(B16)])))
    routes = {"shared": {}, "cluster": {}, "chain": {}}
    for S, a in shapes:
        B_, T, C = a[0].shape
        key = ctc_shape_key(B_, T, C, S)
        plan = k6.ctc_plan(B_, T, S, k6.max_cluster())
        if plan["lattice"] == "chain":  # its waves on this card, each row's live clusters
            plan = dict(plan, waves=-(-B_ * plan["clusters"] // k6.chain_fits(
                plan["chain_warps"], plan["cluster"])), live=[k6.chain_live(t, plan)
                                                             for t in a[3].tolist()])
        by = routes[plan["lattice"]].setdefault("alpha", {n: {} for n in (
            "err", "ms", "plain", "bound", "library", "full", "plan")})
        bb = routes[plan["lattice"]].setdefault("beta", {n: {} for n in (
            "err", "rel", "ms", "plain", "bound", "library", "full", "plan")})
        alphas, nll = k6.ctc_alpha(*a)
        want_a, want_nll = k6.ctc_alpha_plain(*a)
        by["err"][key] = max(max_err(alphas, want_a), max_err(nll, want_nll))
        exact = plan["lattice"] == "shared" or (torch.equal(alphas, want_a)
                                                and torch.equal(nll, want_nll))
        del alphas, want_a
        if plan["lattice"] == "chain":  # each row's NLL finite: an alignment exists
            plan["aligned"] = [bool(x < 1e29) for x in nll.tolist()]
        ba = _ctc_beta_args(a)
        g1, g2, want_g = k6.ctc_beta_grad(*ba), k6.ctc_beta_grad(*ba), k6.ctc_beta_grad_plain(*ba)
        bb["err"][key], bb["rel"][key] = max_err(g1, want_g), rel_err(g1, want_g)
        _fatal_unless(by["err"][key] <= 1e-4 and exact and bb["rel"][key] <= 1e-4
                      and torch.equal(g1, g2),
                      f"K6 disagrees with its plain version or its rerun at {key}",
                      [by["err"][key], exact, bb["err"][key], bb["rel"][key]])
        U = a[1].shape[1]
        full = (a[0], torch.randint(3, C, a[1].shape, device=dev, dtype=torch.int32,
                                    generator=torch.Generator(device=dev).manual_seed(S)),
                a[2], torch.full_like(a[3], U))
        if plan["lattice"] == "chain":
            by.setdefault("checks", {})[key] = _k6_chain_checks(k6, a, full, ba, key)
        for d, kern, plain, cost, backward in ((by, k6.ctc_alpha, k6.ctc_alpha_plain,
                                                _ctc_alpha_cost, False),
                                               (bb, k6.ctc_beta_grad, k6.ctc_beta_grad_plain,
                                                _ctc_beta_cost, True)):
            args = a if d is by else ba
            d["ms"][key] = device_ms(lambda f=kern, x=args: f(*x), 3)
            d["plain"][key] = time_ms(lambda f=plain, x=args: f(*x), 1)
            d["bound"][key] = bound(cost(B_, T, C, S), lambda f=kern, x=args: f(*x))
            d["library"][key] = time_ms(_ctc_library(*a, backward=backward), 3)
            d["full"][key] = time_ms(_ctc_library(*full, backward=backward), 3)
            d["plan"][key] = plan
            d.setdefault("T", {})[key] = T
    rows = []
    for lattice, what in (("shared", "shared lattice"), ("cluster", "cluster lattice"),
                          ("chain", "chained lattice")):
        for part, name, replaces, lib in (
                ("alpha", "ctc_alpha", "semi_tts_tpu/ops/ctc.py:63 (_alpha_pass)",
                 "F.ctc_loss forward, reduction mean (CUDA events, eager)"),
                ("beta", "ctc_beta_grad", "semi_tts_tpu/ops/ctc.py:123 (_ctc_nll_bwd)",
                 "F.ctc_loss forward + backward, reduction mean (CUDA events, eager)")):
            by = routes[lattice].get(part)
            if by is None:  # no shape of this phase takes the route
                continue
            main = next(iter(by["ms"]))
            extra = {"plans": by["plan"], "library_ms_full_targets_by_shape": by["full"],
                     "tol_alphas": 1e-4 if lattice == "shared" else 0.0}
            if lattice != "shared":
                steps = {k: 1e3 * v / by["T"][k] for k, v in by["ms"].items()}
                extra.update(us_per_step=steps[main], us_per_step_by_shape=steps)
            if lattice != "shared":
                pkw = {k: {"P": p["cluster"], "K": p["states_per_lane"], "W": p["chain_warps"],
                           **({"Q": p["clusters"], "waves": p["waves"], "live": p["live"]}
                              if lattice == "chain" else {})} for k, p in by["plan"].items()}
                extra.update(cluster_plan=pkw[main], cluster_plan_by_shape=pkw)
            if lattice == "chain":
                extra.update(checks_by_shape=routes["chain"]["alpha"]["checks"])
                _fatal_unless(any(max(p["live"]) >= 3 and all(p["aligned"])
                                  for p in by["plan"].values())
                              and max(p["waves"] for p in by["plan"].values()) >= 2,
                              "K6's chained shapes left out alignable rows over three live "
                              "clusters or a grid of several waves",
                              {k: dict(v, aligned=by["plan"][k]["aligned"]) for k, v in pkw.items()})
            rows.append(_long_row(f"{name} {what}", "semi_tts_tpu_torch/csrc/ctc.cu",
                                  f"{replaces}, past the flagship's 65 lattice states", by, main,
                                  1e-4, lib, extra))
    return rows


def _k6_chain_checks(k6, a, full, ba, key):
    """The chained route at one shape beyond the rows' own targets: with
    targets of all U labels, its alphas and NLL bit for bit and its gradient
    at 1e-4 of its largest value against the plain versions; and one CUDA
    graph of ``ctc_alpha`` then ``ctc_beta_grad`` replayed twice, each
    replay equal bit for bit to the other and to the eager calls (the
    memsets that zero a launch's ticket counter, row counts and link flags
    replayed with it: a counter not zeroed would hang or change the next).
    Fatal unless all hold."""
    alphas, nll = k6.ctc_alpha(*full)
    want_a, want_nll = k6.ctc_alpha_plain(*full)
    out = {"full_targets_alphas_equal": bool(torch.equal(alphas, want_a) and torch.equal(nll, want_nll))}
    del alphas, want_a  # (T, B, S) each: 4.3 GB at T = 11,000, B=2, S = 49,153
    bf = _ctc_beta_args(full)
    out["full_targets_grad_rel_err"] = rel_err(k6.ctc_beta_grad(*bf), k6.ctc_beta_grad_plain(*bf))
    del bf
    eager = k6.ctc_alpha(*a) + (k6.ctc_beta_grad(*ba),)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k6.ctc_alpha(*a)
        k6.ctc_beta_grad(*ba)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = k6.ctc_alpha(*a) + (k6.ctc_beta_grad(*ba),)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([o.clone() for o in outs])
    del graph
    out["replays_equal"] = all(torch.equal(x, y) and torch.equal(x, e)
                               for x, y, e in zip(replays[0], replays[1], eager))
    _fatal_unless(out["full_targets_alphas_equal"] and out["full_targets_grad_rel_err"] <= 1e-4
                  and out["replays_equal"], f"K6's chained route at {key}", out)
    print(f"K6 chained {key}: {out}", flush=True)
    return out


@contextlib.contextmanager
def b6_split_route(b6):
    """B6's plan forced onto the split route at any T: the row route's
    shared memory denied."""
    real = b6.trim_merge_plan
    b6.trim_merge_plan = lambda T, C, D, **kw: real(T, C, D, **{**kw, "limit": 0})
    try:
        yield
    finally:
        b6.trim_merge_plan = real


def long_trim_rows(randn, dev):
    """B6 and its backward at every (T, C) of `B6_LONG` (B=2, D=64): the
    means within 1e-6 of the plain version, the lengths, slots and counts
    and the backward equal; timed (graph-replayed) beside the plain
    version and the bound. The split route's tokens kernel alone
    (`trim_merge_tokens`) equal to ``torch.argmax`` and timed beside it
    (``tokens``: ms, ``torch.argmax`` ms and the bound by shape). The split
    route forced (`b6_split_route`) at the flagship's `B6_SHAPES`, held to
    the plain version the same way and timed (``split_forced``)."""
    from semi_tts_tpu_torch.kernels import quantize as b6

    by, bb = ({n: {} for n in ("err", "ms", "plain", "bound", "library", "plan")} for _ in range(2))
    tokens = {n: {} for n in ("ms", "torch_argmax_ms", "bound_ms", "equal")}
    for T, C in B6_LONG:
        key = f"B=2 T={T} C={C}"
        p, lat = _trim_merge_inputs(randn, dev, 2, T, C=C)
        got, want = b6.trim_merge(p, lat, 3), b6.trim_merge_plain(p, lat, 3)
        exact = all(torch.equal(x.to(y.dtype), y) for x, y in zip(got[1:], want[1:]))
        by["err"][key] = max_err(got[0], want[0])
        d = randn(2, T, 64)
        bwd = (d, got[2], got[3])
        bb["err"][key] = max_err(b6.trim_merge_bwd(*bwd), b6.trim_merge_bwd_plain(*bwd))
        _fatal_unless(exact and by["err"][key] <= 1e-6 and bb["err"][key] == 0.0,
                      f"B6 disagrees with its plain version at {key}",
                      [exact, by["err"][key], bb["err"][key]])
        for dd, kern, plain, args, cost in (
                (by, b6.trim_merge, b6.trim_merge_plain, (p, lat, 3), _trim_merge_cost(2, T, C, 64)),
                (bb, b6.trim_merge_bwd, b6.trim_merge_bwd_plain, bwd, _trim_merge_bwd_cost(2, T, 64))):
            dd["ms"][key] = device_ms(lambda f=kern, x=args: f(*x), 5)
            dd["plain"][key] = device_ms(lambda f=plain, x=args: f(*x), 2)
            dd["bound"][key] = bound(cost, lambda f=kern, x=args: f(*x))
        by["plan"][key] = b6.trim_merge_plan(T, C, 64)
        bb["plan"][key] = b6.trim_merge_bwd_plan(2, T, 64)
        tokens["equal"][key] = torch.equal(b6.trim_merge_tokens(p).long(), torch.argmax(p, -1))
        _fatal_unless(tokens["equal"][key], f"B6's tokens kernel disagrees with torch.argmax at "
                      f"{key}", tokens["equal"])
        tokens["ms"][key] = device_ms(lambda x=p: b6.trim_merge_tokens(x), 5)
        tokens["torch_argmax_ms"][key] = device_ms(lambda x=p: torch.argmax(x, -1), 5)
        tokens["bound_ms"][key] = 4 * (2 * T * C + 2 * T) / HBM_BYTES_PER_S * 1e3
    forced = {n: {} for n in ("err", "exact", "ms")}
    with b6_split_route(b6):
        for B_, T in B6_SHAPES:
            key = f"B={B_} T={T}"
            p, lat = _trim_merge_inputs(randn, dev, B_, T)
            got, want = b6.trim_merge(p, lat, 3), b6.trim_merge_plain(p, lat, 3)
            forced["exact"][key] = all(torch.equal(x.to(y.dtype), y)
                                       for x, y in zip(got[1:], want[1:]))
            forced["err"][key] = max_err(got[0], want[0])
            _fatal_unless(forced["exact"][key] and forced["err"][key] <= 1e-6,
                          f"B6's split route disagrees with its plain version at {key}", forced)
            forced["ms"][key] = device_ms(lambda x=p, y=lat: b6.trim_merge(x, y, 3), 5)
    main = f"B=2 T={B6_LONG[1][0]} C={B6_LONG[1][1]}"
    print(f"B6 tokens kernel alone: {tokens}; the split route forced: {forced}", flush=True)
    return [_long_row("trim_merge long", "semi_tts_tpu_torch/csrc/quantize.cu",
                      "semi_tts_tpu/ops/quantize.py:26 (trim_merge_segments), the split route",
                      by, main, 1e-6, NO_LIBRARY,
                      {"plans": by["plan"], "tokens": tokens, "split_forced": forced}),
            _long_row("trim_merge_bwd long", "semi_tts_tpu_torch/csrc/quantize.cu",
                      "semi_tts_tpu/ops/quantize.py:26 (the autodiff of trim_merge_segments)",
                      bb, main, 0.0, NO_LIBRARY, {"plans": bb["plan"]})]


def long_text_inputs():
    """Two texts of LONG_TEXT_U tokens: one whole (in 3..42), one of
    LONG_TEXT_SHORT tokens padded with 0."""
    rng = np.random.RandomState(21)
    text = np.zeros((2, LONG_TEXT_U), np.int32)
    text[0] = rng.randint(3, 43, size=LONG_TEXT_U)
    text[1, :LONG_TEXT_SHORT] = rng.randint(3, 43, size=LONG_TEXT_SHORT)
    return text, np.array([3, 77], np.int32)


def long_serving(build_dir):
    """(a) A request of a 1,500-token and a 40-token text at flagship width
    through `TTSServer.from_checkpoint`: at LONG_TEXT_STEPS decode steps
    graphed against eager bit for bit, the split K3 and its combine seen by
    name in a profiled replay, the synthesis and waveform within 1e-3 of
    the CPU plain path on the same checkpoint (`reference_check`); then one
    request at the default decode policy, graphed: its first call (the
    capture), a replay, the capture time, peak memory, a finite waveform."""
    from semi_tts_tpu_torch import kernels
    from semi_tts_tpu_torch.serve import TTSServer

    ckpt = os.path.join(build_dir, "chip_smoke_long_ckpt.pth")
    text, sid = long_text_inputs()
    try:
        write_checkpoint(ckpt, flagship_config())
        server = TTSServer.from_checkpoint(flagship_config(), ckpt)
        kernels.reset_launches()
        t0 = time.perf_counter()
        server.synthesize(text, sid, key=7, decode_steps=LONG_TEXT_STEPS)  # captures
        first = time.perf_counter() - t0
        wrapper = kernels.launch_counts()
        t0 = time.perf_counter()
        wav = server.synthesize(text, sid, key=8, decode_steps=LONG_TEXT_STEPS)
        wall = time.perf_counter() - t0
        want = eager_request(server, text, sid, 8, LONG_TEXT_STEPS)[0].cpu().numpy()
        same = bool(np.array_equal(wav, want))
        _fatal_unless(same and np.isfinite(wav).all(), "the long-text request's graph and its "
                      "eager twin differ", float(np.abs(wav - want).max()))
        prof = profiled_step(lambda: server.synthesize(text, sid, key=9,
                                                       decode_steps=LONG_TEXT_STEPS), wall)
        require_seen(prof["kernels_seen"], PHASE13_KERNELS["a"], "long-text request")
        ref = reference_check(ckpt, text, sid, LONG_TEXT_STEPS)
        steps = server.decode_steps_for(text)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        server.synthesize(text, sid, key=10)
        full_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        full = server.synthesize(text, sid, key=11)
        full_wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        _fatal_unless(np.isfinite(full).all() and np.abs(full).max() > 0,
                      "the default-policy long-text request's waveform", full.shape)
        synth, vocode = server.stages(steps, *text.shape)
        out = dict(text_len=[LONG_TEXT_U, LONG_TEXT_SHORT], decode_steps=LONG_TEXT_STEPS,
                   first_s=first, wall_s=wall, graphed_equals_eager=same,
                   busy_s=prof["device_busy_s"], idle_share=prof["idle_share"],
                   device_events=prof["kernel_launches"],
                   kernels_seen={k: prof["kernels_seen"][k] for k in PHASE13_KERNELS["a"]},
                   wrapper_launches={k: wrapper[k] for k in SERVING_KERNELS}, reference=ref,
                   default_policy={"decode_steps": steps, "samples": int(full.shape[1]),
                                   "first_s": full_first, "wall_s": full_wall,
                                   "capture_s": {"synth": graph_stats(synth)["capture_s"],
                                                 "vocode": graph_stats(vocode)["capture_s"]},
                                   "peak_mem_bytes": peak})
    finally:
        if os.path.exists(ckpt):
            os.remove(ckpt)
    return out


def cycle_setup(dev, cycles=True):
    """A flagship model, its StepBuilder and an optimizer, as `phase_cycles`
    builds them (the cycles' loss weights and frequency loss), or with the
    builder's default weights where not ``cycles`` (the ASR steps)."""
    from semi_tts_tpu_torch.models import vqvae as V
    from semi_tts_tpu_torch.ops.features import AudioFeaturizer
    from semi_tts_tpu_torch.train.optim import Optimizer
    from semi_tts_tpu_torch.train.steps import StepBuilder, Weights
    from semi_tts_tpu_torch.utils.metrics import read_phn_attr

    config = flagship_config()
    cfg = flagship_vqvae_config(config)
    phn_attr = torch.from_numpy(read_phn_attr(config["model"]["codebook"]["phn_attr_pth"])).to(dev)
    model = V.VQVAE(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    kw = dict(weights=Weights(**CYCLE_WEIGHTS), freq_loss_kwargs=FLAGSHIP_FREQ_LOSS) if cycles else {}
    builder = StepBuilder(cfg, AudioFeaturizer(audio_config(), dev), phn_attr, **kw)
    return model, builder, Optimizer(model.parameters(), lr=1e-3, lr_scheduler="decay")


def long_speech_first(dev):
    """(b) The speech-first step with B = 1 + 1 rows, a 3.0 s paired and a
    30.0 s unpaired one, through its CUDA graph: the trimmed latents padded
    to the ASR encoder's length are the attention memory (``memory_len``
    past 1,187: the split K3, and K9 at that L). From one copied state, the
    graph's replay (after its capturing call, the state put back) against
    the same step run eagerly, every metric and state tensor bit for bit;
    a profiled replay (K3 split, K9, B6 and its backward by name); the
    losses, gradient norm and parameters finite."""
    model, builder, opt = cycle_setup(dev)
    pair = training_batch(7, dev, lengths=(TRAIN_S,))
    unpair = training_batch(8, dev, lengths=(LONG_UNPAIRED_S,))
    (mg, og), (me, oe) = copy.deepcopy((model, opt)), copy.deepcopy((model, opt))
    start = [t.detach().clone() for _, t in model_state(mg, og)]
    sg = builder.make_speech_first_step(og)
    sg.capture_at = 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sg(mg, 2, 1.0, *pair, *unpair)  # runs the step eagerly, then captures it
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    with torch.no_grad():
        for (_, t), s0 in zip(model_state(mg, og), start):
            t.copy_(s0)
    t0 = time.perf_counter()
    got = sg(mg, 2, 1.0, *pair, *unpair)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    se = builder.make_speech_first_step(oe)
    t0 = time.perf_counter()
    want = se.eager(me, 2, 1.0, *pair, *unpair)
    torch.cuda.synchronize()
    eager_wall = time.perf_counter() - t0
    differing = [k for k in got if not torch.equal(got[k], want[k])] + [
        n for (n, a), (_, b) in zip(model_state(mg, og), model_state(me, oe)) if not torch.equal(a, b)]
    prof = profiled_step(lambda: sg(mg, 4, 1.0, *pair, *unpair), wall)
    L = got["unpair_pred"].shape[1]
    losses = {k: float(v) for k, v in got.items() if k.endswith("_loss")}
    finite = np.isfinite(list(losses.values()) + [float(got["grad_norm"])]).all() and all(
        bool(torch.isfinite(p).all()) for p in mg.parameters())
    out = dict(samples=[TRAIN_S, LONG_UNPAIRED_S], memory_len=L,
               decode_steps=got["pair_align"].shape[1], losses=losses,
               grad_norm=float(got["grad_norm"]), unpair_ok=bool(got["unpair_ok"]),
               unpair_len=int(got["unpair_pred_len"][0]), first_s=first, wall_s=wall,
               eager_wall_s=eager_wall, busy_s=prof["device_busy_s"],
               idle_share=prof["idle_share"], device_events=prof["kernel_launches"],
               peak_mem_bytes=peak, graphed_equals_eager=not differing, differing=differing[:20],
               **graph_stats(sg.programs()[-1]),
               kernels_seen={k: prof["kernels_seen"][k] for k in PHASE13_KERNELS["b"]})
    _fatal_unless(finite and L > 1187 and not differing, "the 30 s speech-first step", out)
    require_seen(prof["kernels_seen"], PHASE13_KERNELS["b"], "30 s speech-first step")
    del mg, og, me, oe, sg, se, model, opt
    gc.collect()
    return out


def long_asr_batch(dev, seconds, U_, rows):
    """(waves, wave_len, text, sid): ``rows`` utterances of ``seconds``
    samples (the last a fifth shorter where rows > 1), texts of U_ labels
    in 3..42 with no label twice in a row (so T need only hold U_), the
    last row's a fifth shorter."""
    rng = np.random.RandomState(U_)
    lengths = [seconds] * rows
    text = np.zeros((rows, U_), np.int64)
    for b in range(rows):
        n = U_ if b == 0 else U_ - U_ // 5
        text[b, :n] = 3 + np.cumsum(rng.randint(1, 40, size=n)) % 40
        if b:
            lengths[b] = seconds - seconds // 5
    waves = numpy_waves(lengths, seconds, U_)
    return (torch.from_numpy(waves).to(dev), torch.tensor(lengths, dtype=torch.int32, device=dev),
            torch.from_numpy(text).to(dev),
            torch.from_numpy(rng.randint(0, 109, rows)).to(dev))


def long_asr(dev):
    """(c) `AsrTrainer` at B=2 x 15.28 s and U=600 (S=1,201, CTC T=680): one
    capturing and two replayed steps (losses and gradient norms finite), a
    profiled replay (the kernels of K6's route at that S, by name), and one
    step on the card against the CPU plain path on the same weights
    (dropout 0, the same augmentation), held to phase 5's gates; then
    graphed steps at B=1 x 30 s, U=1,100 (S=2,201) and B=1 x 60 s, U=2,100
    (S=4,201), each K6 route seen by name in a profiled replay, losses
    finite."""
    from semi_tts_tpu_torch.train.train_asr import AsrTrainer

    model, builder, opt = cycle_setup(dev, cycles=False)
    out = {}
    for name, seconds, U_, rows in (("c", ASR_LONG_S, ASR_LONG_U, 2),
                                    *((r, s, u, 1) for s, u, r in ASR_ROUTE_STEPS)):
        batch = long_asr_batch(dev, seconds, U_, rows)
        logged, marks = [], []

        def batches(batch=batch, marks=marks):
            for _ in range(3):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                yield batch

        trainer = AsrTrainer(model, builder, opt, pair_iter=batches(), dev_set=[batch],
                             max_step=3, valid_step=10 ** 9, progress_step=1,
                             log=lambda *a, logged=logged: logged.append(a))
        capture_first(trainer)
        trainer.exec()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        walls = [b - a for a, b in zip(marks, marks[1:])]
        losses = [v for _, n, v in logged if n in ("txt_loss/pair", "grad_norm")]
        _fatal_unless(len(losses) == 6 and np.isfinite(losses).all(),
                      f"the long ASR step ({name}) went non-finite", losses)
        prof = profiled_step(lambda t=trainer, b=batch: t._train_step(b), float(np.median(walls[1:])),
                             picked=K6_KERNELS)
        route = k6_route(rows, 2 * U_ + 1)
        require_seen(prof["kernels_seen"], K6_ROUTE_KERNELS[route], f"long ASR step ({name})")
        out[name] = dict(samples=seconds, rows=rows, text_len=U_, S=2 * U_ + 1, k6_route=route,
                         first_s=walls[0], wall_s=float(np.median(walls[1:])), losses=losses,
                         busy_s=prof["device_busy_s"], idle_share=prof["idle_share"],
                         device_events=prof["kernel_launches"], k6_ms=prof["picked_ms"],
                         kernels_seen={k: prof["kernels_seen"][k] for k in K6_ROUTE_KERNELS[route]},
                         graphs=step_graphs(trainer._step_fn))
        del trainer
    out["c"]["reference"] = training_reference(
        model, builder.cfg, builder.phn_attr, dev, seed=12, what="long ASR steps",
        batch=lambda device: long_asr_batch(device, ASR_LONG_S, ASR_LONG_U, 2))
    return out


# widths a JAX config may give that the cluster's 8 does not divide: the
# decoder's attention (attn_dim) and memory (enc_embed_dim) widths; K3 and K9
# at the paired step's shape, the speech-first step's and a split-route one
ODD_WIDTHS = {"attn_dim": 100, "enc_embed_dim": 36}
ODD_SHAPES = (("B=8 L=32", 8, 32), ("B=16 L=133 masked", 16, 133), ("B=2 L=5000 split", 2, 5000))


def phase_widths(dev):
    """K3 and K9 at the widths of `ODD_WIDTHS` (CTA r of a row's cluster
    ceil(A/8) and ceil(D/8) columns, cut at A and D) at every shape of
    `ODD_SHAPES`, held to their plain versions (each output at 1e-4 of its
    largest value) and timed; then one paired step of a flagship model with
    those widths on the card against the CPU plain path (phase 3's gates,
    `paired_reference`), with the K3 and K9 launches of one card step: one
    each a decode step, as at the flagship's widths (no pad or slice around
    them). Returns the ``widths`` line."""
    from semi_tts_tpu_torch import kernels
    from semi_tts_tpu_torch.device import use_deterministic
    from semi_tts_tpu_torch.kernels import attention as k3
    from semi_tts_tpu_torch.models import vqvae as V
    from semi_tts_tpu_torch.ops.features import AudioFeaturizer
    from semi_tts_tpu_torch.train.steps import StepBuilder
    from semi_tts_tpu_torch.utils.metrics import read_phn_attr

    use_deterministic()  # as the step makers do: the card's rerun must repeat bit for bit
    g = torch.Generator(device=dev).manual_seed(31)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def unif(*shape, a):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * a

    A, D = ODD_WIDTHS["attn_dim"], ODD_WIDTHS["enc_embed_dim"]
    out = {"A": A, "D": D, "kernels": {}}
    with torch.no_grad():
        for name, B_, L in ODD_SHAPES:
            a, mask, (gc, gw), _ = _split_inputs(randn, unif, dev, B_, L, dict(A=A, D=D), B_ == 16)
            ctx, w = k3.attention_step(*a, mask)
            ba = a + (w, ctx, gc, gw)
            wd = dict(A=A, D=D, C=2, F_=32, K=31)
            b3 = bound(_split_cost(B_, L, wd), lambda: k3.attention_step(*a, mask))
            b9 = bound(_split_cost(B_, L, wd, bwd=True), lambda: k3.attention_step_bwd(*ba))
            row = {"k3_rel_err": rel_err((ctx, w), k3.attention_step_plain(*a, mask)),
                   "k9_rel_err": rel_err(k3.attention_step_bwd(*ba), k3.attention_step_bwd_plain(*ba)),
                   "k3_ms": device_ms(lambda: k3.attention_step(*a, mask), 20),
                   "k9_ms": device_ms(lambda: k3.attention_step_bwd(*ba), 20),
                   "k3_plain_ms": device_ms(lambda: k3.attention_step_plain(*a, mask), 5),
                   "k9_plain_ms": device_ms(lambda: k3.attention_step_bwd_plain(*ba), 5),
                   "k3_bound_ms": b3[0], "k3_bound_by": b3[1], "k9_bound_ms": b9[0],
                   "k9_bound_by": b9[1],
                   "k3_plan": {k: v for k, v in k3.attention_plan(B_, L, A, D, 2, 32, 31).items()
                               if k in ("a_per_cta", "d_per_cta", "chunks", "span", "grid")}}
            _fatal_unless(row["k3_rel_err"] <= 1e-4 and row["k9_rel_err"] <= 1e-4,
                          f"K3/K9 at A={A} D={D} {name} disagree with their plain versions", row)
            out["kernels"][name] = row
            print(f"kernels at A={A} D={D} {name}: {row}", flush=True)
    config = flagship_config()
    config["model"]["decoder"]["decoder"]["attn_dim"] = A
    config["model"]["decoder"]["encoder"]["enc_embed_dim"] = D
    cfg = flagship_vqvae_config(config)
    phn_attr = torch.from_numpy(read_phn_attr(config["model"]["codebook"]["phn_attr_pth"])).to(dev)
    model = V.VQVAE(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    builder = StepBuilder(no_dropout(cfg), AudioFeaturizer(audio_config(), dev), phn_attr,
                          freq_loss_kwargs=FLAGSHIP_FREQ_LOSS)
    kernels.reset_launches()
    builder.paired_loss_and_grads(model, *training_batch(0, dev), 1.0,
                                  torch.Generator(device=dev).manual_seed(5))
    seen = kernels.launch_counts()
    out["launches_one_step"] = {k: seen[k] for k in ("attention_step", "attention_step_bwd")}
    _fatal_unless(seen["attention_step"] == seen["attention_step_bwd"] == PAIRED_T // 3,
                  f"the paired step at A={A} D={D} launches K3/K9 other than once a decode step",
                  out["launches_one_step"])
    out["paired_reference"] = paired_reference(model, cfg, phn_attr, dev)
    return out


def phase_long(card, dev):
    """Phase 13: the attention step, CTC and trim/merge at lengths past
    their shared-memory plans. (b) first (its memory length sets a K3/K9
    shape), then (a) and (c), then the kernels' rows. Returns (rows, line)."""
    from semi_tts_tpu_torch.kernels.build import BUILD_DIR

    t0 = time.perf_counter()
    speech = long_speech_first(dev)
    serving = long_serving(str(BUILD_DIR))
    asr = long_asr(dev)
    g = torch.Generator(device=dev).manual_seed(23)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def unif(*shape, a):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * a

    with torch.no_grad():
        rows = (long_attention_rows(randn, unif, dev, speech["memory_len"])
                + long_ctc_rows(randn, dev) + long_trim_rows(randn, dev))
    seen = {"attention_step split": serving["kernels_seen"]["attention_step_split"],
            "attention_step_bwd long": speech["kernels_seen"]["attention_step_bwd"]}
    per = {"attention_step split": "long-text request (a), 50 decode steps",
           "attention_step_bwd long": "30 s speech-first step (b)"}
    lattice = {"shared": "shared lattice", "cluster": "cluster lattice",
               "chain": "chained lattice"}
    for step, a in asr.items():  # K6's launches in the ASR steps, by route
        alpha, beta = K6_ROUTE_KERNELS[a["k6_route"]][:2]
        for name, k in (("ctc_alpha", alpha), ("ctc_beta_grad", beta)):
            row = f"{name} {lattice[a['k6_route']]}"
            seen[row] = seen.get(row, 0) + a["kernels_seen"][k]
            at = f"({step}) U={a['text_len']:,}"
            per[row] = f"{per[row]}, {at}" if row in per else f"ASR steps {at}"
    for route in lattice.values():
        for name in ("ctc_alpha", "ctc_beta_grad"):
            per.setdefault(f"{name} {route}", "no driven path: a row of more than 24,575 labels; "
                                              "checked and timed at its shape")
    for row in rows:
        row["launches"] = seen.get(row["name"], 0)
        row["launches_per"] = per.get(row["name"], "no driven path: T past 14,528 frames is "
                                      "~328 s of audio; checked and timed at its shapes")
    line = dict(card=card, wall_s=time.perf_counter() - t0, serving=serving,
                speech_first=speech, asr=asr)
    return rows, line


def main(argv=None):
    """Every phase; ``--mesh-study``: the kernels' build and phase 11 alone,
    with `spread_study`; ``--wide``: the build and phase 12 alone;
    ``--long``: the build and phase 13 alone."""
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--mesh-study"], ["--wide"], ["--long"]):
        raise SystemExit("usage: chip_smoke.py [--mesh-study | --wide | --long]")
    card = phase_device()
    from semi_tts_tpu_torch import kernels, use_fp32
    from semi_tts_tpu_torch.kernels.build import BUILD_DIR, LOGS

    use_fp32()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, {BUILD_DIR})", flush=True)
    if argv == ["--mesh-study"]:
        print(json.dumps({"mesh": phase_mesh(card, dev, study=True)}))
        return 0
    if argv == ["--wide"]:
        rows, wide = phase_wide(card, dev)
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"wide": wide}))
        return 0
    if argv == ["--long"]:
        widths = phase_widths(dev)
        rows, long = phase_long(card, dev)
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"widths": widths}))
        print(json.dumps({"long": long}))
        if UNSEEN:
            raise SystemExit(f"chip_smoke: kernels not seen in profiled replays: {UNSEEN}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    print(json.dumps({"ptxas": ptxas_report("".join(LOGS.get(n, "") for n in (
        "rnn", "rnn_wide", "attention", "ctc", "quantize")))}), flush=True)
    seen_shapes = record_recurrence_shapes()
    table = phase_kernels(dev)
    print(json.dumps({"asr_shape": asr_lstm_check(dev)}), flush=True)
    print(json.dumps({"featurizer": featurizer_line(dev)}), flush=True)
    serving = phase_serving(str(BUILD_DIR))
    training = phase_training(dev)
    paired = phase_paired(dev)
    cycles = phase_cycles(dev)
    with tempfile.TemporaryDirectory() as keep:
        asr_ckpt, specs = os.path.join(keep, "cli_vqvae.pth"), os.path.join(keep, "specs")
        cli = phase_cli({"paired": paired["wall_s"], **cycles["wall_s"]}, asr_ckpt, specs)
        print(json.dumps({"host_decoder": dict(cli["native_decoder"], card=card,
                                               steady_step_wall_s=cli["steady_step_wall_s"])}),
              flush=True)
        pretrain = phase_pretrain(card, asr_ckpt)
        tools = phase_tools(specs, dev)
    mesh = phase_mesh(card, dev)
    time_seen_shapes(table, dev, seen_shapes)
    wide_rows, wide = phase_wide(card, dev)
    table += wide_rows
    launches = {"serving request": serving["launches"], "ASR train step": training["launches"],
                "paired train step": paired["launches"],
                "speech-first step": cycles["launches"][SPEECH_FIRST],
                "text-first step": cycles["launches"][TEXT_FIRST],
                "CLI training": cli["launches"]["train"],
                "CLI validation": cli["launches"]["validation"],
                "CLI gen_specgram": cli["launches"]["gen_specgram"],
                "eval step": cli["programs"]["eval"]["launches"],
                "featurize": cli["programs"]["featurize"]["launches"],
                "text LM step": pretrain["text"]["launches"],
                "speech LM step": pretrain["speech"]["launches"],
                "text LM dev loss": pretrain["text"]["dev"]["launches"],
                "speech LM dev loss": pretrain["speech"]["dev"]["launches"],
                "Griffin-Lim": tools["griffin_lim"]["launches"],
                "imported-checkpoint serving": tools["import"]["launches"],
                "gen_wav": tools["gen_wav"]["launches_per_batch"],
                "mesh 1x1 paired step": mesh["captured_1x1"][PAIRED]["launches"],
                "mesh 1x1 speech-first step": mesh["captured_1x1"][SPEECH_FIRST]["launches"],
                "mesh 2x1 paired step, a rank": mesh["gloo_2x1"][PAIRED]["launches"],
                "mesh 2x1 speech-first step, a rank": mesh["gloo_2x1"][SPEECH_FIRST]["launches"],
                "mesh 2x1 serving request, a rank": mesh["gloo_2x1"]["serving"]["B16"]["launches"],
                "RNNLM-LSTM step": wide["rnnlm_lstm"]["launches"],
                "RNNLM-GRU step": wide["rnnlm_gru"]["launches"],
                "ASR train step at rnn_dim 512": wide["asr_512"]["launches"]}
    for row in table:
        per = ("serving request" if row["name"] in SERVING_KERNELS else
               "ASR train step" if row["name"] in TRAINING_KERNELS else
               "speech-first step" if row["name"] in CYCLE_KERNELS else
               "RNNLM-LSTM step" if row["name"].startswith("lstm_rec") else
               "RNNLM-GRU step" if row["name"].startswith("gru_rec") else "paired train step")
        row["launches"] = launches[per][row["name"]]
        row["launches_per"] = per
        row["launches_by_path"] = {k: v[row["name"]] for k, v in launches.items()}
    widths = phase_widths(dev)
    for row in table:  # K3's and K9's rows carry the widths' checks
        if row["name"] in ("attention_step", "attention_step_bwd"):
            pre = "k3" if row["name"] == "attention_step" else "k9"
            row["odd_widths"] = {k: {n: v for n, v in r.items() if n.startswith(pre)}
                                 for k, r in widths["kernels"].items()}
    long_rows, long = phase_long(card, dev)
    table += long_rows
    print(json.dumps({"kernels": table}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    print(json.dumps({"paired": paired}))
    print(json.dumps({"cycles": cycles}))
    print(json.dumps({"cli": cli}))
    print(json.dumps({"pretrain": pretrain}))
    print(json.dumps({"tools": dict(tools, card=card)}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"wide": wide}))
    print(json.dumps({"widths": widths}))
    print(json.dumps({"long": long}))
    print(json.dumps({"flops": flops_line(card, {
        "serving request": (serving["flops"], serving["wall_s"]),
        "ASR train step": (training["graph_check"]["flops"], training["wall_s"]),
        "paired train step": (paired["graph_check"]["flops"], paired["wall_s"]),
        **{f"{k} step": (cycles["graph_check"][k]["flops"], cycles["wall_s"][k])
           for k in (SPEECH_FIRST, TEXT_FIRST)},
        "eval step": (cli["programs"]["eval"]["flops"], cli["programs"]["eval"]["wall_s"]),
        **{f"{k} LM step": (pretrain[k]["graph_check"]["flops"], pretrain[k]["wall_s"])
           for k in ("text", "speech")},
        "(a) RNNLM-LSTM step": (wide["rnnlm_lstm"]["graph_check"]["flops"],
                                wide["rnnlm_lstm"]["wall_s"]),
        "(b) RNNLM-GRU step": (wide["rnnlm_gru"]["graph_check"]["flops"],
                               wide["rnnlm_gru"]["wall_s"]),
        "(c) ASR train step at rnn_dim 512": (wide["asr_512"]["graph_check"]["flops"],
                                              wide["asr_512"]["wall_s"])})}))
    if UNSEEN:
        raise SystemExit(f"chip_smoke: kernels not seen in profiled replays: {UNSEEN}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
