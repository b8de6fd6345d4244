"""The port's CLI (counterpart of the JAX package's ``main.py``):

    python -m semi_tts_tpu_torch --config config/semi-multi-spkr-paired-data.yaml [flags]

A YAML config and flags pick a solver, which then runs ``load_data ->
set_model -> exec``: the semi-supervised trainer by default,
``--asr-only``, ``--gen-specgram`` (with ``--gen-wav``),
``--gen-gt-specgram``, ``--asr-decode``, or the language-model
pretraining of ``--pretrain-speech`` (``best_mel.pth``) and
``--pretrain-text`` (``best_acc.pth``). It runs on the card unless
``--cpu`` is given. Reading the YAML needs PyYAML. ``--profile`` traces a
window of training steps with `torch.profiler` into the run's log
directory (``<logdir>/<name>/*.pt.trace.json``).

``--mesh DxM`` runs the solver as one rank of a world of ``D*M``
processes over `torch.distributed` (`semi_tts_tpu_torch.parallel`): the
batch split over D data ranks, the wide weights' optimizer state split
over M model ranks. Start the processes with ``torchrun --nproc-per-node
N -m semi_tts_tpu_torch --mesh DxM ...``, or set ``SEMI_TTS_NUM_PROCESSES``,
``SEMI_TTS_PROCESS_ID`` and ``SEMI_TTS_COORDINATOR`` in each; the world
is joined before the first device query (NCCL on the cards, gloo with
``--cpu``).
"""

from __future__ import annotations

import argparse
import random
import sys

import numpy as np


def parser():
    p = argparse.ArgumentParser(
        prog="python -m semi_tts_tpu_torch",
        description="Semi-supervised TTS/ASR training and inference on an NVIDIA card.")
    p.add_argument("--config", type=str, help="Experiment YAML to run.")
    p.add_argument("--name", default=None, type=str,
                   help="Experiment name (defaults to <config>-sd<seed>).")
    p.add_argument("--logdir", default="log/", type=str, help="Directory for TensorBoard logs.")
    p.add_argument("--ckpdir", default="ckpt/", type=str,
                   help="Directory for checkpoints and generated outputs.")
    p.add_argument("--load", default=None, type=str,
                   help="Checkpoint to restore and resume from.")
    p.add_argument("--seed", default=0, type=int, help="Global RNG seed.")
    p.add_argument("--njobs", default=5, type=int, help="Accepted; one thread a loader decodes.")
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU (the kernels' plain versions) instead of the card.")
    p.add_argument("--debug", action="store_true", help="Enable debug-mode behavior.")
    p.add_argument("--no-pin", action="store_true", help="Accepted; batches stay on the host.")
    p.add_argument("--asr-decode", action="store_true",
                   help="Greedy-decode the ASR branch on the test split.")
    p.add_argument("--gen-specgram", action="store_true",
                   help="Run TTS inference and dump mel/linear spectrograms.")
    p.add_argument("--gen-gt-specgram", action="store_true",
                   help="Dump ground-truth features for the test split.")
    p.add_argument("--no-msg", action="store_true", help="Silence all stdout messages.")
    p.add_argument("--actual-len", action="store_true",
                   help="Use true (unpadded) frame counts as CTC input lengths.")
    p.add_argument("--store-best-per", action="store_true",
                   help="Checkpoint only when dev PER improves.")
    p.add_argument("--asr-only", action="store_true", help="Train just the supervised ASR branch.")
    p.add_argument("--gen-wav", action="store_true",
                   help="Also vocode generated spectrograms with Griffin-Lim.")
    p.add_argument("--pretrain-speech", action="store_true",
                   help="Pretrain the audio LM (TTS decoder + postnet) -> best_mel.pth.")
    p.add_argument("--pretrain-text", action="store_true",
                   help="Pretrain the text LM (codebook table) -> best_acc.pth.")
    p.add_argument("--profile", action="store_true",
                   help="Trace a window of training steps with torch.profiler into the "
                        "run's log directory.")
    p.add_argument("--mesh", default="", type=str,
                   help="Run over a DATAxMODEL mesh of processes, e.g. 4x2 (data-parallel x "
                        "model-split optimizer state); applies to training and the inference "
                        "solvers. Needs DATA*MODEL processes (torchrun, or SEMI_TTS_NUM_"
                        "PROCESSES). Default: one process.")
    p.add_argument("--compile-cache", default="", type=str,
                   help="Accepted for the JAX CLI's sake; means nothing here (no XLA cache).")
    p.add_argument("--matmul-precision", default="default",
                   choices=["default", "high", "highest"],
                   help="Accepted for the JAX CLI's sake; means nothing here: the port "
                        "computes in float32 with TF32 off (device.use_fp32).")
    return p


def solver_class(paras):
    """(solver class, mode) of the flags, as the JAX CLI dispatches."""
    if paras.asr_decode:
        from .train.asr_decode import VqvaeDecoder
        return VqvaeDecoder, "test"
    if paras.gen_specgram:
        from .train.gen_specgram import SpecgramGenerator
        return SpecgramGenerator, "test"
    if paras.gen_gt_specgram:
        from .train.gen_gt_specgram import SpecgramGenerator
        return SpecgramGenerator, "test"
    if paras.asr_only:
        from .train.train_asr import AsrSolver
        return AsrSolver, "train"
    if paras.pretrain_speech:
        from .train.train_lm import AudioLmSolver
        return AudioLmSolver, "train"
    if paras.pretrain_text:
        from .train.train_lm import TextLmSolver
        return TextLmSolver, "train"
    from .train.train_vqvae import VqvaeSolver
    return VqvaeSolver, "train"


def parse(argv=None, p=None):
    """The flags of ``argv`` with the fields the solvers read (``gpu``,
    ``pin_memory``, ``verbose``), after joining this process's world
    (`init_distributed`, before any device query) and checking ``--mesh``
    against it; a bad flag exits through ``p.error``."""
    p = p or parser()
    paras = p.parse_args(argv)
    # join the world before the first device query (each rank's card is pinned here)
    from .parallel.mesh import init_distributed, mesh_shape

    init_distributed(cpu=paras.cpu)
    if paras.mesh:
        try:
            mesh_shape(paras.mesh)
        except SystemExit as e:
            p.error(str(e))
    paras.gpu = not paras.cpu
    paras.pin_memory = not paras.no_pin
    paras.verbose = not paras.no_msg
    return paras


def run(paras, config):
    """The solver of the flags on ``config`` (the YAML's dict): ``load_data
    -> set_model -> exec``."""
    random.seed(paras.seed)
    np.random.seed(paras.seed)
    cls, mode = solver_class(paras)
    solver = cls(config, paras, mode)
    solver.load_data()
    solver.set_model()
    solver.exec()
    return 0


def main(argv=None):
    p = parser()
    paras = parse(argv, p)
    if not paras.config:
        p.error("--config is required (path to an experiment YAML, e.g. config/supervised.yaml)")
    try:
        import yaml
    except ImportError:
        p.error("reading the --config YAML needs PyYAML, which is not installed")
    try:
        with open(paras.config) as f:
            config = yaml.load(f, Loader=yaml.FullLoader)
    except FileNotFoundError:
        p.error(f"config file not found: {paras.config}")
    return run(paras, config)


if __name__ == "__main__":
    sys.exit(main())
