"""Hand-written CUDA kernels for Hopper (``csrc/``), bound with ctypes.

Every wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain PyTorch version only for CPU tensors; each counts its launches in an
integer attribute ``launches``. `SERVING` lists the wrappers that the
text->wav serving path calls, `TRAINING` those that the ASR train step
adds (`validate_asr` calls `stft_frames`, `spec_db` and `bilstm_rec`),
`PAIRED` the backward kernels that the paired train step adds to both,
`CYCLES` those that the unpaired speech-first step adds to the paired
step's, `WIDE` the wide routes of the recurrences (K1w, K7w, K2w, K8w),
which the recurrence wrappers launch past their narrow plans (RNNLM at its
default 512 units, an ASR of ``rnn_dim`` 512), and `WRAPPERS` all of them.
"""

from .attention import attention_step, attention_step_bwd
from .build import build_all
from .ctc import ctc_alpha, ctc_beta_grad
from .features import spec_db, stft_frames
from .griffin_lim import gl_ola_frame, gl_project
from .quantize import trim_merge, trim_merge_bwd
from .rnn import (bigru_rec, bigru_rec_bwd, bilstm_rec, bilstm_rec_bwd, bilstm_rec_cs, gru_rec,
                  gru_rec_bwd_wide, gru_rec_wide, lstm_rec, lstm_rec_bwd_wide, lstm_rec_wide)

SERVING = (bilstm_rec, bigru_rec, attention_step, gl_project, gl_ola_frame)
TRAINING = (stft_frames, spec_db, bilstm_rec_cs, bilstm_rec_bwd, ctc_alpha, ctc_beta_grad)
PAIRED = (bigru_rec_bwd, attention_step_bwd)
CYCLES = (trim_merge, trim_merge_bwd)
WIDE = (lstm_rec_wide, lstm_rec_bwd_wide, gru_rec_wide, gru_rec_bwd_wide)
WRAPPERS = SERVING + TRAINING + PAIRED + CYCLES + WIDE


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}


__all__ = ["CYCLES", "PAIRED", "SERVING", "TRAINING", "WIDE", "WRAPPERS", "attention_step",
           "attention_step_bwd", "bigru_rec", "bigru_rec_bwd", "bilstm_rec", "bilstm_rec_bwd",
           "bilstm_rec_cs", "build_all", "ctc_alpha", "ctc_beta_grad", "gl_ola_frame",
           "gl_project", "gru_rec", "gru_rec_bwd_wide", "gru_rec_wide", "launch_counts",
           "lstm_rec", "lstm_rec_bwd_wide", "lstm_rec_wide", "reset_launches", "spec_db",
           "stft_frames", "trim_merge", "trim_merge_bwd"]
