"""Hand-written CUDA kernels for Hopper (``csrc/``), bound with ctypes.

Every wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain PyTorch version only for CPU tensors; each counts its launches in an
integer attribute ``launches``. `WRAPPERS` lists the wrappers that the
serving path calls.
"""

from .attention import attention_step
from .build import build_all
from .griffin_lim import gl_ola_frame, gl_project
from .rnn import bigru_rec, bilstm_rec, gru_rec, lstm_rec

WRAPPERS = (bilstm_rec, bigru_rec, attention_step, gl_project, gl_ola_frame)


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}


__all__ = ["WRAPPERS", "attention_step", "bigru_rec", "bilstm_rec", "build_all",
           "gl_ola_frame", "gl_project", "gru_rec", "launch_counts", "lstm_rec",
           "reset_launches"]
