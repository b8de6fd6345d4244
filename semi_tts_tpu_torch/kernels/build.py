"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface
(no PyTorch headers: ``nvcc`` takes seconds instead of minutes), loaded with
``ctypes``. Libraries are built at first use into ``kernels/_build/``, named
by a hash of their source so an edited source is rebuilt, and written
through a temporary file so concurrent processes never load a half-written
library. `build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SOURCES = ("rnn", "rnn_wide", "attention", "griffin_lim", "features", "ctc", "quantize")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SMEM_PER_BLOCK = 232_448    # H100: dynamic shared memory a block may use
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
LOGS: dict = {}  # nvcc's output (ptxas registers, spills) of each source built here


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp, target) or None
    when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    LOGS[name] = out
    os.replace(tmp, target)


def build_all() -> None:
    """Build every source in parallel (one ``nvcc`` each) and load them."""
    with _lock:
        started = {n: _start(n) for n in SOURCES if n not in _libs}
        for name, st in started.items():
            _finish(name, st)
    for name in SOURCES:
        load(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def bind(name: str, fn: str, n_ptrs: int, n_ints: int, floats: int = 0):
    """A C entry point ``int fn(ptr * n_ptrs, int * n_ints, float * floats,
    stream)`` with its ``argtypes`` declared (pointers and the stream as
    ``c_void_p``, so ctypes does not cut them to 32 bits)."""
    f = getattr(load(name), fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                  + [ctypes.c_float] * floats + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError {err}")


def require(t, shape, what: str) -> None:
    """Validate a kernel operand: CUDA, float32, contiguous, exact shape."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def require_int(t, shape, what: str) -> None:
    """Validate an index operand: CUDA, int32, contiguous, exact shape."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{what}: expected int32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream
