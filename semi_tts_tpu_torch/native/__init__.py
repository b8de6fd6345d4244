"""The port's host-side native code (``native.cc``), loaded with ctypes:
a threaded batch decoder of WAV files (`wav_read_batch`) and the edit
distance of two token sequences (`edit_distance`).

``native.cc`` is built with ``g++`` at first use into
``semi_tts_tpu_torch/kernels/_build/``, named by a hash of the source and
the flags, and written through a temporary file that is renamed into
place, so processes that build at once never load a half-written library.
A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "native.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "kernels" / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None


def target() -> Path:
    """The built library's path for the current source and flags."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libnative_{digest}.so"


def build() -> Path:
    """Compile ``native.cc`` unless its library exists; returns its path."""
    out = target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building {SRC.name} needs g++: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library with its argument types declared, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(str(build()))
            L.stt_wav_read.restype = ctypes.c_long
            L.stt_wav_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_long, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            L.stt_wav_read_batch.restype = ctypes.c_int
            L.stt_wav_read_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ctypes.c_long, ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_int]
            L.stt_edit_distance.restype = ctypes.c_long
            L.stt_edit_distance.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
                                            ctypes.POINTER(ctypes.c_int32), ctypes.c_long]
            _lib = L
        return _lib


def wav_read_batch(paths, capacity: int, channel: int = 0, n_threads: int = 4):
    """Decode channel ``channel`` of each WAV file of ``paths`` into a fresh
    (B, capacity) float32 array, ``n_threads`` files at a time. Returns
    (array, lengths (B,) int64, sample rates (B,) int32); a row whose file
    the decoder cannot read (missing, malformed, or a format it does not
    decode) has length -1, and a file longer than ``capacity`` samples is
    cut there."""
    B = len(paths)
    out = np.zeros((B, capacity), np.float32)
    lengths = np.zeros(B, np.int64)
    srs = np.zeros(B, np.int32)
    if B == 0:
        return out, lengths, srs
    arr = (ctypes.c_char_p * B)(*[os.fsencode(str(p)) for p in paths])
    rc = lib().stt_wav_read_batch(
        arr, B, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), capacity,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        srs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), channel, n_threads)
    if rc != 0:
        raise ValueError(f"stt_wav_read_batch rejected its arguments: {B} paths, "
                         f"capacity {capacity}")
    return out, lengths, srs


def edit_distance(a, b) -> int:
    """Levenshtein distance of two integer sequences."""
    aa = np.ascontiguousarray(a, np.int32)
    bb = np.ascontiguousarray(b, np.int32)
    return int(lib().stt_edit_distance(
        aa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(aa),
        bb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(bb)))
