"""PyTorch + CUDA port of `semi_tts_tpu` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout (`ops/`, `models/`, `serve.py`)
and imports nothing from it: the JAX package stays the reference the port is
tested against. Hand-written CUDA kernels live in `csrc/` and are bound by
`kernels/`; each kernel wrapper keeps a plain PyTorch version of the same
function beside it, which runs only for tensors on the CPU.
"""

from .device import resolve_device, use_deterministic, use_fp32

__all__ = ["resolve_device", "use_deterministic", "use_fp32"]
