"""Device choice and numeric precision, in one place.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
host without a card raises instead of silently running on the CPU.
"""

from __future__ import annotations

import torch


def use_fp32() -> None:
    """Full float32 matrix products and convolutions (no TF32).

    The JAX reference runs its tests at ``highest`` matmul precision; cuDNN
    convolutions default to TF32 on the card, which keeps only ~3 decimal
    digits. The server and ``chip_smoke.py`` call this before any work."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def use_deterministic() -> None:
    """cuDNN's deterministic algorithms and no autotuning, so that a train
    step on the card repeats bit for bit (the convolutions' backward is
    otherwise free to sum in another order on each call)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; it raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
