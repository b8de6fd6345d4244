"""Parameter draws from an explicit `torch.Generator` (CPU tensors; the
caller moves the finished module to its device). The rules follow the JAX
package's init functions; the numbers differ from JAX's threefry draws."""

from __future__ import annotations

import torch


def uniform(shape, scale: float, generator=None):
    """U(-scale, scale), float32."""
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * scale


def normal(shape, generator=None):
    """N(0, 1), float32."""
    return torch.randn(shape, generator=generator)
