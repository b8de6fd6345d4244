"""Matrix-product FLOPs of one call (counterpart of `semi_tts_tpu/utils/flops.py`).

The JAX module walks a jaxpr and counts the useful FLOPs of its
``dot_general`` and convolution equations, scan bodies at their trip
count, nothing elementwise. Here one eager call of ``fn`` runs under
`torch.utils.flop_counter.FlopCounterMode`, which counts the library's
matrix products and convolutions (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
``convolution`` and its backward) as they run, so a Python loop counts at
its trip count and a backward pass run inside the call counts too.

A convolution's backward is counted as the JAX module counts the
transposed convolutions that autodiff emits (``2 * prod(out) * in_ch *
prod(kernel)``): the input's gradient over the input's positions, where
torch's own formula takes the output's, which a stride or padding make
fewer; the weight's gradient as torch counts it.

The hand-written kernels are ctypes calls that no dispatch mode sees. Each
kernel wrapper is decorated with `counted`, which adds the dot FLOPs of the
JAX function the kernel replaces (whatever route ran, and on the CPU, where
the wrapper runs its plain version) and keeps the mode from counting the
plain version's own products a second time. A CUDA graph's replay runs no
Python and no dispatch, so `matmul_flops` counts an eager call.
"""

from __future__ import annotations

import collections
import functools
import math

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_backward_flop

__all__ = ["counted", "matmul_flops", "no_dots"]


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation,
                         transposed, output_padding, groups, output_mask, out_shape, **kwargs):
    """``aten.convolution_backward`` in the JAX module's convention: torch's
    count of the weight's gradient, and the input's gradient of a
    convolution as JAX's transposed convolution, whose output is the input
    (B, C_in, *L_in) and whose kernel has C_out / groups input features."""
    if transposed:
        return conv_backward_flop(grad_out_shape, x_shape, w_shape, bias, stride, padding,
                                  dilation, transposed, output_padding, groups, output_mask,
                                  out_val=out_shape)
    flops = conv_backward_flop(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation,
                               transposed, output_padding, groups, [False, output_mask[1], False],
                               out_val=out_shape)
    if output_mask[0]:
        flops += 2 * math.prod(x_shape) * (w_shape[0] // groups) * math.prod(w_shape[2:])
    return flops


class _Counter(FlopCounterMode):
    """FlopCounterMode that counts nothing while a kernel wrapper runs."""

    def __init__(self):
        super().__init__(display=False,
                         custom_mapping={torch.ops.aten.convolution_backward: _conv_backward_flops})
        self.muted = 0
        self.kernels: collections.Counter = collections.Counter()

    def _count_flops(self, func_packet, out, args, kwargs):
        if self.muted:
            return out
        return super()._count_flops(func_packet, out, args, kwargs)


_ACTIVE: list = []  # the counters of the `matmul_flops` calls running, innermost last


def counted(flops_of):
    """Decorator of a kernel wrapper: under `matmul_flops`, a call adds
    ``flops_of(*args, **kwargs)`` (the dot FLOPs of the JAX function the
    kernel replaces) and counts none of the products the wrapper runs."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _ACTIVE:
                return fn(*args, **kwargs)
            c = _ACTIVE[-1]
            if not c.muted:
                c.kernels[fn.__name__] += flops_of(*args, **kwargs)
            c.muted += 1
            try:
                return fn(*args, **kwargs)
            finally:
                c.muted -= 1
        return wrapper
    return deco


def no_dots(*args, **kwargs) -> int:
    """The count of a kernel whose JAX function has no matrix product."""
    return 0


def matmul_flops(fn, *args, **kwargs) -> float:
    """Total matrix-product and convolution FLOPs of one call of
    ``fn(*args, **kwargs)``, the kernels' included."""
    c = _Counter()
    _ACTIVE.append(c)
    try:
        with c:
            fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    return float(c.get_total_flops() + sum(c.kernels.values()))
