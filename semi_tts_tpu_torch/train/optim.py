"""Optimizer and schedules (counterpart of `semi_tts_tpu/train/optim.py`).

The JAX package chains optax transformations: clip to global norm 5, Adam
(b1 0.9, b2 0.999, eps 1e-8, eps_root 0), the learning-rate schedule, and a
wrapper that skips a step whose gradients are not all finite, keeping the
moments and counts. `Optimizer` is that chain written out as tensor code,
with the state on the parameters' device and no host round trip: the
finite test, the clip and the skip are selects, not branches. As in optax,
the schedule reads its count before incrementing it, and the Adam count is
incremented before the bias correction.
"""

from __future__ import annotations

import torch

GRAD_CLIP = 5.0
B1, B2, EPS = 0.9, 0.999, 1e-8  # Adam's, as optax.scale_by_adam defaults them


def noam_schedule(init_lr: float, warmup_step: float):
    """``init_lr * w^0.5 * min((s+1) * w^-1.5, (s+1)^-0.5)`` of a step count
    (a float32 tensor)."""
    def lr(step):
        s = step + 1.0
        return init_lr * warmup_step ** 0.5 * torch.minimum(s * warmup_step ** -1.5, s ** -0.5)

    return lr


def make_lr_schedule(lr: float, lr_scheduler: str):
    if lr_scheduler == "warmup":
        return noam_schedule(lr, 4000.0)
    if lr_scheduler == "decay":
        return noam_schedule(lr, 1000.0)
    return lambda step: torch.full_like(step, lr)  # 'fixed'


def tf_rate_schedule(tf_start=1.0, tf_end=1.0, tf_step=1):
    """Teacher-forcing rate: linear from ``tf_start`` to ``tf_end`` over
    ``tf_step`` steps, then flat."""
    return lambda step: max(tf_end, tf_start - (tf_start - tf_end) * step / tf_step)


class Optimizer:
    """Clip -> Adam -> scheduled learning rate -> skip non-finite steps, over
    a list of float32 parameters on one device, updated in place.
    ``step(grads)`` takes one gradient per parameter (None counts as zeros)
    and returns the global norm of the raw gradients.

    The gradients, moments and parameters are handled as one flat vector
    each, so a step is a few dozen kernel launches whatever the number of
    parameter tensors; the arithmetic is optax's, element for element.
    State (tensors on the parameters' device): ``count`` (Adam),
    ``schedule_count``, ``mu``, ``nu`` (flat; `views` splits them per
    parameter), ``notfinite_count``, ``total_notfinite``, ``last_finite``."""

    def __init__(self, params, optimizer: str = "Adam", lr: float = 1e-3,
                 lr_scheduler: str = "decay"):
        if optimizer.lower() != "adam":
            raise NotImplementedError(f"optimizer {optimizer}: the port has Adam only")
        self.params = list(params)
        dev = self.params[0].device
        if any(p.dtype != torch.float32 or p.device != dev for p in self.params):
            raise ValueError("Optimizer: expected float32 parameters on one device")
        self.sizes = [p.numel() for p in self.params]
        self.schedule = make_lr_schedule(lr, lr_scheduler)
        i32 = lambda: torch.zeros((), dtype=torch.int32, device=dev)
        self.count, self.schedule_count = i32(), i32()
        self.notfinite_count, self.total_notfinite = i32(), i32()
        self.last_finite = torch.ones((), dtype=torch.bool, device=dev)
        self.mu = torch.zeros(sum(self.sizes), device=dev)
        self.nu = torch.zeros(sum(self.sizes), device=dev)

    def views(self, flat):
        """A flat state vector split into one view per parameter."""
        return [v.view_as(p) for v, p in zip(flat.split(self.sizes), self.params)]

    @torch.no_grad()
    def step(self, grads):
        g = torch.zeros_like(self.mu)
        pairs = [(v, gr) for v, gr in zip(self.views(g), grads) if gr is not None]
        if pairs:
            torch._foreach_copy_([v for v, _ in pairs], [gr for _, gr in pairs])
        gnorm = torch.sqrt((g * g).sum())
        finite = torch.isfinite(g).all()
        g = torch.where(gnorm < GRAD_CLIP, g, g / gnorm * GRAD_CLIP)
        count = self.count + 1
        f32 = lambda x: x.to(torch.float32)
        mu = (1.0 - B1) * g + B1 * self.mu
        nu = (1.0 - B2) * (g * g) + B2 * self.nu
        mu_hat = mu / (1.0 - B1 ** f32(count))
        nu_hat = nu / (1.0 - B2 ** f32(count))
        update = -self.schedule(f32(self.schedule_count)) * (mu_hat / (torch.sqrt(nu_hat) + EPS))
        flat = torch.cat([p.reshape(-1) for p in self.params])
        torch._foreach_copy_(self.params, self.views(flat + torch.where(finite, update, 0.0)))
        self.mu = torch.where(finite, mu, self.mu)
        self.nu = torch.where(finite, nu, self.nu)
        self.count = torch.where(finite, count, self.count)
        self.schedule_count = torch.where(finite, self.schedule_count + 1, self.schedule_count)
        self.notfinite_count = torch.where(finite, 0, self.notfinite_count + 1).to(torch.int32)
        self.total_notfinite = self.total_notfinite + (~finite).to(torch.int32)
        self.last_finite = finite
        return gnorm
