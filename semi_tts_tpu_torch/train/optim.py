"""Optimizer and schedules (counterpart of `semi_tts_tpu/train/optim.py`).

The JAX package chains optax transformations: clip to global norm 5, the
optimizer's scaling (Adam: b1 0.9, b2 0.999, eps 1e-8, eps_root 0; AdamW:
Adam, then the decayed weights added; RMSprop: decay 0.9, eps 1e-8 inside
the root; SGD: the identity; Adadelta: rho 0.9, eps 1e-6), the
learning-rate schedule, and a wrapper that skips a step whose gradients are
not all finite, keeping the moments and counts. `Optimizer` is that chain
written out as tensor code, with the state on the parameters' device and no
host round trip: the finite test, the clip and the skip are selects, not
branches. As in optax, the schedule reads its count before incrementing it,
and the Adam count is incremented before the bias correction.

On a mesh (`parallel.mesh`) the flat gradient is where the gradient is
reduced: one all-reduce over the data group, averaged, before the norm,
the finite test and the clip. A leaf that `parallel.sharding` splits over
the model axis keeps only this rank's rows of its moments; the rank
updates those rows from the reduced, clipped gradient (whose norm counts
each element once) and the model group all-gathers the leaf, so that
every rank goes on with whole weights.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.mesh import all_gather_rows, group_size

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


# optax's state fields of each optimizer's scaling, in its order: the count
# (Adam's only) and the moments, one flat vector each
MOMENTS = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"), "rmsprop": ("nu",), "sgd": (),
           "adadelta": ("e_g", "e_x")}
RMS_DECAY, RMS_EPS = 0.9, 1e-8            # optax.scale_by_rms defaults
ADADELTA_RHO, ADADELTA_EPS = 0.9, 1e-6    # optax.scale_by_adadelta defaults


class Optimizer:
    """Clip -> the optimizer's scaling -> scheduled learning rate -> skip
    non-finite steps, over a list of float32 parameters on one device,
    updated in place. ``optimizer``: Adam, AdamW (``weight_decay`` added to
    the scaled update, as ``optax.add_decayed_weights`` after Adam), RMSprop,
    SGD or Adadelta, any case. ``step(grads)`` takes one gradient per
    parameter (None counts as zeros) and returns the global norm of the raw
    gradients.

    The gradients, moments and parameters are handled as one flat vector
    each, so a step is a few dozen kernel launches whatever the number of
    parameter tensors; the arithmetic is optax's, element for element.
    State (tensors on the parameters' device): ``count`` (Adam's and
    AdamW's), ``schedule_count``, the moments named in `MOMENTS` (flat;
    `views` splits them per parameter), ``notfinite_count``,
    ``total_notfinite``, ``last_finite`` (`state_tensors`). Each is
    allocated once and written in place (``copy_``), by a step and by a
    restore, so that a CUDA graph captured once reads and writes the live
    state on every replay.

    ``mesh``: a `parallel.mesh.Mesh` to reduce the gradient over;
    ``specs``: one placement a parameter (`parallel.mesh.shard_params`'
    values, in order); a leaf placed ``("model", ...)`` keeps its moments
    for this rank's rows only (`own`), and `full_moment` gathers them."""

    def __init__(self, params, optimizer: str = "Adam", lr: float = 1e-3,
                 lr_scheduler: str = "decay", weight_decay: float = 0.0, *, mesh=None,
                 specs=None):
        self.kind = optimizer.lower()
        if self.kind not in MOMENTS:
            raise NotImplementedError(f"optimizer {optimizer}")
        self.weight_decay = weight_decay if self.kind == "adamw" else 0.0
        self.params = list(params)
        dev = self.params[0].device
        if any(p.dtype != torch.float32 or p.device != dev for p in self.params):
            raise ValueError("Optimizer: expected float32 parameters on one device")
        self.mesh = mesh
        self.full_sizes = [p.numel() for p in self.params]
        # (lo, hi) rows of this rank of each leaf split over the model axis, else None
        M = 1 if mesh is None else mesh.shape["model"]
        self.rows = [None] * len(self.params)
        if specs is not None and M > 1:
            specs = list(specs)
            if len(specs) != len(self.params):
                raise ValueError(f"Optimizer: {len(specs)} specs for {len(self.params)} parameters")
            for i, (p, spec) in enumerate(zip(self.params, specs)):
                if spec and spec[0] == "model":
                    if any(a is not None for a in spec[1:]) or p.shape[0] % M:
                        raise ValueError(f"Optimizer: cannot split {tuple(p.shape)} as {spec}")
                    n = p.shape[0] // M
                    self.rows[i] = (mesh.model_rank * n, (mesh.model_rank + 1) * n)
        self.own = [p if r is None else p[r[0]:r[1]] for p, r in zip(self.params, self.rows)]
        self.sizes = [v.numel() for v in self.own]
        self.schedule = make_lr_schedule(lr, lr_scheduler)
        i32 = lambda: torch.zeros((), dtype=torch.int32, device=dev)
        self.count, self.schedule_count = i32(), i32()
        self.notfinite_count, self.total_notfinite = i32(), i32()
        self.last_finite = torch.ones((), dtype=torch.bool, device=dev)
        for name in self.moment_names:
            setattr(self, name, torch.zeros(sum(self.sizes), device=dev))

    @property
    def moment_names(self):
        return MOMENTS[self.kind]

    def state_tensors(self):
        """Every state tensor, in a fixed order."""
        return ([self.count, self.schedule_count] + [getattr(self, n) for n in self.moment_names]
                + [self.notfinite_count, self.total_notfinite, self.last_finite])

    def views(self, flat):
        """A flat state vector split into one view per parameter (this
        rank's rows of a split one)."""
        return [v.view_as(p) for v, p in zip(flat.split(self.sizes), self.own)]

    def full_views(self, flat):
        """A flat vector of the whole parameters split into one view each."""
        return [v.view_as(p) for v, p in zip(flat.split(self.full_sizes), self.params)]

    @property
    def split(self) -> bool:
        """Whether some leaf is split over the model axis."""
        return any(r is not None for r in self.rows)

    def own_flat(self, full):
        """This rank's share of a flat vector of the whole parameters."""
        if not self.split:
            return full
        return torch.cat([v.reshape(-1) if r is None else v[r[0]:r[1]].reshape(-1)
                          for v, r in zip(self.full_views(full), self.rows)])

    def full_moment(self, name):
        """The moment ``name`` of the whole parameters, flat: the model
        group's rows of the split leaves gathered (a collective: every rank
        of the group calls it)."""
        flat = getattr(self, name)
        if not self.split:
            return flat
        out = torch.empty(sum(self.full_sizes), device=flat.device)
        self._assemble(self.full_views(out), self.views(flat))
        return out

    def _assemble(self, dst, own):
        """Writes ``own`` (this rank's share, one tensor a parameter) into the
        whole tensors ``dst``: the whole leaves copied, the split ones
        all-gathered over the model group with one collective."""
        group = self.mesh.model_group
        whole = [(d, o) for d, o, r in zip(dst, own, self.rows) if r is None and d is not o]
        if whole:
            torch._foreach_copy_([d for d, _ in whole], [o for _, o in whole])
        split = [(d, o) for d, o, r in zip(dst, own, self.rows) if r is not None]
        packed = torch.cat([o.reshape(-1) for _, o in split])
        gathered = all_gather_rows(packed, group).view(group_size(group), -1)
        dsts, srcs, at = [], [], 0
        for d, o in split:
            n = o.numel()
            dsts += list(d.reshape(-1).split(n))
            srcs += list(gathered[:, at:at + n].unbind(0))
            at += n
        torch._foreach_copy_(dsts, srcs)

    def reduce(self, g):
        """The flat gradient averaged over the data group (in place)."""
        group = None if self.mesh is None else self.mesh.data_group
        if group is not None:
            dist.all_reduce(g, group=group)
            g.div_(group_size(group))
        return g

    def _scale(self, g, flat):
        """The optimizer's update direction of the clipped gradient ``g`` and
        its new moments and count, before the learning rate."""
        f32 = lambda x: x.to(torch.float32)
        if self.kind in ("adam", "adamw"):
            count = self.count + 1
            mu = (1.0 - B1) * g + B1 * self.mu
            nu = (1.0 - B2) * (g * g) + B2 * self.nu
            mu_hat = mu / (1.0 - B1 ** f32(count))
            nu_hat = nu / (1.0 - B2 ** f32(count))
            u = mu_hat / (torch.sqrt(nu_hat) + EPS)
            if self.weight_decay:
                u = u + self.weight_decay * flat
            return u, {"mu": mu, "nu": nu}, count
        if self.kind == "rmsprop":
            nu = (1.0 - RMS_DECAY) * (g * g) + RMS_DECAY * self.nu
            return torch.rsqrt(nu + RMS_EPS) * g, {"nu": nu}, self.count
        if self.kind == "adadelta":
            e_g = (1.0 - ADADELTA_RHO) * (g * g) + ADADELTA_RHO * self.e_g
            u = torch.sqrt(self.e_x + ADADELTA_EPS) / torch.sqrt(e_g + ADADELTA_EPS) * g
            e_x = (1.0 - ADADELTA_RHO) * (u * u) + ADADELTA_RHO * self.e_x
            return u, {"e_g": e_g, "e_x": e_x}, self.count
        return g, {}, self.count  # sgd

    @torch.no_grad()
    def step(self, grads):
        g = torch.zeros(sum(self.full_sizes), device=self.count.device)
        pairs = [(v, gr) for v, gr in zip(self.full_views(g), grads) if gr is not None]
        if pairs:
            torch._foreach_copy_([v for v, _ in pairs], [gr for _, gr in pairs])
        g = self.reduce(g)
        gnorm = torch.sqrt((g * g).sum())
        finite = torch.isfinite(g).all()
        g = self.own_flat(torch.where(gnorm < GRAD_CLIP, g, g / gnorm * GRAD_CLIP))
        flat = torch.cat([p.reshape(-1) for p in self.own])
        u, moments, count = self._scale(g, flat)
        update = -self.schedule(self.schedule_count.to(torch.float32)) * u
        torch._foreach_copy_(self.own, self.views(flat + torch.where(finite, update, 0.0)))
        if self.split:
            self._assemble(self.params, self.own)
        for name, new in moments.items():
            old = getattr(self, name)
            old.copy_(torch.where(finite, new, old))
        self.count.copy_(torch.where(finite, count, self.count))
        self.schedule_count.copy_(torch.where(finite, self.schedule_count + 1, self.schedule_count))
        self.notfinite_count.copy_(torch.where(finite, 0, self.notfinite_count + 1))
        self.total_notfinite.add_((~finite).to(torch.int32))
        self.last_finite.copy_(finite)
        return gnorm


def advance_lr_schedule(optimizer, step: int) -> None:
    """Fast-forward the schedule count of a fresh `Optimizer` to ``step``,
    for a checkpoint that carries no optimizer state (an imported one):
    the moments start at zero, so the Adam count stays 0 (it bias-corrects
    them), but the learning rate continues from ``step`` instead of
    restarting its warm-up."""
    optimizer.schedule_count.fill_(int(step))
