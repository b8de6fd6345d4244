"""Checkpoints in the JAX package's format (`semi_tts_tpu/train/checkpoint.py`):
one ``np.savez`` archive behind a ``.pth`` name, holding flattened
``path -> array`` entries for the model / state / optimizer trees plus the
step. Trees are nested dicts and lists of numpy arrays (see `bridge`), so
either package reads the other's checkpoints.

The optimizer tree is the JAX package's optax state of `Optimizer`'s chain
(`optimizer_tree`): ``ApplyIfFiniteState(notfinite_count, last_finite,
total_notfinite, (EmptyState() of the clip, the scaling's state,
[EmptyState() of AdamW's weight decay,] ScaleByScheduleState(count)))``;
the scaling's state is ``ScaleByAdamState(count, mu, nu)`` (Adam, AdamW),
``ScaleByRmsState(nu)``, ``EmptyState()`` (SGD) or
``ScaleByAdaDeltaState(e_g, e_x)``, each moment a tree of the parameters'
shape. A sequence is saved with its class name cut to 16
characters, as the JAX package saves it; the JAX package reads the state
back by leaf order, so the same key set is all it needs."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..bridge import _flatten as _leaves
from ..bridge import _unflatten as _tree
from ..bridge import load_jax_params, to_jax_params


class ApplyIfFiniteState(tuple):
    """The optax state classes, by name only: `_flatten` saves the name."""


class EmptyState(tuple):
    pass


class ScaleByAdamState(tuple):
    pass


class ScaleByRmsState(tuple):
    pass


class ScaleByAdaDeltaState(tuple):
    pass


class ScaleByScheduleState(tuple):
    pass


# each optimizer's optax state class and whether it leads with a count
SCALE_STATE = {"adam": (ScaleByAdamState, True), "adamw": (ScaleByAdamState, True),
               "rmsprop": (ScaleByRmsState, False), "sgd": (EmptyState, False),
               "adadelta": (ScaleByAdaDeltaState, False)}


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        out[f"{prefix}__seq__"] = np.asarray([type(tree).__name__, str(len(tree))], dtype="U16")
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        out[f"{prefix}__none__"] = np.zeros(0)
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if "__none__" in node:
            return None
        if "__seq__" in node:
            tname, n = node["__seq__"]
            seq = [rebuild(node[str(i)]) for i in range(int(n))]
            return tuple(seq) if tname == "tuple" else seq
        return {k: rebuild(v) for k, v in node.items() if k != "__seq__"}

    return rebuild(root)


def save_checkpoint(path, *, params, state, opt_state, step, extra=None):
    """Write numpy trees (nested dicts/lists of arrays) atomically."""
    payload = {}
    for name, tree in [("model", params), ("state", state), ("optimizer", opt_state)]:
        payload.update(_flatten(tree, f"{name}/"))
    payload["global_step"] = np.asarray(step)
    if extra:
        payload["extra_json"] = np.asarray(json.dumps(extra))
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path):
    """Returns dict(model=..., state=..., optimizer=..., global_step=int, extra=...)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    step = int(flat.pop("global_step"))
    extra = json.loads(str(flat.pop("extra_json"))) if "extra_json" in flat else None
    groups = {"model": {}, "state": {}, "optimizer": {}}
    for k, v in flat.items():
        head, rest = k.split("/", 1)
        groups[head][rest] = v
    out = {name: _unflatten(g) for name, g in groups.items()}
    out["global_step"] = step
    out["extra"] = extra
    return out


def load_subtree(path, subtree_key, _ckpt=None):
    """One module's params from a checkpoint, e.g. 'asr', 'codebook',
    'tts/decoder'."""
    ckpt = _ckpt if _ckpt is not None else load_checkpoint(path)
    node = ckpt["model"]
    for part in subtree_key.split("/"):
        if part not in node:
            raise KeyError(f"Missing pretrained module {subtree_key!r} in {path}")
        node = node[part]
    return node


def _walk(tree, parts):
    """Descend ``parts`` in a nested dict; returns (parent, leaf_key), or
    None where a segment is missing."""
    node = tree
    for p in parts[:-1]:
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    if not isinstance(node, dict) or parts[-1] not in node:
        return None
    return node, parts[-1]


def _graft(dst_tree, parts, sub, what):
    """Put ``sub`` at ``parts`` of ``dst_tree`` after checking that it has
    the same leaves, of the same shapes, as what it replaces."""
    parent, key = _walk(dst_tree, parts)
    have, got = _leaves(parent[key]), _leaves(sub)
    if set(have) != set(got):
        raise KeyError(f"pretrained {what} {'/'.join(parts)!r}: leaves "
                       f"{sorted(set(have) ^ set(got))[:5]} differ from the model's")
    for k, v in have.items():
        if np.shape(v) != np.shape(got[k]):
            raise ValueError(f"pretrained {what} {'/'.join(parts)}/{k}: shape "
                             f"{np.shape(got[k])}, model {np.shape(v)}")
    parent[key] = sub


def apply_pretrained(model, pretrained: dict, state: bool = True):
    """Graft pretrained subtrees into ``model`` in place (the counterpart of
    the JAX package's ``apply_pretrained``); returns the model.

    ``pretrained``: subtree key (``asr``, ``codebook/learnable_table``,
    ``tts/decoder``, ...) -> checkpoint path of either package; empty or
    None paths are skipped. Each file is loaded once, however many keys
    graft from it. Every leaf must match the model's in path and shape.
    With ``state``, the BatchNorm running statistics under the same key
    are grafted too wherever the checkpoint's state tree has that path, as
    torch's ``load_state_dict`` carries them with the parameters."""
    keys = {k: v for k, v in (pretrained or {}).items() if v}
    if not keys:
        return model
    params, st = to_jax_params(model)
    loaded = {}
    for key, path in keys.items():
        if path not in loaded:
            loaded[path] = load_checkpoint(path)
        parts = key.split("/")
        if _walk(params, parts) is None:
            raise KeyError(f"the model has no module {key!r} to graft into")
        _graft(params, parts, load_subtree(path, key, _ckpt=loaded[path]), "module")
        if state:
            src = _walk(loaded[path].get("state") or {}, parts)
            if src is not None and _walk(st, parts) is not None:
                _graft(st, parts, src[0][src[1]], "state")
    return load_jax_params(model, params, st)


def _param_paths(model):
    return [name.replace(".", "/") for name, _ in model.named_parameters()]


def optimizer_tree(optimizer, model):
    """`Optimizer`'s state as the JAX package's optax tree (numpy leaves);
    ``optimizer`` holds ``model.parameters()`` in order. The moments of
    leaves split over a mesh's model axis are gathered whole
    (`Optimizer.full_moment`, a collective of the model group)."""
    def host(t):
        return t.detach().cpu().numpy().copy()

    def moments(flat):
        return _tree(dict(zip(_param_paths(model), (host(v) for v in optimizer.full_views(flat)))))

    cls, counted = SCALE_STATE[optimizer.kind]
    scale = cls(((host(optimizer.count),) if counted else ())
                + tuple(moments(optimizer.full_moment(n)) for n in optimizer.moment_names))
    decay = (EmptyState(),) if optimizer.weight_decay else ()
    inner = (EmptyState(), scale) + decay + (ScaleByScheduleState((host(optimizer.schedule_count),)),)
    return ApplyIfFiniteState((host(optimizer.notfinite_count), host(optimizer.last_finite),
                               host(optimizer.total_notfinite), inner))


def load_optimizer_tree(optimizer, model, tree):
    """Set `Optimizer`'s state from an optax tree as `load_checkpoint`
    returns it (`optimizer_tree`'s layout); raises on a missing, extra or
    mis-shaped moment, or a tree of another optimizer. On a mesh each rank
    keeps its rows of the split leaves' moments (`Optimizer.own_flat`)."""
    notfinite, last_finite, total, inner = tree
    _, counted = SCALE_STATE[optimizer.kind]
    want = 3 + bool(optimizer.weight_decay)
    names = optimizer.moment_names
    scale = inner[1] if len(inner) == want else None
    if scale is None or len(scale) != counted + len(names):
        raise ValueError(f"optimizer state of {len(inner)} transforms does not fit "
                         f"{optimizer.kind} (weight decay {optimizer.weight_decay})")
    (schedule_count,) = inner[-1]
    dev = optimizer.count.device

    def scalar(v, dtype):
        return torch.as_tensor(np.array(v), dtype=dtype, device=dev).reshape(())

    def flat(moment_tree):
        leaves = _leaves(moment_tree)
        paths = _param_paths(model)
        if set(leaves) != set(paths):
            raise KeyError(f"optimizer moments: {sorted(set(leaves) ^ set(paths))[:5]} differ "
                           "from the model's parameters")
        parts = []
        for path, p in zip(paths, optimizer.params):
            if tuple(leaves[path].shape) != tuple(p.shape):
                raise ValueError(f"optimizer moment {path!r}: shape {leaves[path].shape}, "
                                 f"parameter {tuple(p.shape)}")
            parts.append(torch.from_numpy(np.asarray(leaves[path], np.float32)).reshape(-1))
        return torch.cat(parts).to(dev)

    # in place, so that a CUDA graph captured before the restore reads it
    if counted:
        optimizer.count.copy_(scalar(scale[0], torch.int32))
    for name, moment in zip(names, scale[counted:]):
        getattr(optimizer, name).copy_(optimizer.own_flat(flat(moment)))
    optimizer.schedule_count.copy_(scalar(schedule_count, torch.int32))
    optimizer.notfinite_count.copy_(scalar(notfinite, torch.int32))
    optimizer.total_notfinite.copy_(scalar(total, torch.int32))
    optimizer.last_finite.copy_(scalar(last_finite, torch.bool))
