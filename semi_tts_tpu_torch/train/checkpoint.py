"""Checkpoints in the JAX package's format (`semi_tts_tpu/train/checkpoint.py`):
one ``np.savez`` archive behind a ``.pth`` name, holding flattened
``path -> array`` entries for the model / state / optimizer trees plus the
step. Trees are nested dicts and lists of numpy arrays (see `bridge`), so
either package reads the other's checkpoints."""

from __future__ import annotations

import json
import os

import numpy as np


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
