"""Weights between the JAX package's pytrees and the port's modules.

The JAX side is a pair of nested dicts/lists of numpy arrays: the
``vqvae_init`` (params, state) after ``np.asarray``, or
``load_checkpoint(...)["model"]`` / ``["state"]``. Port parameter paths are
the JAX params paths (``tts.encoder.convs.0.w`` <-> ``tts/encoder/convs/0/w``).
BatchNorm buffers map to the JAX state tree, which drops the ``cbhg`` level
and the ``bn`` leaf of a postnet (``tts.postnet.cbhg.banks.0.bn.mean`` <->
``tts/postnet/banks/0/mean``; the audio LM's ``postnet.cbhg...`` likewise).
The same holds for every module of the port: the VQVAE, the language
models of `models.lm`, the speaker encoder and `models.common`'s `MLP` (the
JAX ``mlp_init`` list, ``0/w`` <-> ``0.w``) and conv-stack `Postnet` (the
``postnet_init`` pair: ``convs``/``bn`` params, the ``bn`` list of
statistics as state). Optimizer states cross in
`train.checkpoint` (`optimizer_tree`, `load_optimizer_tree`).
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def _state_path(buffer_name: str) -> str:
    path = buffer_name.replace(".cbhg.", ".")
    head, leaf = path.rsplit(".", 1)
    if head.endswith(".bn") and ".postnet." in "." + head:
        head = head[: -len(".bn")]
    return f"{head}.{leaf}".replace(".", "/")


def _pairs(model):
    """(kind, jax path, tensor) for every parameter and buffer of ``model``."""
    for name, p in model.named_parameters():
        yield "params", name.replace(".", "/"), p
    for name, b in model.named_buffers():
        yield "state", _state_path(name), b


def load_jax_params(model, params, state):
    """Copy a JAX (params, state) pair into ``model`` in place; returns it.
    Raises on a missing, extra or mis-shaped leaf."""
    flat = {"params": _flatten(params), "state": _flatten(state)}
    seen = {"params": set(), "state": set()}
    with torch.no_grad():
        for kind, path, t in _pairs(model):
            if path not in flat[kind]:
                raise KeyError(f"JAX {kind} tree has no leaf {path!r}")
            src = flat[kind][path]
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{kind} leaf {path!r}: JAX shape {src.shape}, "
                                 f"port shape {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))
            seen[kind].add(path)
    for kind in flat:
        extra = sorted(set(flat[kind]) - seen[kind])
        if extra:
            raise KeyError(f"JAX {kind} leaves with no port counterpart: {extra[:5]}")
    return model


def _unflatten(flat):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [rebuild(node[str(i)]) for i in range(len(node))]
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def to_jax_params(model):
    """The inverse of `load_jax_params`: ``(params, state)`` as nested
    dicts/lists of float32 numpy arrays, in the JAX tree layout."""
    flat = {"params": {}, "state": {}}
    for kind, path, t in _pairs(model):
        flat[kind][path] = t.detach().cpu().numpy().copy()
    return _unflatten(flat["params"]), _unflatten(flat["state"])
