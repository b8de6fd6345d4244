"""Import a checkpoint of the upstream PyTorch implementation (counterpart
of `semi_tts_tpu/train/torch_import.py`), the migration path for its users.

The upstream solver saves ``{"model": vqvae.state_dict(), "optimizer": ...,
"global_step": step}``. `name_table` is the map from its names to the
port's, as data: one row (upstream name, port parameter or buffer) for
every tensor, for a given model configuration. Values cross unchanged
(both sides keep PyTorch's layouts: Linear (out, in), Conv1d (out, in, k),
the LSTM and GRU gates stacked as PyTorch stacks them). BatchNorm running
statistics become the port's buffers, and their ``eps`` and ``momentum``
(not tensors upstream) come from `bn_constants`. Consumed and dropped:
``num_batches_tracked``, the frozen ``codebook.onehot.weight``, the frozen
``codebook.phn_attr.weight`` (checked against the run's attribute table
when one is given) and a non-learnable ``codebook.temp`` (checked against
the configuration). `inverse_state_dict` runs the table backwards: a port
model's weights in the upstream layout.

The optimizer's moments are not imported: an imported checkpoint carries
``optimizer=None``, and a resumed run starts Adam afresh with its schedule
advanced to the carried ``global_step``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bridge import _state_path, _unflatten

BN_STATS = (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
            ("running_var", "var"))
ASR_BN = (1e-5, 0.1)     # (eps, momentum) of the ASR's and the TTS encoder's BatchNorms
CBHG_BN = (1e-3, 0.99)   # of the CBHG postnet's
CBHG_BANKS, CBHG_PROJS, CBHG_HIGHWAYS = 8, 2, 4


class StateDictMismatch(RuntimeError):
    """An upstream state_dict does not match the configured model."""


def _linear(ref, port, bias=True):
    rows = [(f"{ref}.weight", f"{port}.w")]
    return rows + [(f"{ref}.bias", f"{port}.b")] if bias else rows


def _bn(ref, port):
    return [(f"{ref}.{a}", f"{port}.{b}") for a, b in BN_STATS]


def _cell(ref, port):
    return [(f"{ref}.{w}", f"{port}.{p}") for w, p in
            (("weight_ih", "w_ih"), ("weight_hh", "w_hh"), ("bias_ih", "b_ih"),
             ("bias_hh", "b_hh"))]


def _rnn(ref, port, layers, bidirectional, layer_index=True):
    """nn.LSTM/nn.GRU's flat names -> the port's {layer}.{fwd,bwd} cells."""
    rows = []
    for li in range(layers):
        at = f"{port}.{li}" if layer_index else port
        for sfx, d in (("", "fwd"), ("_reverse", "bwd"))[: 2 if bidirectional else 1]:
            rows += [(f"{ref}.{w}_l{li}{sfx}", f"{at}.{d}.{p}") for w, p in
                     (("weight_ih", "w_ih"), ("weight_hh", "w_hh"), ("bias_ih", "b_ih"),
                      ("bias_hh", "b_hh"))]
    return rows


def _bns(cfg):
    """(upstream prefix, port prefix, (eps, momentum)) of every BatchNorm."""
    e, t = cfg.encoder, cfg.tts
    out = []
    if e.batch_norm:
        out += [(f"asr.layer{i}.bn", f"asr.bn.{i}", ASR_BN) for i in range(len(e.kernel))]
    out += [(f"tts.encoder.convs.{i}.1", f"tts.encoder.bn.{i}", ASR_BN)
            for i in range(t.enc_n_conv)]
    if t.linear_dim is not None:
        out += [(f"tts.postnet.0.conv1d_banks.{i}.bn", f"tts.postnet.cbhg.banks.{i}.bn", CBHG_BN)
                for i in range(CBHG_BANKS)]
        out += [(f"tts.postnet.0.conv1d_projs.{j}.bn", f"tts.postnet.cbhg.projs.{j}.bn", CBHG_BN)
                for j in range(CBHG_PROJS)]
    return out


def name_table(cfg):
    """[(upstream name, port name)] of every tensor of a `VQVAEConfig`'s
    model that crosses (parameters and BatchNorm statistics)."""
    e, t, d, cb = cfg.encoder, cfg.tts, cfg.tts.decoder, cfg.codebook
    rows = []
    for i in range(len(e.kernel)):
        rows += _linear(f"asr.layer{i}.conv", f"asr.convs.{i}")
    rows += _rnn("asr.rnn", "asr.rnn", e.rnn_layers, e.rnn_bid)
    rows += _linear("asr.postnet", "asr.postnet")
    if e.layer_norm:
        rows += [("asr.norm_layer.weight", "asr.ln.scale"), ("asr.norm_layer.bias", "asr.ln.bias")]
    if cb.temp < 0:
        rows.append(("codebook.temp", "codebook.temp"))
    if cb.use_phn_attr:
        rows += _linear("codebook.proj_attr", "codebook.proj_attr")
    if cb.bone == "l2":
        rows.append(("codebook.learnable_table", "codebook.learnable_table"))
    elif cb.bone == "seperate":
        rows += _linear("codebook.asr_final_layer", "codebook.asr_final")
        rows.append(("codebook.embedding.weight", "codebook.embedding"))
    else:
        raise NotImplementedError(cb.bone)
    rows += _rnn("tts.encoder.lstm", "tts.encoder.lstm", t.enc_rnn_layer, True)
    for i in range(t.enc_n_conv):
        rows += _linear(f"tts.encoder.convs.{i}.0.conv", f"tts.encoder.convs.{i}")
    dec = "tts.decoder"
    for i in range(2):
        rows += _linear(f"{dec}.prenet.layers.{i}.linear", f"{dec}.prenet.{i}", bias=False)
    rows += _cell(f"{dec}.query_rnn", f"{dec}.query_rnn") + _cell(f"{dec}.dec_rnn", f"{dec}.dec_rnn")
    rows += _linear(f"{dec}.proj.linear", f"{dec}.proj")
    rows += _linear(f"{dec}.gate_layer.linear", f"{dec}.gate")
    for name in ("query_layer", "memory_layer", "v"):
        rows += _linear(f"{dec}.attn.{name}.linear", f"{dec}.attn.{name}", bias=False)
    if d.loc_aware:
        rows += _linear(f"{dec}.attn.loc_conv.conv", f"{dec}.attn.loc_conv", bias=False)
        rows += _linear(f"{dec}.attn.loc_linear.linear", f"{dec}.attn.loc_linear", bias=False)
    mode = d.spkr_embed_mode.lower()
    if mode == "adain":
        rows += _linear(f"{dec}.pseudo_latent_mean", f"{dec}.pseudo_mean")
        rows += _linear(f"{dec}.pseudo_latent_std.0", f"{dec}.pseudo_std")
    elif mode == "concat":
        rows += _linear(f"{dec}.spkr_mem_proj", f"{dec}.spkr_mem_proj")
    elif mode == "add":
        rows += _linear(f"{dec}.spkr_proj", f"{dec}.spkr_proj")
        rows += _linear(f"{dec}.spkr_mem_proj", f"{dec}.spkr_mem_proj")
    if t.linear_dim is not None:
        ref, port = "tts.postnet.0", "tts.postnet.cbhg"
        rows += _linear(f"{ref}.pre_highway_proj", f"{port}.pre_highway", bias=False)
        for h in range(CBHG_HIGHWAYS):
            for gate in ("H", "T"):
                rows += _linear(f"{ref}.highways.{h}.{gate}", f"{port}.highways.{h}.{gate}")
        for i in range(CBHG_BANKS):
            rows += _linear(f"{ref}.conv1d_banks.{i}.conv1d", f"{port}.banks.{i}.conv", bias=False)
        for j in range(CBHG_PROJS):
            rows += _linear(f"{ref}.conv1d_projs.{j}.conv1d", f"{port}.projs.{j}.conv", bias=False)
        rows += _rnn(f"{ref}.gru", f"{port}.gru", 1, True, layer_index=False)
        rows += _linear("tts.postnet.1", "tts.postnet.linear")
    rows.append(("spkr_embed.weight", "spkr_embed"))
    if cfg.use_asr_postnet:
        rows += _rnn("asr_postnet.rnn", "asr_postnet.rnn", 2, True)
        rows += _linear("asr_postnet.linear", "asr_postnet.linear")
    for ref, port, _ in _bns(cfg):
        rows += _bn(ref, port)
    return rows


def bn_constants(cfg):
    """{port buffer name: value} of every BatchNorm's ``eps`` and ``momentum``."""
    return {f"{port}.{k}": v for _, port, consts in _bns(cfg)
            for k, v in zip(("eps", "momentum"), consts)}


def _dropped(cfg):
    """Upstream names consumed without a port counterpart."""
    return ([f"{ref}.num_batches_tracked" for ref, _, _ in _bns(cfg)]
            + ["codebook.onehot.weight", "codebook.phn_attr.weight"]
            + (["codebook.temp"] if cfg.codebook.temp >= 0 else []))


def _numpy(v):
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float32)


def convert_state_dict(sd, cfg, phn_attr=None, *, strict=True):
    """An upstream ``VQVAE.state_dict()`` (tensor or numpy values) ->
    {port parameter or buffer name: float32 tensor} for ``VQVAE(cfg)``,
    BatchNorm ``eps`` and ``momentum`` included. Raises `StateDictMismatch`
    on a missing tensor, a frozen buffer that disagrees with the
    configuration or ``phn_attr``, and (``strict``) a key left over."""
    sd = dict(sd)
    out = {}
    for ref, port in name_table(cfg):
        if ref not in sd:
            raise StateDictMismatch(f"upstream checkpoint is missing '{ref}': wrong config for "
                                    f"this checkpoint? ({len(sd)} keys left)")
        out[port] = torch.from_numpy(_numpy(sd.pop(ref)).copy())
    cb = cfg.codebook
    if cb.temp >= 0 and "codebook.temp" in sd:
        temp = _numpy(sd["codebook.temp"]).reshape(-1)
        if abs(float(temp[0]) - float(cb.temp)) > 1e-6:
            raise StateDictMismatch(f"checkpoint codebook.temp={float(temp[0])} but the config "
                                    f"says {cb.temp} (not learnable)")
    if cb.use_phn_attr and phn_attr is not None and "codebook.phn_attr.weight" in sd:
        if not np.allclose(np.asarray(phn_attr, np.float32),
                           _numpy(sd["codebook.phn_attr.weight"]), atol=1e-5):
            raise StateDictMismatch("checkpoint's frozen phn_attr table differs from this run's "
                                    "phn_attr_pth: pass the same attribute table")
    for name in _dropped(cfg):
        sd.pop(name, None)
    if strict and sd:
        raise StateDictMismatch("unconsumed upstream keys (checkpoint/config mismatch): "
                                + ", ".join(sorted(sd)[:12]) + (" ..." if len(sd) > 12 else ""))
    out.update({k: torch.tensor(v, dtype=torch.float32) for k, v in bn_constants(cfg).items()})
    return out


def inverse_state_dict(named, cfg, phn_attr=None):
    """The port's {name: tensor} (``model.state_dict()`` of a ``VQVAE(cfg)``)
    -> an upstream-layout state_dict of every tensor `convert_state_dict`
    reads: the table's rows backwards, each BatchNorm's
    ``num_batches_tracked``, and the codebook's frozen buffers (``onehot``,
    the identity over the vocabulary; ``phn_attr``, the attribute table,
    which the configuration's attributes need; ``temp`` where it is not
    learnable)."""
    sd = {ref: named[port].detach().cpu().clone() for ref, port in name_table(cfg)}
    for ref, _, _ in _bns(cfg):
        sd[f"{ref}.num_batches_tracked"] = torch.tensor(0)
    cb = cfg.codebook
    sd["codebook.onehot.weight"] = torch.eye(cb.vocab_size)
    if cb.use_phn_attr:
        if phn_attr is None:
            raise ValueError("the configuration uses phonological attributes: pass phn_attr")
        sd["codebook.phn_attr.weight"] = torch.as_tensor(np.asarray(phn_attr, np.float32))
    if cb.temp >= 0:
        sd["codebook.temp"] = torch.tensor([float(cb.temp)])
    return sd


def jax_trees(named, cfg):
    """{port name: tensor} of `convert_state_dict` -> the (params, state)
    numpy trees of the checkpoint layout (`bridge.to_jax_params`'s)."""
    buffers = {f"{port}.{b}" for _, port, _ in _bns(cfg) for b in ("mean", "var", "eps",
                                                                     "momentum")}
    flat = {"params": {}, "state": {}}
    for name, t in named.items():
        if name in buffers:
            flat["state"][_state_path(name)] = t.numpy()
        else:
            flat["params"][name.replace(".", "/")] = t.numpy()
    return _unflatten(flat["params"]), _unflatten(flat["state"])


def import_reference_checkpoint(pth_path, cfg, phn_attr=None, *, strict=True):
    """Load an upstream ``.pth`` (the solver triple or a bare state_dict) ->
    {"model": params, "state": state, "optimizer": None, "global_step": step,
    "extra": {}}, the dict `checkpoint.load_checkpoint` returns."""
    raw = torch.load(pth_path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "model" in raw:
        sd, step = raw["model"], int(raw.get("global_step", 0))
    else:
        sd, step = raw, 0
    params, state = jax_trees(convert_state_dict(sd, cfg, phn_attr, strict=strict), cfg)
    return {"model": params, "state": state, "optimizer": None, "global_step": step,
            "extra": {}}
