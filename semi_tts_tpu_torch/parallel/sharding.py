"""Per-module placement of the VQVAE's parameters over the ``model`` axis
(counterpart of `semi_tts_tpu/parallel/sharding.py`).

Each ``*_specs`` function mirrors its JAX namesake leaf for leaf over the
port's modules, whose parameter names are the JAX tree's paths (`bridge`):
a spec is a tuple, one entry an axis of the leaf, ``"model"`` where the
leaf is split over the model axis and None where it is not, ``()`` for a
leaf every rank holds whole (JAX's ``P()``). The policy is JAX's: the
gate-stacked rows of the wide LSTM and GRU weights and the decoder's and
postnet's output projections are split; everything small (convolutions,
attention, codebook, norms) is whole. `place_params` checks each leaf's
divisibility and falls back to whole, so one spec tree serves any mesh.

What a split means in the port: the optimizer (`train/optim.py`) keeps
only this rank's rows of a split leaf's moments and updates only those
rows, then the model group all-gathers the leaf, so every step computes
with whole weights (the recurrence kernels take a whole ``W_hh``).
"""

from __future__ import annotations

R = ()                   # whole on every rank (JAX's P())
ROWS = ("model", None)   # rows split over the model axis (P("model", None))
VEC = ("model",)         # a vector split over the model axis (P("model"))


def _under(prefix, specs):
    return {f"{prefix}.{k}": v for k, v in specs.items()}


def _fill(module, spec=R):
    """Every parameter of ``module`` at ``spec``."""
    return {name: spec for name, _ in module.named_parameters()}


def lstm_specs(_p=None):
    """One LSTM or GRU direction: the (gates*H, D) weights split on their
    stacked output rows."""
    return {"w_ih": ROWS, "w_hh": ROWS, "b_ih": VEC, "b_hh": VEC}


def multi_lstm_specs(layers):
    """`ops.rnn.multi_lstm_init`'s layers, each ``{fwd, bwd?}``."""
    out = {}
    for i, layer in enumerate(layers):
        for d in layer:
            out.update(_under(f"{i}.{d}", lstm_specs()))
    return out


def linear_specs(p, shard_out=False):
    """`models.common.Linear`: ``w`` (out, in) and ``b`` (out,)."""
    out = {"w": ROWS if shard_out else R}
    if p.b is not None:
        out["b"] = VEC if shard_out else R
    return out


def asr_specs(p):
    """`models.asr.ASR`: the conv stack whole, the BiLSTM split, the
    output projection whole (latent_dim is small)."""
    out = {**_under("convs", _fill(p.convs)), **_under("rnn", multi_lstm_specs(p.rnn)),
           **_under("postnet", linear_specs(p.postnet))}
    for k in ("bn", "ln"):
        if hasattr(p, k):
            out.update(_under(k, _fill(getattr(p, k))))
    return out


def asr_postnet_specs(p):
    """`models.asr.ASRPostnet`."""
    return {**_under("rnn", multi_lstm_specs(p.rnn)), **_under("linear", linear_specs(p.linear))}


def decoder_specs(p):
    """`models.decoder.Decoder`: the two big LSTMs and the (M*r)-wide frame
    projection split; prenet, attention, gate and speaker adapters whole."""
    out = {**_under("prenet", _fill(p.prenet)), **_under("query_rnn", lstm_specs()),
           **_under("dec_rnn", lstm_specs()), **_under("attn", _fill(p.attn)),
           **_under("proj", linear_specs(p.proj, shard_out=True)),
           **_under("gate", linear_specs(p.gate))}
    for k in ("pseudo_mean", "pseudo_std", "spkr_mem_proj", "spkr_proj"):
        if hasattr(p, k):
            out.update(_under(k, _fill(getattr(p, k))))
    return out


def encoder_specs(p):
    """`models.encoder.Encoder`: convs and BN whole, the BiLSTM split."""
    return {**_under("convs", _fill(p.convs)), **_under("bn", _fill(p.bn)),
            **_under("lstm", multi_lstm_specs(p.lstm))}


def cbhg_specs(p):
    """`models.cbhg.CBHG`: banks, projections and highways whole, the
    BiGRU split."""
    out = {**_under("banks", _fill(p.banks)), **_under("projs", _fill(p.projs)),
           **_under("pre_highway", _fill(p.pre_highway)),
           **_under("highways", _fill(p.highways))}
    for d in p.gru:
        out.update(_under(f"gru.{d}", lstm_specs()))
    return out


def tts_specs(p):
    """`models.tts.TTS`."""
    out = {**_under("encoder", encoder_specs(p.encoder)),
           **_under("decoder", decoder_specs(p.decoder))}
    if getattr(p, "postnet", None) is not None:
        out.update(_under("postnet.cbhg", cbhg_specs(p.postnet.cbhg)))
        out.update(_under("postnet.linear", linear_specs(p.postnet.linear, shard_out=True)))
    return out


def vqvae_param_specs(model):
    """``{parameter name: spec}`` of every parameter of a `models.vqvae.VQVAE`."""
    out = {**_under("asr", asr_specs(model.asr)), **_under("codebook", _fill(model.codebook)),
           "spkr_embed": R, **_under("tts", tts_specs(model.tts))}
    if hasattr(model, "asr_postnet"):
        out.update(_under("asr_postnet", asr_postnet_specs(model.asr_postnet)))
    return out


def replicated_specs(model):
    """Every parameter whole: pure data parallelism (the language models)."""
    return _fill(model)


def _validated(leaf, spec, mesh):
    """``spec``, or whole when a split axis does not divide its dimension."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if dim >= leaf.ndim or leaf.shape[dim] % mesh.shape[axis] != 0:
            return R
    if all(a is None for a in spec):
        return R
    return tuple(spec)


def place_params(model, mesh, specs=None):
    """``{name: spec}`` of every parameter of ``model`` in
    ``named_parameters()`` order, each spec validated against the mesh
    (`_validated`). ``specs`` defaults to `vqvae_param_specs`. Raises
    KeyError where the spec tree and the parameters differ."""
    if specs is None:
        specs = vqvae_param_specs(model)
    params = dict(model.named_parameters())
    if set(specs) != set(params):
        raise KeyError(f"specs and parameters differ: {sorted(set(specs) ^ set(params))[:5]}")
    return {name: _validated(p, specs[name], mesh) for name, p in params.items()}
