"""The port's TTS models (`semi_tts_tpu_torch/models`) against
`semi_tts_tpu.models` on the same weights, moved across by
`semi_tts_tpu_torch.bridge.load_jax_params`. Prenet dropout is set to 0 so
the free-running decode is deterministic on both sides.

The weight trees are drawn in the JAX layout from a seeded port init
(`bridge.to_jax_params`), which is much faster here than JAX's own init; a
tree that JAX's apply functions could not read would fail these tests, and
`tests/test_torch_serve.py` round-trips a tree from JAX's own init."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import REPO
from semi_tts_tpu.models import cbhg as JC
from semi_tts_tpu.models import common as JCommon
from semi_tts_tpu.models import decoder as JD
from semi_tts_tpu.models import encoder as JE
from semi_tts_tpu.models import tts as JT
from semi_tts_tpu.models import vqvae as JV
from semi_tts_tpu.utils.metrics import read_phn_attr
from semi_tts_tpu_torch.bridge import _flatten, load_jax_params, to_jax_params
from semi_tts_tpu_torch.models import cbhg as PC
from semi_tts_tpu_torch.models import common as PCommon
from semi_tts_tpu_torch.models import decoder as PD
from semi_tts_tpu_torch.models import encoder as PE
from semi_tts_tpu_torch.models import vqvae as PV

ATOL = 1e-4  # fp32 on both sides; ~10 autoregressive steps of summation-order drift

MODEL = {  # widths of tests/helpers.tiny_config, l2 codebook, no prenet dropout
    "stop_threshold": 0.5, "max_frames_per_phn": 3, "txt_update_codebook": False,
    "spkr_latent_dim": 8,
    "encoder": {"dim": 16, "kernel": [3, 4], "stride": [1, 2], "residual": [0, 0],
                "dropout": 0.5, "activation": "Tanh", "batch_norm": True, "rnn_bid": True,
                "rnn_layers": 1, "rnn_dim": 8, "layer_norm": False},
    "codebook": {"bone": "l2", "softmax": "normal", "latent_dim": 12, "commit_weight": 0,
                 "vq_weight": 0, "temp": 1, "skip_prob": 0, "stop_grad": True,
                 "phn_attr_pth": f"{REPO}/data/phn_attr.csv", "proj_attr": 4},
    "decoder": {
        "separate_postnet": False,
        "encoder": {"enc_n_conv": 2, "enc_kernel_size": 5, "enc_rnn_layer": 1,
                    "enc_embed_dim": 16, "enc_dropout": 0.0},
        "decoder": {"n_frames_per_step": 3, "prenet_dim": 8, "prenet_dropout": 0.0,
                    "query_rnn_dim": 16, "dec_rnn_dim": 16, "query_dropout": 0.1,
                    "dec_dropout": 0.1, "attn_dim": 8, "n_location_filters": 4,
                    "location_kernel_size": 7, "loc_aware": True,
                    "use_summed_weights": True, "drop_dec_in": 0.0},
    },
}
STEPS = 10


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _jax_weights(module, seed=0):
    """(params, state) in the JAX layout, drawn from a seeded port init, with
    non-trivial BN running statistics so eval-mode normalisation counts."""
    params, state = to_jax_params(module)
    rng = np.random.RandomState(seed)
    state = jax.tree_util.tree_map(
        lambda a: a + rng.rand(*a.shape).astype(np.float32) * 0.5 if a.ndim else a, state)
    return params, state


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def model():
    phn_attr = read_phn_attr(MODEL["codebook"]["phn_attr_pth"])
    kw = dict(n_mels=20, linear_dim=257, vocab_size=43, n_spkr=3, attr_dim=phn_attr.shape[1])
    jcfg = JV.config_from_yaml(MODEL, **kw)
    pcfg = PV.config_from_yaml(MODEL, **kw)
    params, state = _jax_weights(PV.VQVAE(pcfg, generator=_gen(0)))
    port = load_jax_params(PV.VQVAE(pcfg, generator=_gen(1)), params, state)
    return jcfg, pcfg, params, state, port, phn_attr


def _text(B=2, U=7, seed=0):
    rng = np.random.RandomState(seed)
    text = np.zeros((B, U), np.int32)
    for b in range(B):
        n = rng.randint(3, U)
        text[b, :n] = rng.randint(3, 43, size=n)
    return text


def test_embed_text_matches_jax(model):
    jcfg, pcfg, params, _, port, phn_attr = model
    text = _text()
    want = JV.embed_text(params, jcfg, jnp.asarray(phn_attr), jnp.asarray(text))
    got = PV.embed_text(port, pcfg, torch.from_numpy(phn_attr), torch.from_numpy(text).long())
    _close(got, want, atol=1e-6)


def test_encoder_apply_matches_jax(model):
    jcfg, pcfg, params, state, port, _ = model
    x = np.random.RandomState(1).randn(2, 7, 12).astype(np.float32)
    want, _ = JE.encoder_apply(params["tts"]["encoder"], state["tts"]["encoder"],
                               jax.random.PRNGKey(0), jnp.asarray(x), dropout_rate=0.0,
                               train=False)
    got = PE.encoder_apply(port.tts.encoder, torch.from_numpy(x), dropout_rate=0.0)
    _close(got, want)


def test_cbhg_apply_matches_jax(model):
    _, _, params, state, port, _ = model
    x = np.random.RandomState(2).randn(2, 11, 20).astype(np.float32)
    want, _ = JC.cbhg_apply(params["tts"]["postnet"]["cbhg"], state["tts"]["postnet"],
                            jnp.asarray(x), train=False)
    got = PC.cbhg_apply(port.tts.postnet.cbhg, torch.from_numpy(x))
    assert tuple(got.shape) == (2, 11, 40)
    _close(got, want)


def test_tts_apply_matches_jax(model):
    jcfg, pcfg, params, state, port, _ = model
    rng = np.random.RandomState(3)
    lat = rng.randn(2, 7, 12).astype(np.float32)
    spk = rng.randn(2, 8).astype(np.float32)
    lengths = np.array([7, 4])
    mel, lin, align, stop, _ = JT.tts_apply(
        params["tts"], state["tts"], jax.random.PRNGKey(0), jnp.asarray(lat), jnp.asarray(spk),
        cfg=jcfg.tts, decode_steps=STEPS, train=False, teacher=None, tf_rate=0.0,
        txt_lengths=jnp.asarray(lengths))
    got = _port_tts_apply(port, pcfg, lat, spk, lengths)
    for g, w in zip(got, (mel, lin, align, stop)):
        _close(g, w)


def _port_tts_apply(port, pcfg, lat, spk, lengths):
    from semi_tts_tpu_torch.models.tts import tts_apply

    with torch.no_grad():
        return tts_apply(port.tts, torch.from_numpy(lat), torch.from_numpy(spk),
                         cfg=pcfg.tts, decode_steps=STEPS,
                         txt_lengths=torch.from_numpy(lengths))


@pytest.mark.parametrize("mask_attention", [False, True])
@pytest.mark.parametrize("mode", ["adain", "concat", "add", "pretrain"])
def test_decoder_apply_matches_jax(mode, mask_attention):
    base = dict(n_mels=20, n_frames_per_step=3, enc_embed_dim=16, spkr_embed_dim=8,
                prenet_dim=8, prenet_dropout=0.0, query_rnn_dim=16, dec_rnn_dim=16,
                attn_dim=8, n_location_filters=4, location_kernel_size=7,
                spkr_embed_mode="adain" if mode == "pretrain" else mode,
                pretrain=mode == "pretrain", mask_attention=mask_attention)
    jcfg, pcfg = JD.DecoderConfig(**base), PD.DecoderConfig(**base)
    params, _ = _jax_weights(PD.Decoder(pcfg, generator=_gen(2)))
    dec = load_jax_params(PD.Decoder(pcfg, generator=_gen(3)), params, {})
    rng = np.random.RandomState(4)
    memory = rng.randn(2, 9, 16).astype(np.float32)
    spk = rng.randn(2, 8).astype(np.float32)
    lengths = np.array([9, 5])
    want = JD.decoder_apply(params, jax.random.PRNGKey(0), jnp.asarray(memory),
                            jnp.asarray(spk), cfg=jcfg, decode_steps=STEPS, train=False,
                            teacher=None, tf_rate=0.0, memory_lengths=jnp.asarray(lengths))
    with torch.no_grad():
        got = PD.decoder_apply(dec, torch.from_numpy(memory), torch.from_numpy(spk),
                               cfg=pcfg, decode_steps=STEPS,
                               memory_lengths=torch.from_numpy(lengths))
    assert tuple(got[0].shape) == (2, STEPS * 3, 20)
    assert tuple(got[1].shape) == (2, STEPS, 9)
    for g, w in zip(got, want):
        _close(g, w)
    if mask_attention and mode != "pretrain":
        assert np.all(got[1].numpy()[1, :, 5:] == 0.0)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("eps,momentum", [(1e-5, 0.1), (1e-3, 0.99)])  # default, CBHG
def test_batchnorm_matches_jax(train, eps, momentum):
    """Normalisation and, in train mode, the running-state update
    ``(1 - m) * old + m * batch`` with the unbiased batch variance."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 7, 6).astype(np.float32)
    bn = PCommon.BatchNorm(6, eps=eps, momentum=momentum)
    params = {"scale": rng.rand(6).astype(np.float32) + 0.5,
              "bias": rng.randn(6).astype(np.float32)}
    state = {"mean": rng.randn(6).astype(np.float32), "var": rng.rand(6).astype(np.float32) + 0.5,
             "eps": np.float32(eps), "momentum": np.float32(momentum)}
    with torch.no_grad():
        for name in ("scale", "bias"):
            getattr(bn, name).copy_(torch.from_numpy(params[name]))
        for name in ("mean", "var"):
            getattr(bn, name).copy_(torch.from_numpy(state[name]))
    want, new_state = JCommon.batchnorm(params, state, jnp.asarray(x), train=train)
    got = PCommon.batchnorm(bn, torch.from_numpy(x), train=train)
    _close(got, want, atol=1e-5)
    _close(bn.mean, new_state["mean"], atol=1e-6)
    _close(bn.var, new_state["var"], atol=1e-6)


@pytest.mark.parametrize("k,padding", [(3, None), (4, None), (4, 2), (5, 0)])
def test_conv1d_linear_highway_match_jax(k, padding):
    rng = np.random.RandomState(k)
    x = rng.randn(2, 9, 5).astype(np.float32)
    conv = PCommon.Conv1d(5, 4, k, generator=_gen(k))
    params, _ = to_jax_params(conv)
    want = JCommon.conv1d(params, jnp.asarray(x), padding=padding)
    _close(PCommon.conv1d(conv, torch.from_numpy(x), padding=padding), want, atol=1e-5)
    hw = PCommon.Highway(5, 5, generator=_gen(k))
    params, _ = to_jax_params(hw)
    _close(PCommon.highway(hw, torch.from_numpy(x)), JCommon.highway(params, jnp.asarray(x)),
           atol=1e-5)
    lin = PCommon.Linear(5, 3, generator=_gen(k))
    params, _ = to_jax_params(lin)
    _close(PCommon.linear(lin, torch.from_numpy(x)), JCommon.linear(params, jnp.asarray(x)),
           atol=1e-5)


def test_config_from_yaml_mirrors_jax(model):
    jcfg, pcfg, *_ = model
    assert dataclasses.asdict(pcfg.tts) == dataclasses.asdict(jcfg.tts)
    assert dataclasses.asdict(pcfg.codebook) == dataclasses.asdict(jcfg.codebook)
    for name in ("n_mels", "linear_dim", "vocab_size", "n_spkr", "spkr_latent_dim",
                 "n_frames_per_step", "latent_dim"):
        assert getattr(pcfg, name) == getattr(jcfg, name), name


def _jax_coins(key, steps):
    """The scheduled-sampling coins JAX `decoder_apply` draws from ``key``:
    the scan key of its 4-way split, split 5 ways a step, the 5th uniform."""
    _, _, _, rng = jax.random.split(key, 4)
    coins = []
    for _ in range(steps):
        rng, _, _, _, k_coin = jax.random.split(rng, 5)
        coins.append(np.asarray(jax.random.uniform(k_coin, (2,))))
    return np.stack(coins)


def _train_decoder(drop_dec_in=0.0):
    """A decoder with every dropout 0 (prenet included), its JAX weights, and
    seeded memory, speaker embeddings, teacher and output cotangents."""
    base = dict(n_mels=20, n_frames_per_step=3, enc_embed_dim=16, spkr_embed_dim=8,
                prenet_dim=8, prenet_dropout=0.0, query_rnn_dim=16, dec_rnn_dim=16,
                query_dropout=0.0, dec_dropout=0.0, attn_dim=8, n_location_filters=4,
                location_kernel_size=7, drop_dec_in=drop_dec_in)
    jcfg, pcfg = JD.DecoderConfig(**base), PD.DecoderConfig(**base)
    params, _ = _jax_weights(PD.Decoder(pcfg, generator=_gen(4)))
    dec = load_jax_params(PD.Decoder(pcfg, generator=_gen(5)), params, {})
    rng = np.random.RandomState(6)
    B, L, steps = 3, 9, 8
    arrays = dict(memory=rng.randn(B, L, 16), spk=rng.randn(B, 8),
                  teacher=rng.randn(B, 18, 20),          # 6 frame groups: steps 6, 7 reuse the last
                  gm=rng.randn(B, steps * 3, 20), ga=rng.randn(B, steps, L),
                  gs=rng.randn(B, steps * 3))
    return jcfg, pcfg, params, dec, {k: v.astype(np.float32) for k, v in arrays.items()}, steps


def _port_decoder_grads(dec, pcfg, a, steps, *, probes, **kw):
    """Outputs and gradients (by parameter name, and of memory and speaker
    embeddings) of sum(mel*gm) + sum(align*ga) + sum(stop*gs), through the
    probes or through plain autograd."""
    memory, spk = (torch.from_numpy(a[k]).requires_grad_(True) for k in ("memory", "spk"))
    pr = PD.wgrad_probes(pcfg, steps, memory.shape[0]) if probes else None
    out = PD.decoder_apply(dec, memory, spk, cfg=pcfg, decode_steps=steps, train=True,
                           teacher=torch.from_numpy(a["teacher"]), wgrad_probes=pr, **kw)
    loss = sum((o * torch.from_numpy(a[k])).sum() for o, k in zip(out, ("gm", "ga", "gs")))
    names, params = zip(*dec.named_parameters())
    extra = [memory, spk] + ([pr["q"], pr["d"]] if probes else [])
    grads = torch.autograd.grad(loss, list(params) + extra, allow_unused=True)
    by_param = dict(zip(params, grads[:len(params)]))
    if probes:
        PD.merge_wgrads(dec, by_param, out[3], {"q": grads[-2], "d": grads[-1]})
    named = {n: by_param[p] for n, p in zip(names, params)}
    return out[:3], named, grads[len(params)], grads[len(params) + 1]


@pytest.mark.parametrize("tf_rate,rows,drop_dec_in", [(1.0, None, 0.0), (0.5, (1, 0, 1), 0.5),
                                                      (0.0, None, 0.0)])
def test_decoder_training_matches_jax(tf_rate, rows, drop_dec_in):
    """`decoder_apply(train=True)` teacher-forced, with ``teacher_rows`` and
    the coins JAX draws passed as ``coins=``, through the weight-gradient
    probes: outputs, every parameter gradient (the cells' weights from
    `merge_wgrads`) and the memory and speaker gradients against JAX
    `decoder_apply(train=True, wgrad_probes=...)` + `merge_wgrads`."""
    jcfg, pcfg, params, dec, a, steps = _train_decoder(drop_dec_in)
    key = jax.random.PRNGKey(11)
    t_rows = None if rows is None else np.asarray(rows, bool)

    def f(p, probes, memory, spk):
        mel, align, stop, aux = JD.decoder_apply(
            p, key, memory, spk, cfg=jcfg, decode_steps=steps, train=True,
            teacher=jnp.asarray(a["teacher"]),
            teacher_rows=None if t_rows is None else jnp.asarray(t_rows), tf_rate=tf_rate,
            wgrad_probes=probes)
        loss = jnp.sum(mel * a["gm"]) + jnp.sum(align * a["ga"]) + jnp.sum(stop * a["gs"])
        return loss, ((mel, align, stop), aux)

    probes = JD.wgrad_probes(jcfg, steps, 3)
    (_, (want_out, aux)), (gp, gpr, gmem, gspk) = jax.value_and_grad(
        f, argnums=(0, 1, 2, 3), has_aux=True)(params, probes, jnp.asarray(a["memory"]),
                                               jnp.asarray(a["spk"]))
    want = _flatten(JD.merge_wgrads(
        jax.tree_util.tree_map(np.asarray, gp), aux, gpr))
    coins = _jax_coins(key, steps)
    if tf_rate == 0.5:  # the case mixes teacher and own steps
        assert (coins[:, 0] > tf_rate).any() and (coins[:, 0] <= tf_rate).any()
    out, grads, g_mem, g_spk = _port_decoder_grads(
        dec, pcfg, a, steps, probes=True, coins=torch.from_numpy(coins), tf_rate=tf_rate,
        teacher_rows=None if t_rows is None else torch.from_numpy(t_rows))
    for g, w in zip(out, want_out):
        _close(g, w)
    for name, g in grads.items():
        _close(g, want[name.replace(".", "/")], atol=ATOL)
    _close(g_mem, gmem)
    _close(g_spk, gspk)


def test_decoder_probes_match_plain_autograd():
    """The two routes to the cells' weight gradients agree: the probes with
    `merge_wgrads`, and autograd through the undetached weights (outputs
    bit-identical, gradients within fp32 summation order)."""
    _, pcfg, _, dec, a, steps = _train_decoder(drop_dec_in=0.5)
    coins = torch.from_numpy(np.random.RandomState(9).rand(steps, 2).astype(np.float32))
    kw = dict(coins=coins, tf_rate=0.5, teacher_rows=torch.tensor([True, False, True]))
    out_p, grads_p, mem_p, spk_p = _port_decoder_grads(dec, pcfg, a, steps, probes=True, **kw)
    out_a, grads_a, mem_a, spk_a = _port_decoder_grads(dec, pcfg, a, steps, probes=False, **kw)
    for g, w in zip(out_p, out_a):
        assert torch.equal(g, w)
    assert grads_a["query_rnn.w_ih"] is not None
    for name in grads_a:
        torch.testing.assert_close(grads_p[name], grads_a[name], rtol=0, atol=1e-5, msg=name)
    torch.testing.assert_close(mem_p, mem_a, rtol=0, atol=1e-5)
    torch.testing.assert_close(spk_p, spk_a, rtol=0, atol=1e-5)


def test_decoder_training_dropout_and_coins_from_the_generator():
    """With dropout on and no ``coins``, the step's generator draws the
    cells' dropout, the prenet masks and the coins: the same seed gives the
    same outputs, another seed other ones, and tf_rate 0 ignores the
    teacher."""
    _, pcfg, _, dec, a, steps = _train_decoder()
    pcfg = dataclasses.replace(pcfg, prenet_dropout=0.5, query_dropout=0.1, dec_dropout=0.1)
    mem, spk, teacher = (torch.from_numpy(a[k]) for k in ("memory", "spk", "teacher"))

    def run(seed, tf_rate=0.5, teacher=teacher):
        with torch.no_grad():
            return PD.decoder_apply(dec, mem, spk, cfg=pcfg, decode_steps=steps, train=True,
                                    teacher=teacher, tf_rate=tf_rate,
                                    generator=torch.Generator().manual_seed(seed))[0]

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    assert torch.equal(run(3, tf_rate=0.0), run(3, tf_rate=0.0, teacher=teacher * 2.0))
