"""The port's ASR half (`semi_tts_tpu_torch/models/asr.py`, `embed.py`
`codebook_forward`, `vqvae.py` `speech_to_text`) against
`semi_tts_tpu.models` on the same weights, moved across by the bridge."""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_tts_tpu.models import asr as JA
from semi_tts_tpu.models import embed as JB
from semi_tts_tpu.models import vqvae as JV
from semi_tts_tpu.utils.metrics import read_phn_attr
from semi_tts_tpu_torch import bridge
from semi_tts_tpu_torch.models import asr as PA
from semi_tts_tpu_torch.models import embed as PB
from semi_tts_tpu_torch.models import vqvae as PV
from test_torch_models import MODEL, _jax_weights

ATOL = 1e-5  # fp32 both sides; convolution, LSTM and softmax sums in another order
ENC = dict(MODEL["encoder"], kernel=[3, 4, 3], stride=[1, 2, 1], residual=[0, 0, 1],
           rnn_layers=2, dropout=0.0)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _model(bone="l2", **enc):
    model_cfg = copy.deepcopy(MODEL)
    model_cfg["encoder"] = dict(ENC, **enc)
    model_cfg["codebook"]["bone"] = bone
    phn_attr = read_phn_attr(MODEL["codebook"]["phn_attr_pth"])
    kw = dict(n_mels=20, linear_dim=257, vocab_size=43, n_spkr=3, attr_dim=phn_attr.shape[1])
    jcfg, pcfg = JV.config_from_yaml(model_cfg, **kw), PV.config_from_yaml(model_cfg, **kw)
    params, state = _jax_weights(PV.VQVAE(pcfg, generator=_gen(0)))
    port = bridge.load_jax_params(PV.VQVAE(pcfg, generator=_gen(1)), params, state)
    return jcfg, pcfg, params, state, port, phn_attr


def _mel(B=3, T=16, seed=0):
    return np.random.RandomState(seed).rand(B, T, 20).astype(np.float32)


@pytest.mark.parametrize("train", [False, True])
def test_asr_apply_matches_jax(train):
    """Eval mode uses the running statistics; train mode (dropout 0)
    normalizes with the batch's and updates the running ones in place, as
    the new JAX state."""
    jcfg, pcfg, params, state, port, _ = _model()
    x = _mel()
    want, new_state = JA.asr_apply(params["asr"], state["asr"], jax.random.PRNGKey(0),
                                   jnp.asarray(x), cfg=jcfg.encoder, train=train)
    got = PA.asr_apply(port.asr, _t(x), cfg=pcfg.encoder, train=train)
    assert tuple(got.shape) == (3, 8, 12)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    for i, bn in enumerate(port.asr.bn):
        for name in ("mean", "var"):
            np.testing.assert_allclose(getattr(bn, name).numpy(),
                                       np.asarray(new_state["bn"][i][name]), rtol=0, atol=ATOL)


def test_asr_apply_grad_matches_jax():
    jcfg, pcfg, params, state, port, _ = _model()
    x = _mel(seed=1)
    probe = np.random.RandomState(2).randn(3, 8, 12).astype(np.float32)

    def f(p):
        y, _ = JA.asr_apply(p, state["asr"], jax.random.PRNGKey(0), jnp.asarray(x),
                            cfg=jcfg.encoder, train=True)
        return jnp.sum(y * probe)

    want = jax.grad(f)(params["asr"])
    (PA.asr_apply(port.asr, _t(x), cfg=pcfg.encoder, train=True) * _t(probe)).sum().backward()
    got = {n: p.grad.numpy() for n, p in port.asr.named_parameters()}
    flat = bridge._flatten(jax.tree_util.tree_map(np.asarray, want))
    assert set(flat) == {n.replace(".", "/") for n in got}
    for name, g in got.items():
        np.testing.assert_allclose(g, flat[name.replace(".", "/")], rtol=0, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("bone,stop_grad", [("l2", True), ("l2", False), ("seperate", True),
                                            ("seperate", False)])
def test_codebook_forward_matches_jax(bone, stop_grad):
    """p_code, quantized and the gradients of a probe through the
    straight-through path, both bones, with and without stop_grad."""
    jcfg, pcfg, params, _, port, phn_attr = _model(bone)
    jcb = JB.CodebookConfig(**{**jcfg.codebook.__dict__, "stop_grad": stop_grad})
    pcb = PB.CodebookConfig(**{**pcfg.codebook.__dict__, "stop_grad": stop_grad})
    rng = np.random.RandomState(3)
    enc = rng.randn(2, 5, 12).astype(np.float32)
    probes = rng.randn(2, 5, 43).astype(np.float32), rng.randn(2, 5, 12).astype(np.float32)

    def f(p, e):
        pc, q = JB.codebook_forward(p, jcb, e, phn_attr=jnp.asarray(phn_attr))
        return jnp.sum(pc * probes[0]) + jnp.sum(q * probes[1]), (pc, q)

    (_, (want_p, want_q)), (want_gp, want_ge) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params["codebook"], jnp.asarray(enc))
    e = _t(enc).requires_grad_(True)
    p_code, q = PB.codebook_forward(port.codebook, pcb, e, phn_attr=_t(phn_attr))
    ((p_code * _t(probes[0])).sum() + (q * _t(probes[1])).sum()).backward()
    np.testing.assert_allclose(p_code.detach().numpy(), np.asarray(want_p), rtol=0, atol=ATOL)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(want_q), rtol=0, atol=ATOL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want_ge), rtol=0, atol=1e-4)
    flat = bridge._flatten(jax.tree_util.tree_map(np.asarray, want_gp))
    for name, prm in port.codebook.named_parameters():
        g = prm.grad.numpy() if prm.grad is not None else np.zeros(prm.shape, np.float32)
        np.testing.assert_allclose(g, flat[name.replace(".", "/")], rtol=0, atol=1e-4,
                                   err_msg=name)


def test_codebook_first_n_real_mel_detaches_the_table():
    jcfg, pcfg, params, _, port, phn_attr = _model()
    enc = np.random.RandomState(4).randn(3, 4, 12).astype(np.float32)
    f = lambda p: jnp.sum(JB.codebook_forward(p, jcfg.codebook, jnp.asarray(enc),
                                              phn_attr=jnp.asarray(phn_attr),
                                              first_n_real_mel=1)[0] ** 2)
    want = jax.grad(f)(params["codebook"])["learnable_table"]
    p_code, _ = PB.codebook_forward(port.codebook, pcfg.codebook, _t(enc), phn_attr=_t(phn_attr),
                                    first_n_real_mel=1)
    (p_code ** 2).sum().backward()
    np.testing.assert_allclose(port.codebook.learnable_table.grad.numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_speech_to_text_matches_jax(train):
    jcfg, pcfg, params, state, port, phn_attr = _model()
    x = _mel(B=2, T=12, seed=5)
    want = JV.speech_to_text(params, state, jax.random.PRNGKey(1), jcfg, jnp.asarray(phn_attr),
                             jnp.asarray(x), paired_bs=2, train=train)
    got = PV.speech_to_text(port, pcfg, _t(phn_attr), _t(x), paired_bs=2, train=train)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=ATOL)
    assert got[2] is None and want[2] is None


def test_asr_postnet_matches_jax():
    """Ported though the flagship config turns it off: (B, T, D) -> log
    posteriors over ``latent_dim`` classes, eval mode."""
    params = JA.asr_postnet_init(jax.random.PRNGKey(6), 12, 12)
    post = bridge.load_jax_params(PA.ASRPostnet(12, 12),
                                  jax.tree_util.tree_map(np.asarray, params), {})
    x = np.random.RandomState(7).randn(2, 5, 12).astype(np.float32)
    want = JA.asr_postnet_apply(params, jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    got = PA.asr_postnet_apply(post, _t(x), train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_bridge_round_trip_includes_asr():
    """params and BN state, the ``asr`` subtree included, carry across whole
    in both directions; a tree without it is refused."""
    _, pcfg, params, state, port, _ = _model()
    assert "asr" in params and "asr" in state
    p2, s2 = bridge.to_jax_params(port)
    assert jax.tree_util.tree_structure(p2) == jax.tree_util.tree_structure(params)
    assert jax.tree_util.tree_structure(s2) == jax.tree_util.tree_structure(state)
    for got, want in zip(jax.tree_util.tree_leaves((p2, s2)),
                         jax.tree_util.tree_leaves((params, state))):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError, match="asr/"):
        bridge.load_jax_params(PV.VQVAE(pcfg, generator=_gen(2)),
                               {k: v for k, v in params.items() if k != "asr"}, state)
    bad = copy.deepcopy(params)
    del bad["asr"]["convs"][0]["b"]
    with pytest.raises(KeyError, match="asr/convs/0/b"):
        bridge.load_jax_params(PV.VQVAE(pcfg, generator=_gen(3)), bad, state)
