"""The port's language models and speaker encoder (`semi_tts_tpu_torch/models/lm.py`,
`models/speaker.py`) against `semi_tts_tpu.models.lm` and `models.speaker`
on the same weights (moved by `bridge.to_jax_params`) and the same seeded
numpy inputs: outputs, and the gradients of a seeded linear functional of
them (`jax.grad` against `torch.autograd`), parameter by parameter.

Tolerances: RTOL 1e-5 forward and GRAD_RTOL 1e-4 for gradients, fp32 on both
sides in another summation order; ATOL/GRAD_ATOL absorb entries near 0. The
audio LM runs a ~6-step autoregressive decode and a CBHG and is held to the
decoder tests' 1e-4 (test_torch_models.py ATOL) forward and backward."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_tts_tpu.models import decoder as JD
from semi_tts_tpu.models import lm as JL
from semi_tts_tpu.models import speaker as JS
from semi_tts_tpu_torch.bridge import _flatten, load_jax_params, to_jax_params
from semi_tts_tpu_torch.kernels import rnn as KR
from semi_tts_tpu_torch.models import decoder as PD
from semi_tts_tpu_torch.models import lm as PL
from semi_tts_tpu_torch.models import speaker as PS
from test_torch_models import _jax_coins

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
AUDIO_ATOL = 1e-4
V = 11


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _text(B=3, U=7, seed=0):
    """Token rows with a <sos> of 1 and 2..U-1 real tokens, zero padded."""
    rng = np.random.RandomState(seed)
    text = np.zeros((B, U), np.int64)
    lens = rng.randint(3, U + 1, size=B)
    lens[0] = U
    for b, n in enumerate(lens):
        text[b, 0] = 1
        text[b, 1:n] = rng.randint(3, V, size=n - 1)
    return text, (text != 0).sum(-1)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol, err_msg=what)




def _grads_match(module, torch_loss, jax_loss, params, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    """The gradient of ``torch_loss()`` with respect to every parameter of
    ``module`` against ``jax.grad(jax_loss)(params)``, leaf by leaf."""
    names, ps = zip(*module.named_parameters())
    got = torch.autograd.grad(torch_loss(), ps, allow_unused=True)
    want = _flatten(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(jax_loss))(params)))
    assert set(want) == {n.replace(".", "/") for n in names}
    for n, g in zip(names, got):
        w = want[n.replace(".", "/")]
        _close(torch.zeros(w.shape) if g is None else g, w, rtol, atol, n)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnnlm_matches_jax(cell):
    """RNNLM with two LSTM or GRU layers: log-probs, the masked next-token
    NLL and its gradient."""
    m = PL.RNNLM(V, 6, module=cell, dim=8, n_layers=2, generator=_gen(0))
    params, _ = to_jax_params(m)
    text, tlen = _text()
    got = PL.rnnlm_apply(m, torch.from_numpy(text))
    want = JL.rnnlm_apply(params, jax.random.PRNGKey(0), jnp.asarray(text), module=cell)
    _close(got, want)
    _close(PL.rnnlm_loss(m, torch.from_numpy(text), torch.from_numpy(tlen)),
           JL.rnnlm_loss(params, None, jnp.asarray(text), jnp.asarray(tlen), module=cell))
    _grads_match(m, lambda: PL.rnnlm_loss(m, torch.from_numpy(text), torch.from_numpy(tlen)),
                 lambda p: JL.rnnlm_loss(p, None, jnp.asarray(text), jnp.asarray(tlen),
                                         module=cell), params)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnnlm_default_width_is_past_the_kernels_plans(cell):
    """RNNLM's default 512 units are past K1/K7's 288 and K2/K8's 128: the
    plan its first launch on the card asks for raises (no fallback)."""
    H = PL.RNNLM(V, 6, module=cell).rnn[0].w_hh.shape[1]
    assert H == 512
    with pytest.raises(ValueError, match="H=512"):
        if cell == "lstm":
            KR.lstm_plan(8, H, 1, max_clusters=15)
        else:
            KR.gru_plan(8, H, 1)


def test_textlm_matches_jax():
    """TextLM (one LSTM layer, the codebook table as its output layer):
    log-probs with EPS, the loss and every gradient, the table's included."""
    m = PL.TextLM(V, 8, rnn_dim=12, generator=_gen(1))
    params, _ = to_jax_params(m)
    text, tlen = _text(seed=1)
    _close(PL.textlm_apply(m, torch.from_numpy(text)), JL.textlm_apply(params, jnp.asarray(text)))
    args = (torch.from_numpy(text), torch.from_numpy(tlen))
    _close(PL.textlm_loss(m, *args), JL.textlm_loss(params, jnp.asarray(text), jnp.asarray(tlen)))
    _grads_match(m, lambda: PL.textlm_loss(m, *args),
                 lambda p: JL.textlm_loss(p, jnp.asarray(text), jnp.asarray(tlen)), params)


def test_textlm_loss_masks_past_each_rows_length():
    """Tokens past a row's length change neither the loss nor its gradient."""
    m = PL.TextLM(V, 8, rnn_dim=12, generator=_gen(2))
    text, tlen = _text(seed=2)
    assert tlen.min() < text.shape[1]
    noisy = text.copy()
    for b, n in enumerate(tlen):
        noisy[b, n:] = 5
    a = PL.textlm_loss(m, torch.from_numpy(text), torch.from_numpy(tlen))
    b = PL.textlm_loss(m, torch.from_numpy(noisy), torch.from_numpy(tlen))
    assert torch.equal(a, b)


def test_denoising_lm_matches_jax():
    m = PL.DenoisingLM(V, 5, 6, channels=7, n_conv=3, generator=_gen(3))
    params, _ = to_jax_params(m)
    text, _ = _text(seed=3)
    cot = np.random.RandomState(3).randn(3, 7, V).astype(np.float32)
    _close(PL.denoising_lm_apply(m, torch.from_numpy(text)),
           JL.denoising_lm_apply(params, jnp.asarray(text)))
    _grads_match(m, lambda: (PL.denoising_lm_apply(m, torch.from_numpy(text))
                             * torch.from_numpy(cot)).sum(),
                 lambda p: jnp.sum(JL.denoising_lm_apply(p, jnp.asarray(text)) * cot), params)


def _ngram_table(n, seed):
    rng = np.random.RandomState(seed)
    t = rng.rand(*((V,) if n == 1 else (V ** (n - 1), V))).astype(np.float32)
    return t / t.sum(-1, keepdims=True)


@pytest.mark.parametrize("reduction", ["token", "sentence", "batch"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_ngram_prior_matches_jax(n, reduction):
    """The loss and its gradient with respect to the posteriors, padded
    frames past each row's length included."""
    rng = np.random.RandomState(10 * n)
    logits = rng.randn(3, 9, V).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    enc_len = np.asarray([9, 6, 4], np.int32)
    table = _ngram_table(n, n) + JL.EPS
    jp = JL.NgramPrior(V, n, 1.0, reduction)
    pp = PL.NgramPrior(V, n, 1.0, reduction)

    def jloss(p):
        return jp.compute_loss(jnp.asarray(table), p, jnp.asarray(enc_len))

    x = torch.from_numpy(prob).requires_grad_(True)
    got = pp.compute_loss(torch.from_numpy(table), x, torch.from_numpy(enc_len).long())
    _close(got, jloss(jnp.asarray(prob)))
    (g,) = torch.autograd.grad(got, x)
    _close(g, jax.grad(jloss)(jnp.asarray(prob)), GRAD_RTOL, GRAD_ATOL)


def test_ngram_load_table(tmp_path):
    path = str(tmp_path / "bigram.npy")
    np.save(path, _ngram_table(2, 0))
    _close(PL.NgramPrior.load_table(path), JL.NgramPrior.load_table(path), 0, 0)


DEC = dict(n_mels=8, n_frames_per_step=3, enc_embed_dim=6, spkr_embed_dim=4, prenet_dim=8,
           prenet_dropout=0.0, query_rnn_dim=12, dec_rnn_dim=12, query_dropout=0.0,
           dec_dropout=0.0, attn_dim=4, n_location_filters=2, location_kernel_size=5,
           drop_dec_in=0.5)


@pytest.mark.parametrize("linear_dim", [None, 17])
def test_audiolm_matches_jax(linear_dim):
    """AudioLM teacher-forced in train mode through the decoder's
    weight-gradient probes (dropout 0, drop_dec_in 0.5 so that the coins
    JAX draws, passed as ``coins=``, pick the teacher's mean on some
    steps): mel and linear predictions, the postnet's new BatchNorm
    statistics, and every parameter's gradient (the cells' weights from
    `merge_wgrads`)."""
    jcfg, pcfg = JD.DecoderConfig(**DEC), PD.DecoderConfig(**DEC)
    m = PL.AudioLM(pcfg, linear_dim, generator=_gen(4))
    params, state = to_jax_params(m)
    rng = np.random.RandomState(4)
    B, steps = 2, 6
    mel = rng.randn(B, steps * 3, 8).astype(np.float32)
    cot_m = rng.randn(B, steps * 3, 8).astype(np.float32)
    cot_l = rng.randn(B, steps * 3, linear_dim or 1).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jdec = JL.audiolm_init(jax.random.PRNGKey(0), jcfg, linear_dim)[2]
    coins = _jax_coins(key, steps)
    assert (coins[:, 1] < 0.5).any() and (coins[:, 1] >= 0.5).any()

    def jloss(p, probes):
        mp, lp, st, aux = JL.audiolm_apply(p, state, key, jnp.asarray(mel), dec_cfg=jdec,
                                           train=True, wgrad_probes=probes)
        loss = jnp.sum(mp * cot_m) + (0.0 if lp is None else jnp.sum(lp * cot_l))
        return loss, (mp, lp, st, aux)

    (_, (want_m, want_l, want_st, aux)), (gp, gpr) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, JD.wgrad_probes(jdec, steps, B))
    want = _flatten(jax.tree_util.tree_map(np.asarray, gp))
    want.update({f"decoder/{k}": v for k, v in _flatten(JD.merge_wgrads(
        jax.tree_util.tree_map(np.asarray, gp["decoder"]), aux, gpr)).items()})

    probes = PD.wgrad_probes(pcfg, steps, B)
    mp, lp, p_aux = PL.audiolm_apply(m, torch.from_numpy(mel), coins=torch.from_numpy(coins),
                                     wgrad_probes=probes)
    loss = (mp * torch.from_numpy(cot_m)).sum()
    if linear_dim:
        loss = loss + (lp * torch.from_numpy(cot_l)).sum()
    _close(mp, want_m, 0, AUDIO_ATOL)
    assert (lp is None) == (want_l is None)
    if linear_dim:
        _close(lp, want_l, 0, AUDIO_ATOL)
    names, ps = zip(*m.named_parameters())
    *grads, gq, gd = torch.autograd.grad(loss, list(ps) + [probes["q"], probes["d"]],
                                         allow_unused=True)
    by = PD.merge_wgrads(m.decoder, dict(zip(ps, grads)), p_aux, {"q": gq, "d": gd})
    for n, p in zip(names, ps):
        g = by[p]
        _close(torch.zeros(p.shape) if g is None else g, want[n.replace(".", "/")], 0,
               AUDIO_ATOL, n)
    got_state = _flatten(to_jax_params(m)[1])
    assert set(got_state) == set(_flatten(want_st))
    for k, v in _flatten(want_st).items():
        _close(got_state[k], v, RTOL, ATOL, k)


def test_audiolm_eval_uses_running_statistics():
    """In eval mode the postnet normalizes with its running statistics and
    leaves them as they were (JAX's ``train=False``)."""
    jcfg, pcfg = JD.DecoderConfig(**DEC), PD.DecoderConfig(**DEC)
    m = PL.AudioLM(pcfg, 17, generator=_gen(5))
    params, state = to_jax_params(m)
    rng = np.random.RandomState(5)
    state = jax.tree_util.tree_map(lambda a: a + rng.rand(*a.shape).astype(np.float32) * 0.5
                                   if a.ndim else a, state)
    load_jax_params(m, params, state)
    mel = rng.randn(2, 12, 8).astype(np.float32)
    jdec = JL.audiolm_init(jax.random.PRNGKey(0), jcfg, 17)[2]
    key = jax.random.PRNGKey(1)
    wm, wl, _ = JL.audiolm_apply(params, state, key, jnp.asarray(mel), dec_cfg=jdec, train=False)
    before = [b.clone() for b in m.buffers()]
    with torch.no_grad():
        gm, gl = PL.audiolm_apply(m, torch.from_numpy(mel), train=False,
                                  coins=torch.from_numpy(_jax_coins(key, 4)))
    _close(gm, wm, 0, AUDIO_ATOL)
    _close(gl, wl, 0, AUDIO_ATOL)
    assert all(torch.equal(a, b) for a, b in zip(before, m.buffers()))


def test_audiolm_trees_match_jax_init():
    """The port's AudioLM has the JAX init's param and state leaves, of the
    same shapes, and takes them back through the bridge."""
    jcfg, pcfg = JD.DecoderConfig(**DEC), PD.DecoderConfig(**DEC)
    jp, js, _ = JL.audiolm_init(jax.random.PRNGKey(0), jcfg, 17)
    jp, js = (jax.tree_util.tree_map(np.asarray, t) for t in (jp, js))
    m = load_jax_params(PL.AudioLM(pcfg, 17, generator=_gen(6)), jp, js)
    got_p, got_s = to_jax_params(m)
    for got, want in ((got_p, jp), (got_s, js)):
        fg, fw = _flatten(got), _flatten(want)
        assert sorted(fg) == sorted(fw)
        for k in fw:
            np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_speaker_encoder_matches_jax(train):
    """SpeakerEncoder in train mode (batch statistics, running ones updated;
    dropout 0) and eval mode (running statistics): the pooled embedding,
    the new BatchNorm state and the gradients."""
    m = PS.SpeakerEncoder(8, 10, 3, [6, 7], generator=_gen(7))
    params, state = to_jax_params(m)
    rng = np.random.RandomState(7)
    state = jax.tree_util.tree_map(lambda a: a + rng.rand(*a.shape).astype(np.float32) * 0.5
                                   if a.ndim else a, state)
    x = rng.randn(3, 13, 8).astype(np.float32)
    cot = rng.randn(3, 10).astype(np.float32)

    def jrun(p):
        return JS.speaker_encoder_apply(p, state, jax.random.PRNGKey(0), jnp.asarray(x),
                                        drop_rate=0.0, train=train)

    want, want_st = jrun(params)
    load_jax_params(m, params, state)
    got = PS.speaker_encoder_apply(m, torch.from_numpy(x), drop_rate=0.0, train=train)
    _close(got, want)
    got_st = _flatten(to_jax_params(m)[1])
    for k, v in _flatten(jax.tree_util.tree_map(np.asarray, want_st)).items():
        _close(got_st[k], v, RTOL, ATOL, k)
    load_jax_params(m, params, state)
    _grads_match(m, lambda: (PS.speaker_encoder_apply(m, torch.from_numpy(x), drop_rate=0.0,
                                                      train=train) * torch.from_numpy(cot)).sum(),
                 lambda p: jnp.sum(jrun(p)[0] * cot), params)


def test_speaker_encoder_dropout_draws_from_the_generator():
    m = PS.SpeakerEncoder(8, 10, 3, [6], generator=_gen(8))
    x = torch.from_numpy(np.random.RandomState(8).randn(2, 9, 8).astype(np.float32))
    a, b, c = (PS.speaker_encoder_apply(m, x, drop_rate=0.5, train=True, generator=_gen(s))
               for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
