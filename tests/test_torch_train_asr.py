"""The port's ASR training (`semi_tts_tpu_torch/train/optim.py`,
`steps.py`, `train_asr.py`) against the JAX package: the optimizer chain
against `semi_tts_tpu.train.optim.make_optimizer`, ASR steps from bridged
weights against a JAX ``value_and_grad`` of the same loss plus the optax
update, and `cal_per`."""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers import synthesize_speech
from semi_tts_tpu.models import vqvae as JV
from semi_tts_tpu.ops.features import AudioConfig as JAudio
from semi_tts_tpu.ops.features import AudioFeaturizer as JFeat
from semi_tts_tpu.train.optim import make_optimizer
from semi_tts_tpu.train.steps import StepBuilder as JBuilder
from semi_tts_tpu.train.steps import Weights
from semi_tts_tpu.utils.metrics import cal_per as j_cal_per
from semi_tts_tpu_torch import bridge
from semi_tts_tpu_torch.ops.features import AudioConfig as PAudio
from semi_tts_tpu_torch.ops.features import AudioFeaturizer as PFeat
from semi_tts_tpu_torch.train import optim as PO
from semi_tts_tpu_torch.train.steps import StepBuilder as PBuilder
from semi_tts_tpu_torch.train.train_asr import AsrTrainer, make_asr_step
from semi_tts_tpu_torch.utils.metrics import cal_per as p_cal_per
from test_torch_asr import _model
from test_torch_features import CFG

ATOL = 1e-5  # parameters after a step: fp32 on both sides


def _flat(tree):
    return bridge._flatten(jax.tree_util.tree_map(np.asarray, tree))


def test_optimizer_matches_optax():
    """Clip 5 -> Adam -> Noam decay -> skip non-finite, over four steps: a
    small step, a clipped one (norm 40), a non-finite one (skipped: params,
    moments and counts kept) and a small one."""
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (s * rng.randn(*v.shape)).astype(np.float32) for k, v in params.items()}
             for s in (0.3, 10.0, 1.0, 0.5)]
    grads[2]["b"][1] = np.nan
    tx, _ = make_optimizer("Adam", lr=1.0, lr_scheduler="decay")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = PO.Optimizer(tp, lr=1.0, lr_scheduler="decay")
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        gnorm = opt.step([torch.from_numpy(g[k]) for k in ("a", "b")])
        np.testing.assert_allclose(float(gnorm), float(optax.global_norm(g)), rtol=1e-6)
        for k, t in zip(("a", "b"), tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
    adam = state.inner_state[1]
    assert int(opt.count) == int(adam.count) == 3
    assert int(opt.schedule_count) == int(state.inner_state[-1].count) == 3
    assert int(opt.total_notfinite) == int(state.total_notfinite) == 1
    for k, m, n in zip(("a", "b"), opt.views(opt.mu), opt.views(opt.nu)):
        np.testing.assert_allclose(m.numpy(), np.asarray(adam.mu[k]), rtol=0, atol=1e-7)
        np.testing.assert_allclose(n.numpy(), np.asarray(adam.nu[k]), rtol=0, atol=1e-7)


@pytest.mark.parametrize("name", ["decay", "warmup", "fixed"])
def test_lr_schedules_match_jax(name):
    from semi_tts_tpu.train.optim import make_lr_schedule, tf_rate_schedule

    want = make_lr_schedule(1e-3, name)
    got = PO.make_lr_schedule(1e-3, name)
    for s in (0, 1, 2, 999, 5000):
        np.testing.assert_allclose(float(got(torch.tensor(float(s)))),
                                   float(want(jnp.int32(s))), rtol=1e-6)
    for step in (0, 4, 10, 20):
        assert PO.tf_rate_schedule(1.0, 0.5, 10)(step) == tf_rate_schedule(1.0, 0.5, 10)(step)


def _batch(B=2, S=11025, U=6, seed=0):
    rng = np.random.RandomState(seed)
    lengths = np.asarray([S, S - 3000][:B], np.int32)
    waves = np.zeros((B, S), np.float32)
    for b, n in enumerate(lengths):
        waves[b, :n] = synthesize_speech(n / 22050, seed=seed + b)[:n]
    text = np.zeros((B, U), np.int32)
    for b in range(B):
        n = rng.randint(3, U + 1)
        text[b, :n] = rng.randint(3, 43, size=n)
    snrs = rng.uniform(10, 100, size=B).astype(np.float32)
    rate = np.float32(rng.uniform(0.9, 1.1))
    return waves, lengths, text, snrs, rate


def test_asr_steps_match_jax():
    """Two ASR steps (dropout 0, the same snrs/rate/noise given to both)
    from one bridged weight tree: loss, grad norm, every parameter and BN
    statistic after each step, pair_pred_len, and the gradients through
    Adam's first moment (``0.1 * g`` after the first step). The learning
    rate is the flagship's: Noam decay takes 1e-6, then 2e-6, a step."""
    jcfg, pcfg, params, state, port, phn_attr = _model()
    lr = 1e-3
    tx, _ = make_optimizer("Adam", lr=lr, lr_scheduler="decay")
    jfeat = JFeat(JAudio(**CFG, dft_precision="highest"))
    jb = JBuilder(jcfg, jfeat, jnp.asarray(phn_attr), tx, weights=Weights(), freq_loss_kwargs={})
    pb = PBuilder(pcfg, PFeat(PAudio(**CFG), device="cpu"), torch.from_numpy(phn_attr))
    opt = PO.Optimizer(port.parameters(), lr=lr, lr_scheduler="decay")
    step = make_asr_step(pb, opt, seed=0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, state)
    opt_state = tx.init(jp)

    @jax.jit
    def jgrad(p, st, aug, text):
        def loss_fn(p):
            p_code, _, _, st2 = JV.speech_to_text(p, st, jax.random.PRNGKey(0), jcfg,
                                                  jnp.asarray(phn_attr), aug,
                                                  paired_bs=aug.shape[0], train=True)
            return jb._paired_ctc(aug, p_code, text), (st2, p_code)

        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    @jax.jit
    def jupdate(grads, opt_state, p):
        upd, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, upd), opt_state

    for i in range(2):
        waves, lengths, text, snrs, rate = _batch(seed=i)
        key = jax.random.PRNGKey(10 + i)
        noise = np.array(jax.random.normal(key, waves.shape, jnp.float32))
        aug, aug_flen = jfeat.featurize_augmented_at(jnp.asarray(waves), jnp.asarray(lengths),
                                                     jnp.asarray(snrs), rate, key)

        (loss, (js, p_code)), grads = jgrad(jp, js, aug, jnp.asarray(text))
        jp, opt_state = jupdate(grads, opt_state, jp)
        mets = step(port, i, *map(torch.from_numpy, (waves, lengths, text)), None,
                    augment=(torch.from_numpy(snrs), float(rate), torch.from_numpy(noise)))
        np.testing.assert_allclose(float(mets["total_loss"]), float(loss), rtol=1e-5)
        np.testing.assert_allclose(float(mets["grad_norm"]), float(optax.global_norm(grads)),
                                   rtol=1e-4)
        np.testing.assert_array_equal(mets["pair_pred_len"].numpy(),
                                      np.asarray(jb._enc_len(aug_flen, p_code.shape[1])))
        if i == 0:
            want_mu = _flat(opt_state.inner_state[1].mu)
            tol = 1e-4 * max(np.abs(m).max() for m in want_mu.values())
            for (name, _), mu in zip(port.named_parameters(), opt.views(opt.mu)):
                np.testing.assert_allclose(mu.numpy(), want_mu[name.replace(".", "/")], rtol=0,
                                           atol=tol, err_msg=f"mu {name}")
        got_p, got_s = bridge.to_jax_params(port)
        for kind, got, want in (("params", got_p, jp), ("state", got_s, js)):
            want = _flat(want)
            for path, g in _flat(got).items():
                np.testing.assert_allclose(g, want[path], rtol=0, atol=ATOL,
                                           err_msg=f"step {i} {kind} {path}")


def test_asr_trainer_runs_and_validates():
    """`AsrTrainer.exec` over an iterator of batches, then `validate_asr`
    (the clean path through the eval step): finite loss and PER."""
    _, pcfg, _, _, port, phn_attr = _model()
    pb = PBuilder(pcfg, PFeat(PAudio(**CFG), device="cpu"), torch.from_numpy(phn_attr))
    opt = PO.Optimizer(port.parameters(), lr=1e-3)
    waves, lengths, text, _, _ = _batch()
    batch = tuple(map(torch.from_numpy, (waves, lengths, text))) + (torch.zeros(2, dtype=torch.long),)
    logged = []
    trainer = AsrTrainer(port, pb, opt, pair_iter=iter([batch] * 2), dev_set=[batch],
                         max_step=2, valid_step=2, log=lambda *a: logged.append(a))
    trainer.exec()
    assert trainer.step == 2 and int(opt.count) == 2
    names = [n for _, n, _ in logged]
    assert names.count("per/dev") == 2 and all(np.isfinite(v) for _, _, v in logged)
    out = pb.make_eval_step()(port, *batch)
    assert out["mel"].shape[1] % 3 == 0 and out["p_code"].shape[:2] == (2, out["mel"].shape[1] // 2)


@pytest.mark.parametrize("actual_len", [False, True])
def test_ctc_lengths_match_jax(actual_len):
    jcfg, pcfg, _, _, _, _ = _model()
    x = np.random.RandomState(1).rand(2, 10, 20).astype(np.float32)
    x[1, 7:] = 0.0
    p_code = np.zeros((2, 5, 43), np.float32)
    jb = JBuilder(jcfg, None, None, None, weights=Weights(), freq_loss_kwargs={},
                  actual_len=actual_len)
    pb = PBuilder(pcfg, None, None, actual_len=actual_len)
    want = jb._ctc_lengths(jnp.asarray(x), jnp.asarray(p_code))
    got = pb._ctc_lengths(torch.from_numpy(x), torch.from_numpy(p_code))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cal_per_matches_jax():
    rng = np.random.RandomState(2)
    pred = rng.randint(0, 43, size=(4, 30))
    truth = np.zeros((4, 12), np.int32)
    for b in range(4):
        truth[b, :rng.randint(4, 12)] = rng.randint(3, 42, size=1)[0] + rng.randint(0, 2)
    truth[:, 0] = rng.randint(3, 42, size=4)
    lens = np.asarray([30, 20, 7, 1])
    probs = rng.rand(4, 30, 43)
    assert p_cal_per(pred, truth) == j_cal_per(pred, truth)
    assert p_cal_per(pred, truth, pred_lens=lens) == j_cal_per(pred, truth, pred_lens=lens)
    assert p_cal_per(probs, truth) == j_cal_per(probs, truth)
