"""The port's unpaired cycle steps (`semi_tts_tpu_torch/train/steps.py`
`make_speech_first_step`, `make_text_first_step`) against the JAX
package's own step builders: two speech-first steps and two text-first
steps from one bridged weight tree, each against the jitted JAX step, whose
optimizer is chained behind a transformation that keeps the merged
gradients it is given. The losses, every merged gradient and every
parameter and BN statistic after the step are compared; the augmentation
the JAX step draws from its key (SNRs, stretch rate, noise) is drawn on the
host from the same key and given to the port (``augment=``). Also a
text-first step with an unpaired row that CTC cannot align, and the
speech-first step's all-blank escape."""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semi_tts_tpu.models import vqvae as JV
from semi_tts_tpu.ops.features import AudioConfig as JAudio
from semi_tts_tpu.ops.features import AudioFeaturizer as JFeat
from semi_tts_tpu.train.optim import make_optimizer
from semi_tts_tpu.train.steps import StepBuilder as JBuilder
from semi_tts_tpu.train.steps import Weights as JWeights
from semi_tts_tpu.utils.metrics import read_phn_attr
from semi_tts_tpu_torch import bridge
from semi_tts_tpu_torch.models import vqvae as PV
from semi_tts_tpu_torch.ops.features import AudioConfig as PAudio
from semi_tts_tpu_torch.ops.features import AudioFeaturizer as PFeat
from semi_tts_tpu_torch.train import optim as PO
from semi_tts_tpu_torch.train.steps import StepBuilder as PBuilder
from semi_tts_tpu_torch.train.steps import Weights
from test_torch_asr import ENC, _gen
from test_torch_features import CFG
from test_torch_models import MODEL, _jax_weights
from test_torch_train_asr import _batch
from test_torch_train_paired import (ATOL, FLOSS, GRAD_RTOL, GNORM_RTOL, LOSS_RTOL, UPDATE_RTOL,
                                     ZERO_GRAD_TOL, _flat, _RecordingOptimizer, _zero_grad)

# The flagship's cycle weights (config/semi-multi-spkr-paired-data.yaml sets
# unpair_speech_weight 10; no shipped config sets the text weight), both
# cycles from step 0 on.
W = dict(unpair_speech=10.0, unpair_text=1.0)
U_UNPAIRED = 10  # the unpaired texts' padded length: 60 fake-mel frames, 20 decode steps


def _cycle_model():
    """The tiny VQVAE of `test_torch_train_paired._paired_model`, but with
    an ASR that reduces time by 4 (strides 2, 2, 1): the unpaired CTC then
    has 6 * U / 4 = 15 frames for U = 10 tokens, too few for 10 equal ones."""
    model_cfg = copy.deepcopy(MODEL)
    model_cfg["encoder"] = dict(ENC, stride=[2, 2, 1])
    model_cfg["decoder"]["separate_postnet"] = True
    model_cfg["decoder"]["decoder"].update(prenet_dropout=0.0, query_dropout=0.0, dec_dropout=0.0)
    phn_attr = read_phn_attr(MODEL["codebook"]["phn_attr_pth"])
    kw = dict(n_mels=20, linear_dim=257, vocab_size=43, n_spkr=3, attr_dim=phn_attr.shape[1])
    jcfg, pcfg = JV.config_from_yaml(model_cfg, **kw), PV.config_from_yaml(model_cfg, **kw)
    params, state = _jax_weights(PV.VQVAE(pcfg, generator=_gen(0)))
    port = bridge.load_jax_params(PV.VQVAE(pcfg, generator=_gen(1)), params, state)
    return jcfg, pcfg, params, state, port, phn_attr


def _keep_grads():
    """An optax transformation that passes the gradients on and keeps them
    as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg, params, state, port, phn_attr = _cycle_model()
    tx, _ = make_optimizer("Adam", lr=1e-3, lr_scheduler="decay")
    jfeat = JFeat(JAudio(**CFG, dft_precision="highest"))
    jb = JBuilder(jcfg, jfeat, jnp.asarray(phn_attr), optax.chain(_keep_grads(), tx),
                  weights=JWeights(**W), freq_loss_kwargs=FLOSS)
    return dict(jcfg=jcfg, pcfg=pcfg, params=params, state=state, port=port, phn_attr=phn_attr,
                jb=jb, speech=jb.make_speech_first_step(), text=jb.make_text_first_step())


def _builder(setup, weights=W):
    return PBuilder(setup["pcfg"], PFeat(PAudio(**CFG), device="cpu"),
                    torch.from_numpy(setup["phn_attr"]), weights=Weights(**weights),
                    freq_loss_kwargs=FLOSS)


def _augment(key, waves):
    """The SNRs, stretch rate and noise JAX's `featurize_augmented` draws
    from ``key``, as the port's ``augment=``."""
    k_snr, k_rate, k_noise = jax.random.split(key, 3)
    snrs = jax.random.uniform(k_snr, (waves.shape[0],), minval=10.0, maxval=100.0)
    rate = jax.random.uniform(k_rate, (), minval=0.9, maxval=1.1)
    noise = jax.random.normal(k_noise, waves.shape, jnp.float32)
    return torch.from_numpy(np.array(snrs)), float(rate), torch.from_numpy(np.array(noise))


def _batches(i, u_text=None):
    """The paired batch (B=2, 0.5 s) and the unpaired one (B=2, 0.6 s, texts
    of up to U_UNPAIRED tokens) of step ``i``, as numpy."""
    waves, lengths, text, _, _ = _batch(seed=i)
    u_waves, u_lengths, u_txt, _, _ = _batch(S=13230, U=U_UNPAIRED, seed=20 + i)
    if u_text is not None:
        u_txt = u_text
    return ((waves, lengths, text, np.asarray([2, 0], np.int32)),
            (u_waves, u_lengths, u_txt, np.asarray([1, 2], np.int32)))


def _run_pair(setup, kind, steps, u_texts=None):
    """Runs ``steps`` (step numbers) of ``kind`` on the JAX builder and on
    the port from the same weights; yields (step, JAX metrics, JAX merged
    grads, port metrics, port grads, JAX params, JAX state)."""
    jp = jax.tree_util.tree_map(jnp.asarray, setup["params"])
    js = jax.tree_util.tree_map(jnp.asarray, setup["state"])
    opt_state = setup["jb"].tx.init(jp)
    port = copy.deepcopy(setup["port"])
    opt = _RecordingOptimizer(port.parameters(), lr=1e-3, lr_scheduler="decay")
    pb = _builder(setup)
    pstep = (pb.make_speech_first_step if kind == "speech" else pb.make_text_first_step)(opt)
    rng = jax.random.PRNGKey(5)
    for i, step_no in enumerate(steps):
        pair, unpair = _batches(i, None if u_texts is None else u_texts[i])
        jp, js, opt_state, mets = setup[kind](jp, js, opt_state, rng, step_no, 1.0,
                                              *map(jnp.asarray, pair + unpair))
        keys = jax.random.split(jax.random.fold_in(rng, step_no), 4 if kind == "speech" else 3)
        kw = dict(augment=_augment(keys[0], pair[0]))
        if kind == "speech":
            kw["u_augment"] = _augment(keys[1], unpair[0])
        got = pstep(port, step_no, 1.0, *map(torch.from_numpy, pair + unpair), **kw)
        yield (step_no, mets, _flat(opt_state[0]), got, opt.grads, port, _flat(jp), _flat(js))


def _check_step(setup, step_no, want, want_g, got, grads, port, want_p, want_s, n_done, keys):
    for k in keys:
        rtol = GNORM_RTOL if k == "grad_norm" else LOSS_RTOL
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   err_msg=f"step {step_no} {k}")
    paths = [n.replace(".", "/") for n, _ in port.named_parameters()]
    gmax = max(np.abs(g).max() for g in want_g.values())
    for path, g in zip(paths, grads):
        w = want_g[path]
        g = np.zeros_like(w) if g is None else g.numpy()
        if _zero_grad(path):
            assert max(np.abs(g).max(), np.abs(w).max()) <= ZERO_GRAD_TOL * gmax, path
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * np.abs(w).max(),
                                       err_msg=f"step {step_no} grad {path}")
    lr = 1e-6 * n_done
    got_p, got_s = map(_flat, bridge.to_jax_params(port))
    for path, p in got_p.items():
        tol = ATOL if _zero_grad(path) else (UPDATE_RTOL * lr
                                             + n_done * np.spacing(np.abs(want_p[path]).max()))
        np.testing.assert_allclose(p, want_p[path], rtol=0, atol=tol,
                                   err_msg=f"step {step_no} param {path}")
    for path, s in got_s.items():
        np.testing.assert_allclose(s, want_s[path], rtol=0, atol=ATOL,
                                   err_msg=f"step {step_no} state {path}")


LOSSES = ("asr_loss", "mel_loss", "linear_loss", "total_loss", "grad_norm")


def test_speech_first_steps_match_jax(setup):
    """Two speech-first steps (steps 2 and 4, tf_rate 1, every dropout 0):
    first the unpaired rows' argmax tokens, so that a flipped frame fails
    by name, then the trimmed lengths, ``unpair_ok``, the losses (the
    unpaired reconstruction too), every merged gradient and every
    parameter and BN statistic after the step."""
    for n, (step_no, want, want_g, got, grads, port, want_p, want_s) in enumerate(
            _run_pair(setup, "speech", (2, 4)), 1):
        np.testing.assert_array_equal(got["unpair_pred"].numpy(), np.asarray(want["unpair_pred"]),
                                      err_msg=f"step {step_no}: the unpaired argmax flipped")
        np.testing.assert_array_equal(got["unpair_pred_len"].numpy(),
                                      np.asarray(want["unpair_pred_len"]))
        assert bool(got["unpair_ok"]) and bool(want["unpair_ok"])
        _check_step(setup, step_no, want, want_g, got, grads, port, want_p, want_s, n,
                    LOSSES + ("unpair_speech_loss",))


def test_text_first_steps_match_jax(setup):
    """Two text-first steps (steps 1 and 3): the unpaired rows decode 20
    steps from their own output past the paired teacher's 18 (whose last
    frame the decoder repeats), the fake mel detached into the ASR. The
    losses (the unpaired CTC too), ``ctc_nan``, every merged gradient and
    every parameter and BN statistic after the step."""
    for n, (step_no, want, want_g, got, grads, port, want_p, want_s) in enumerate(
            _run_pair(setup, "text", (1, 3)), 1):
        assert not bool(got["ctc_nan"]) and not bool(want["ctc_nan"])
        _check_step(setup, step_no, want, want_g, got, grads, port, want_p, want_s, n,
                    LOSSES + ("unpair_text_loss",))


def test_text_first_step_with_an_unalignable_row_matches_jax(setup):
    """An unpaired row of 10 equal tokens needs 19 CTC frames and has 15:
    JAX's CTC gives it a finite NLL of about 1e30 (its -1e30 sentinel) and
    a zero gradient, so the unpaired text loss is large but finite, not
    flagged and not zeroed. The port matches: the same losses and flag,
    every gradient finite and as JAX's, the row's share of the ASR output
    untouched by the unpaired CTC."""
    u_text = np.zeros((2, U_UNPAIRED), np.int32)
    u_text[0, :6] = [5, 9, 12, 30, 7, 4]
    u_text[1, :] = 11
    (step_no, want, want_g, got, grads, port, want_p, want_s), = _run_pair(
        setup, "text", (1,), u_texts=[u_text])
    assert not bool(got["ctc_nan"]) and not bool(want["ctc_nan"])
    assert float(want["unpair_text_loss"]) > 1e27
    assert all(g is None or torch.isfinite(g).all() for g in grads)
    _check_step(setup, step_no, want, want_g, got, grads, port, want_p, want_s, 1,
                LOSSES + ("unpair_text_loss",))


def test_all_blank_unpaired_batch_is_gated(setup):
    """Tokens all blank (``tokens=``): trim/merge keeps nothing, ``unpair_ok``
    is False, and the unpaired reconstruction's term is exactly 0 in the
    gradients: a builder with the unpaired speech weight 0 gives the same
    gradients bit for bit, while tokens that keep segments (ok True) move
    them."""
    pair, unpair = (tuple(map(torch.from_numpy, b)) for b in _batches(0))
    aug, u_aug = (_augment(jax.random.PRNGKey(k), b[0]) for k, b in ((3, pair), (4, unpair)))

    def run(weights, tokens):
        port = copy.deepcopy(setup["port"])
        return _builder(setup, weights).speech_first_loss_and_grads(
            port, 2, 1.0, pair, unpair, None, augment=aug, u_augment=u_aug, tokens=tokens)

    _, mets, _ = run(W, None)
    blank = torch.zeros_like(mets["unpair_pred"])
    (_, m10, g10), (_, m0, g0) = run(W, blank), run(dict(W, unpair_speech=0.0), blank)
    assert not bool(m10["unpair_ok"]) and not bool(m0["unpair_ok"])
    assert float(m10["unpair_speech_loss"]) > 0
    for a, b in zip(g10, g0):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
    _, m_ok, g_ok = run(W, torch.full_like(blank, 5))
    assert bool(m_ok["unpair_ok"])
    assert any(a is not None and not torch.equal(a, b) for a, b in zip(g_ok, g10))
