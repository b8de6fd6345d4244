"""The port's paired train step (`semi_tts_tpu_torch/train/steps.py`
`make_paired_step`, `losses.py`, `train_vqvae.py`) against the JAX
package: `freq_loss`, two paired steps from one bridged weight tree against
a jitted JAX ``value_and_grad`` of `StepBuilder._losses_paired` +
`merge_wgrads` + the optax update, the TTS half of the evaluation step, and
the trainer's loop."""

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
from semi_tts_tpu.train.losses import freq_loss as j_freq_loss
from semi_tts_tpu.train.optim import make_optimizer
from semi_tts_tpu.train.steps import StepBuilder as JBuilder
from semi_tts_tpu.train.steps import Weights as JWeights
from semi_tts_tpu.train.steps import _pad_frames
from semi_tts_tpu.utils.metrics import read_phn_attr
from semi_tts_tpu_torch import bridge
from semi_tts_tpu_torch.models import vqvae as PV
from semi_tts_tpu_torch.ops.features import AudioConfig as PAudio
from semi_tts_tpu_torch.ops.features import AudioFeaturizer as PFeat
from semi_tts_tpu_torch.train import optim as PO
from semi_tts_tpu_torch.train.losses import freq_loss as p_freq_loss
from semi_tts_tpu_torch.train.steps import StepBuilder as PBuilder
from semi_tts_tpu_torch.train.steps import Weights
from semi_tts_tpu_torch.train.train_vqvae import VqvaeTrainer
from test_torch_asr import ENC, _gen
from test_torch_features import CFG
from test_torch_models import MODEL, _jax_weights
from test_torch_train_asr import _batch

# Gradients, per leaf: within GRAD_RTOL of the leaf's largest JAX gradient
# (1.3e-5 measured). The conv biases in front of a train-mode BatchNorm
# (ZERO_GRAD) have an exact gradient of 0, which BN's mean subtraction
# leaves as rounding noise on both sides (<= 1.4e-7 of the largest gradient
# measured): each side must be below ZERO_GRAD_TOL of it.
GRAD_RTOL = 1e-4
ZERO_GRAD = ("asr/convs/", "tts/encoder/convs/")
ZERO_GRAD_TOL = 1e-6
# Parameters after a step: within UPDATE_RTOL of the learning rate (1e-6,
# then 2e-6; a step moves a parameter by about the learning rate; 0.0075 x
# measured) plus one fp32 ulp of the leaf's largest value per step taken.
# Adam turns the ZERO_GRAD leaves' noise into updates of either sign, so
# those leaves and the BN statistics are held to ATOL.
UPDATE_RTOL = 0.1
ATOL = 1e-5
# Losses: fp32 in another summation order through the featurizer and the
# autoregressive decode (measured <= 6e-7 relative); the gradient norm sums
# every gradient (8e-6 measured), as in tests/test_torch_train_asr.py.
LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-4
FLOSS = dict(sample_rate=CFG["sample_rate"], n_mels=20, loss="mse", differential_loss=True,
             emphasize_linear_low=True)


@pytest.mark.parametrize("dim", [20, 257])
@pytest.mark.parametrize("loss,differential,emphasize", [("mse", True, True), ("l1", True, True),
                                                         ("mse", False, False)])
def test_freq_loss_matches_jax(dim, loss, differential, emphasize):
    """Mel (dim = n_mels: the delta-t term) and linear dims (the < 3 kHz
    emphasis)."""
    rng = np.random.RandomState(dim)
    pred, label = rng.rand(2, 2, 9, dim).astype(np.float32)
    kw = dict(FLOSS, loss=loss, differential_loss=differential, emphasize_linear_low=emphasize)
    want = j_freq_loss(jnp.asarray(pred), jnp.asarray(label), **kw)
    got = p_freq_loss(torch.from_numpy(pred), torch.from_numpy(label), **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _paired_model():
    """The tiny VQVAE of `test_torch_asr._model` with every dropout 0 (ASR,
    prenet, query and decoder cells) and the flagship's separate postnet."""
    model_cfg = copy.deepcopy(MODEL)
    model_cfg["encoder"] = dict(ENC)
    model_cfg["decoder"]["separate_postnet"] = True
    model_cfg["decoder"]["decoder"].update(prenet_dropout=0.0, query_dropout=0.0, dec_dropout=0.0)
    phn_attr = read_phn_attr(MODEL["codebook"]["phn_attr_pth"])
    kw = dict(n_mels=20, linear_dim=257, vocab_size=43, n_spkr=3, attr_dim=phn_attr.shape[1])
    jcfg, pcfg = JV.config_from_yaml(model_cfg, **kw), PV.config_from_yaml(model_cfg, **kw)
    params, state = _jax_weights(PV.VQVAE(pcfg, generator=_gen(0)))
    port = bridge.load_jax_params(PV.VQVAE(pcfg, generator=_gen(1)), params, state)
    return jcfg, pcfg, params, state, port, phn_attr


def _flat(tree):
    return bridge._flatten(jax.tree_util.tree_map(np.asarray, tree))


def _zero_grad(path):
    return path.startswith(ZERO_GRAD) and path.endswith("/b")


class _RecordingOptimizer(PO.Optimizer):
    """The port's optimizer, keeping the gradients of its last step."""

    def step(self, grads):
        self.grads = [None if g is None else g.detach().clone() for g in grads]
        return super().step(grads)


def test_paired_steps_match_jax():
    """Two paired steps (tf_rate 1, the same snrs/rate/noise given to both)
    from one bridged weight tree: the asr, mel, linear and total losses, the
    gradient norm, every merged gradient given to the optimizer, and every
    parameter and BN statistic after each step, read back through
    `bridge.to_jax_params`; the parameters to well below the learning rate,
    so a missing, doubled or wrong-signed update fails."""
    jcfg, pcfg, params, state, port, phn_attr = _paired_model()
    tx, _ = make_optimizer("Adam", lr=1e-3, lr_scheduler="decay")
    jfeat = JFeat(JAudio(**CFG, dft_precision="highest"))
    jb = JBuilder(jcfg, jfeat, jnp.asarray(phn_attr), tx, weights=JWeights(),
                  freq_loss_kwargs=FLOSS)
    pb = PBuilder(pcfg, PFeat(PAudio(**CFG), device="cpu"), torch.from_numpy(phn_attr),
                  weights=Weights(), freq_loss_kwargs=FLOSS)
    opt = _RecordingOptimizer(port.parameters(), lr=1e-3, lr_scheduler="decay")
    step = pb.make_paired_step(opt, seed=0)
    paths = [n.replace(".", "/") for n, _ in port.named_parameters()]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, state)
    opt_state = tx.init(jp)
    keys = (jax.random.PRNGKey(1), jax.random.PRNGKey(2))

    @jax.jit
    def jstep(p, st, opt_state, mel, linear, aug, text, sid):
        probes = jb._probes(mel.shape[1] // jcfg.n_frames_per_step, mel.shape[0])

        def loss_fn(p, probes):
            total, st2, mets, aux = jb._losses_paired(p, st, keys, mel, linear, aug, text, sid,
                                                      1.0, wgrad_probes=probes)
            return total, (st2, mets, aux)

        (total, (st2, mets, aux)), (grads, gprobes) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(p, probes)
        grads = jb._merge_wgrads(grads, aux, gprobes)
        p2, opt_state2, gnorm = jb._apply_updates(p, opt_state, grads)
        losses = {k: mets[k] for k in ("asr_loss", "mel_loss", "linear_loss")}
        return p2, st2, opt_state2, dict(losses, total_loss=total, grad_norm=gnorm), grads

    for i in range(2):
        waves, lengths, text, snrs, rate = _batch(seed=i)
        sid = np.asarray([2, 0], np.int32)
        key = jax.random.PRNGKey(10 + i)
        noise = np.array(jax.random.normal(key, waves.shape, jnp.float32))
        mel, linear, _ = jfeat.featurize(jnp.asarray(waves), jnp.asarray(lengths))
        aug, _ = jfeat.featurize_augmented_at(jnp.asarray(waves), jnp.asarray(lengths),
                                              jnp.asarray(snrs), rate, key)
        jp, js, opt_state, want, want_g = jstep(jp, js, opt_state, _pad_frames(mel, 3),
                                                _pad_frames(linear, 3), aug, jnp.asarray(text),
                                                jnp.asarray(sid))
        mets = step(port, i, 1.0, *map(torch.from_numpy, (waves, lengths, text, sid)),
                    augment=(torch.from_numpy(snrs), float(rate), torch.from_numpy(noise)))
        for k, w in want.items():
            rtol = GNORM_RTOL if k == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(float(mets[k]), float(w), rtol=rtol, err_msg=k)
        want_g = _flat(want_g)
        gmax = max(np.abs(g).max() for g in want_g.values())
        for path, g in zip(paths, opt.grads):
            w = want_g[path]
            g = np.zeros_like(w) if g is None else g.numpy()
            if _zero_grad(path):
                assert max(np.abs(g).max(), np.abs(w).max()) <= ZERO_GRAD_TOL * gmax, path
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * np.abs(w).max(),
                                           err_msg=f"step {i} grad {path}")
        lr = 1e-6 * (i + 1)
        got_p, got_s = map(_flat, bridge.to_jax_params(port))
        want_p, want_s = _flat(jp), _flat(js)
        for path, g in got_p.items():
            tol = UPDATE_RTOL * lr + (i + 1) * np.spacing(np.abs(want_p[path]).max())
            if _zero_grad(path):
                tol = ATOL
            else:
                assert tol < 0.5 * lr, path  # the check can see an update gone wrong
            np.testing.assert_allclose(g, want_p[path], rtol=0, atol=tol,
                                       err_msg=f"step {i} param {path}")
        for path, g in got_s.items():
            np.testing.assert_allclose(g, want_s[path], rtol=0, atol=ATOL,
                                       err_msg=f"step {i} state {path}")



def test_eval_step_tts_loss_matches_jax():
    """The evaluation step's free-running decode (prenet dropout 0) and TTS
    loss, and its ASR outputs, against JAX `make_eval_step`."""
    jcfg, pcfg, params, state, port, phn_attr = _paired_model()
    jfeat = JFeat(JAudio(**CFG, dft_precision="highest"))
    jb = JBuilder(jcfg, jfeat, jnp.asarray(phn_attr), None, weights=JWeights(),
                  freq_loss_kwargs=FLOSS)
    pb = PBuilder(pcfg, PFeat(PAudio(**CFG), device="cpu"), torch.from_numpy(phn_attr))
    waves, lengths, text, _, _ = _batch(seed=3)
    sid = np.asarray([1, 2], np.int32)
    want = jb.make_eval_step()(jax.tree_util.tree_map(jnp.asarray, params),
                               jax.tree_util.tree_map(jnp.asarray, state), jax.random.PRNGKey(0),
                               0, *map(jnp.asarray, (waves, lengths, text, sid)))
    got = pb.make_eval_step()(port, *map(torch.from_numpy, (waves, lengths, text, sid)))
    np.testing.assert_allclose(float(got["tts_loss"]), float(want["tts_loss"]), rtol=LOSS_RTOL)
    for k in ("mel_pred", "lin_pred", "align", "p_code"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-3,
                                   err_msg=k)
    np.testing.assert_array_equal(got["enc_len"].numpy(), np.asarray(want["enc_len"]))


def _trainer(weights, **kw):
    _, pcfg, _, _, port, phn_attr = _paired_model()
    pb = PBuilder(pcfg, PFeat(PAudio(**CFG), device="cpu"), torch.from_numpy(phn_attr),
                  weights=weights)
    opt = PO.Optimizer(port.parameters(), lr=1e-3)
    waves, lengths, text, _, _ = _batch()
    batch = tuple(map(torch.from_numpy, (waves, lengths, text))) + (torch.tensor([0, 1]),)
    u_waves, u_lengths, u_text, _, _ = _batch(S=9000, seed=7)
    unpaired = tuple(map(torch.from_numpy, (u_waves, u_lengths, u_text))) + (torch.tensor([2, 1]),)
    logged = []
    trainer = VqvaeTrainer(port, pb, opt, pair_iter=iter([batch] * 4),
                           unpair_iter=iter([unpaired] * 4), dev_set=[batch],
                           log=lambda *a: logged.append(a), **kw)
    return trainer, opt, logged

def test_vqvae_trainer_runs_paired_steps_and_validates():
    """A paired-only config: every step is the paired step; the losses and
    the dev TTS loss and PER are logged and finite, and the best-TTS and
    best-PER watermarks follow the dev scores."""
    trainer, opt, logged = _trainer(Weights(), max_step=2, valid_step=2, progress_step=1)
    trainer.exec()
    assert trainer.step == 2 and int(opt.count) == 2
    names = [n for _, n, _ in logged]
    for name in ("txt_loss/pair", "speech_loss/pair", "speech_loss/mel", "speech_loss/linear",
                 "grad_norm"):
        assert names.count(name) == 2, name
    assert names.count("speech_loss/dev") == 2 and names.count("per/dev") == 2
    assert all(np.isfinite(v) for _, _, v in logged)
    dev_tts = [v for _, n, v in logged if n == "speech_loss/dev"]
    dev_per = [v for _, n, v in logged if n == "per/dev"]
    assert trainer.best_tts_loss == min(dev_tts) and trainer.best_per == min(dev_per + [2.0])


@pytest.mark.parametrize("weights,kinds", [
    (Weights(unpair_speech=1.0), ["paired", "paired", "speech_first", "paired"]),
    (Weights(unpair_text=1.0), ["paired", "text_first", "paired", "text_first"]),
    (Weights(unpair_text=1.0, unpair_text_start=2), ["paired", "paired", "paired", "text_first"])])
def test_vqvae_trainer_runs_the_cycle_of_each_step(weights, kinds):
    """The trainer runs the step the JAX loop runs: the speech-first cycle
    on even steps and the text-first cycle on odd steps past their start
    step, the paired step otherwise (told apart by their metrics). The
    cycles' device flags are read back in one transfer at each progress
    step (steps 1, 2 and 4 with progress_step 2), after which nothing is
    pending; the logged counters add up to the cycles run. A speech-first
    step whose unpaired tokens (``tokens=``) keep segments is counted in
    ``unp_sph`` and fills the token usage; one whose tokens are all blank is
    not counted and leaves the token usage empty."""
    for token in ((5, 0) if "speech_first" in kinds else (None,)):
        trainer, opt, logged = _trainer(weights, max_step=4, valid_step=100, progress_step=2)
        ran, reads = [], []
        step, read = trainer._train_step, trainer._read

        def record(batch, unpaired=None):
            mets = step(batch, unpaired)
            ran.append("speech_first" if "unpair_ok" in mets else
                       "text_first" if "ctc_nan" in mets else "paired")
            return mets

        def count_read(tensors):
            reads.append((trainer.step, len(trainer._pending)))
            return read(tensors)

        trainer._train_step, trainer._read = record, count_read
        if token is not None:
            probe = copy.deepcopy(trainer.model)
            _, mets, _ = trainer.builder.speech_first_loss_and_grads(
                probe, 2, 1.0, next(iter(trainer.dev_set)), next(trainer.unpair_iter), None)
            tokens = torch.full_like(mets["unpair_pred"], token)
            fn = trainer._cycle_fns["speech_first"]
            trainer._cycle_fns["speech_first"] = lambda *a, **k: fn(*a, tokens=tokens, **k)
        trainer.exec()
        assert ran == kinds and trainer.step == 4 and int(opt.count) == 4
        assert [s for s, _ in reads] == [1, 2, 4] and trainer._pending == []
        n_cycles = [sum(k != "paired" for k in kinds[:s]) for s in (1, 2, 4)]
        assert [n for _, n in reads] == [b - a for a, b in zip([0] + n_cycles, n_cycles)]
        counts = {k: sum(v for _, n, v in logged if n == "counter/" + k)
                  for k in ("ctc_nan", "unp_sph", "unp_txt")}
        assert counts["unp_txt"] == kinds.count("text_first") and counts["ctc_nan"] == 0
        if token == 0:
            assert counts["unp_sph"] == 0 and trainer.token_usage.sum() == 0
        else:
            assert counts["unp_sph"] == kinds.count("speech_first")
            assert (trainer.token_usage.sum() > 0) == (token is not None)
        assert all(np.isfinite(v) for _, _, v in logged)
