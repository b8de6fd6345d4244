"""The port's LM pretraining (`semi_tts_tpu_torch/train/train_lm.py`), the
``pretrained_*`` grafts (`train/checkpoint.apply_pretrained`, `VqvaeSolver`)
and the optimizers other than Adam (`train/optim.py`) against the JAX
package's, on one synthetic corpus with every dropout 0.

A module fixture runs JAX's `TextLmTrainer` and `AudioLmTrainer` and the
port's `TextLmSolver` and `AudioLmSolver` for 3 steps each. Then: one step
of each port LM against the JAX step on the same weights, optimizer state
and batch; the port's LM checkpoints grafted into the JAX `VqvaeTrainer`
and JAX's into the port's `VqvaeSolver`; the ``--pretrain-*`` CLI in
process and ``--load`` of a JAX LM checkpoint; the four other optimizers
against optax over 3 steps.

Tolerances: a step's loss to RTOL 1e-5 (the speech LM's to 1e-4: a decode
and a featurizer in fp32 in another summation order, test_torch_models.py
ATOL), the updated parameters, moments and BatchNorm statistics to ATOL
1e-6 (every leaf of order 1 or less; the learning rate is 1e-3 fixed);
grafted leaves bit for bit."""

from __future__ import annotations

import copy
import dataclasses
import os
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from helpers import make_paras, tiny_config
from semi_tts_tpu.ops.features import AudioFeaturizer as JFeat
from semi_tts_tpu.models import vqvae as JV
from semi_tts_tpu.train import checkpoint as JCK
from semi_tts_tpu.train.optim import make_optimizer
from semi_tts_tpu.train.solver import BaseSolver as JBaseSolver
from semi_tts_tpu.train import train_lm as JTrainLm
from semi_tts_tpu.train.train_lm import AudioLmTrainer, TextLmTrainer
from semi_tts_tpu.train.train_vqvae import VqvaeTrainer as JVqvae
from semi_tts_tpu_torch import __main__ as cli
from semi_tts_tpu_torch.bridge import load_jax_params, to_jax_params
from semi_tts_tpu_torch.models import asr as PA
from semi_tts_tpu_torch.models import decoder as PD
from semi_tts_tpu_torch.models import embed as PE
from semi_tts_tpu_torch.models import lm as PL
from semi_tts_tpu_torch.models import tts as PT
from semi_tts_tpu_torch.models import vqvae as PV
from semi_tts_tpu_torch.train import checkpoint as PCK
from semi_tts_tpu_torch.train import optim as PO
from semi_tts_tpu_torch.train.train_lm import AudioLmSolver, TextLmSolver
from semi_tts_tpu_torch.train.train_vqvae import VqvaeSolver

RTOL, SPEECH_RTOL, ATOL = 1e-5, 1e-4, 1e-6


def _config(root):
    cfg = tiny_config(root, bone="l2", max_step=3, valid_step=2)
    cfg["hparas"].update(lr_scheduler="fixed")
    cfg["model"]["encoder"]["dropout"] = 0.0
    cfg["model"]["decoder"]["decoder"].update(prenet_dropout=0.0, query_dropout=0.0,
                                              dec_dropout=0.0)
    return cfg


def _paras(root, name, **kw):
    return make_paras(root, name=name, asr_decode=False, gen_specgram=False,
                      gen_gt_specgram=False, asr_only=False, **kw)


def _run(cls, config, paras):
    """A solver after load_data and set_model; a JAX solver's featurizer
    computes its DFT at "highest" precision (test_torch_solver.py)."""
    s = cls(config, paras, "train")
    s.load_data()
    if isinstance(s, JBaseSolver):
        s.featurizer = JFeat(dataclasses.replace(s.featurizer.cfg, dft_precision="highest"))
    s.set_model()
    return s


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return JCK._flatten(tree)


def _close_trees(got, want, atol=ATOL):
    fg, fw = _flat(got), _flat(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        assert fg[k].dtype == fw[k].dtype and fg[k].shape == fw[k].shape, k
        if fw[k].dtype.kind == "f":
            np.testing.assert_allclose(fg[k], fw[k], rtol=0, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)


def _equal_trees(got, want):
    """Every leaf equal; a sequence's length, not its class name, which a
    loaded checkpoint does not keep."""
    fg, fw = _flat(got), _flat(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        if k.endswith("__seq__"):
            assert fg[k][1] == fw[k][1], k
        else:
            assert fg[k].dtype == fw[k].dtype, k
            np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)


def _audiolm_init(key, dec_cfg, linear_dim=None):
    """JAX's `audiolm_init` trees drawn from a seeded port init, which is
    much faster here than JAX's own eager init (test_torch_models.py; the
    layout is held to JAX's init in test_torch_lm.py and
    test_torch_serve.py)."""
    pcfg = PD.DecoderConfig(**dataclasses.asdict(dec_cfg))
    params, state = to_jax_params(PL.AudioLM(pcfg, linear_dim,
                                             generator=torch.Generator().manual_seed(3)))
    return params, state, dataclasses.replace(dec_cfg, pretrain=True)


def _vqvae_init(key, cfg, phn_attr=None):
    """JAX's `vqvae_init` trees drawn from a port init seeded with the key's
    seed, as `_audiolm_init`."""
    d = dataclasses.asdict(cfg)
    pcfg = PV.VQVAEConfig(**{
        **d, "encoder": PA.ASRConfig(**d["encoder"]),
        "codebook": PE.CodebookConfig(**d["codebook"]),
        "tts": PT.TTSConfig(**{**d["tts"], "decoder": PD.DecoderConfig(**d["tts"]["decoder"])})})
    seed = int(np.asarray(key)[-1])
    return to_jax_params(PV.VQVAE(pcfg, generator=torch.Generator().manual_seed(seed)))


@pytest.fixture(scope="module", autouse=True)
def fast_jax_init():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainLm, "audiolm_init", _audiolm_init)
        mp.setattr(JV, "vqvae_init", _vqvae_init)
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory, fast_jax_init):
    root = str(tmp_path_factory.mktemp("pretrain"))
    config = _config(root)
    out = dict(root=root, config=config)
    for pkg, classes in (("jax", (TextLmTrainer, AudioLmTrainer)),
                         ("port", (TextLmSolver, AudioLmSolver))):
        for mode, cls in zip(("text", "speech"), classes):
            s = _run(cls, config, _paras(root, f"{pkg}_{mode}"))
            s.exec()
            assert s.step == 3
            out[pkg, mode] = s
    for pkg in ("jax", "port"):
        d = out[pkg, "text"].ckpdir, out[pkg, "speech"].ckpdir
        out[pkg, "ckpts"] = dict(emb=join(d[0], "best_acc.pth"), tts=join(d[1], "best_mel.pth"))
    return out


def test_pretraining_writes_the_jax_layout(world):
    """The port's best_acc.pth and best_mel.pth have the JAX files' keys,
    shapes and dtypes, and the port's LMs trained to finite weights."""
    for kind in ("emb", "tts"):
        with np.load(world["port", "ckpts"][kind]) as p, np.load(world["jax", "ckpts"][kind]) as j:
            assert sorted(p.files) == sorted(j.files)
            for k in p.files:
                assert p[k].dtype == j[k].dtype and p[k].shape == j[k].shape, k
                if k.endswith("__seq__"):  # the optax classes' names
                    np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    for mode in ("text", "speech"):
        assert all(torch.isfinite(p).all() for p in world["port", mode].model.parameters())


def _batch(solver):
    """The first batch of the solver's training split, on the host."""
    return next(iter(solver.unpair_set))


def _port_from_jax(world, mode, jt):
    """A port solver holding the JAX trainer's weights, state, optimizer
    state and step."""
    ps = _run(TextLmSolver if mode == "text" else AudioLmSolver, world["config"],
              _paras(world["root"], f"step_{mode}"))
    state = _np(jt.lm_state)
    load_jax_params(ps.model, _np(jt.lm_params), state)
    PCK.load_optimizer_tree(ps.optimizer, ps.model, _np(jt.opt_state))
    ps.step = jt.step
    return ps


@pytest.mark.parametrize("mode", ["text", "speech"])
def test_lm_step_matches_jax(world, mode):
    """One train step of the port's LM on the JAX trainer's weights and
    optimizer state after 3 steps, and the same batch: the loss, the new
    parameters, BatchNorm statistics and optimizer state."""
    jt = world["jax", mode]
    ps = _port_from_jax(world, mode, jt)
    b = _batch(ps)
    if mode == "text":
        text = np.asarray(b["text"], np.int32)
        jargs = (jnp.asarray(text), jnp.asarray((text != 0).sum(-1)))
    else:
        jargs = (jnp.asarray(b["waves"]), jnp.asarray(b["wave_len"]))
    params, state, opt, total = jt._step(jax.tree_util.tree_map(jnp.asarray, _np(jt.lm_params)),
                                         jt.lm_state, jt.opt_state, jt.rng, jt.step, *jargs)
    mets = ps.train_step(tuple(torch.from_numpy(b[k]) for k in ("waves", "wave_len", "text",
                                                               "sid")))
    np.testing.assert_allclose(float(mets["total_loss"]), float(total),
                               rtol=RTOL if mode == "text" else SPEECH_RTOL)
    got_p, got_s = to_jax_params(ps.model)
    _close_trees(got_p, _np(params))
    _close_trees(got_s, _np(state))
    _close_trees(PCK.optimizer_tree(ps.optimizer, ps.model), _np(opt))


def _cold_and_warm(world, pkg, grafts):
    """A cold VQVAE solver of ``pkg`` and one with ``grafts`` in its config."""
    cls = JVqvae if pkg == "jax" else VqvaeSolver
    cold = _run(cls, copy.deepcopy(world["config"]), _paras(world["root"], f"cold_{pkg}"))
    config = copy.deepcopy(world["config"])
    config["model"].update(grafts)
    warm = _run(cls, config, _paras(world["root"], f"warm_{pkg}"))
    trees = [(_np(s.params), _np(s.state)) if pkg == "jax" else to_jax_params(s.model)
             for s in (cold, warm)]
    return trees


@pytest.mark.parametrize("src,dst", [("port", "jax"), ("jax", "port")])
def test_lm_checkpoints_graft_into_the_other_packages_vqvae(world, src, dst):
    """``pretrained_emb`` and ``pretrained_tts`` from one package's LM
    checkpoints, and ``pretrained_asr`` from a VQVAE checkpoint, grafted
    into the other's VQVAE: the codebook table, the TTS decoder and postnet
    and the ASR equal their sources bit for bit, the postnet's BatchNorm
    statistics are the audio LM's, and the TTS text encoder stays cold."""
    asr_src = _run(JVqvae if src == "jax" else VqvaeSolver, copy.deepcopy(world["config"]),
                   _paras(world["root"], f"asr_{src}", seed=5))
    asr_ckpt = join(world["root"], f"asr_{src}.pth")
    if src == "jax":
        asr_p, asr_s = _np(asr_src.params), _np(asr_src.state)
        JCK.save_checkpoint(asr_ckpt, params=asr_p, state=asr_s, opt_state=None, step=0)
    else:
        asr_p, asr_s = to_jax_params(asr_src.model)
        PCK.save_checkpoint(asr_ckpt, params=asr_p, state=asr_s, opt_state=None, step=0)
    ck = world[src, "ckpts"]
    (cold_p, cold_s), (warm_p, warm_s) = _cold_and_warm(
        world, dst, {"pretrained_emb": ck["emb"], "pretrained_tts": ck["tts"],
                     "pretrained_asr": asr_ckpt})
    text, audio = world[src, "text"], world[src, "speech"]
    if src == "jax":
        lm_t, (lm_a, lm_as) = _np(text.lm_params), (_np(audio.lm_params), _np(audio.lm_state))
    else:
        lm_t = to_jax_params(text.model)[0]
        lm_a, lm_as = to_jax_params(audio.model)
    np.testing.assert_array_equal(warm_p["codebook"]["learnable_table"], lm_t["learnable_table"])
    assert not np.array_equal(cold_p["codebook"]["learnable_table"], lm_t["learnable_table"])
    _equal_trees(warm_p["tts"]["decoder"], lm_a["decoder"])
    _equal_trees(warm_p["tts"]["postnet"], lm_a["postnet"])
    _equal_trees(warm_s["tts"]["postnet"], lm_as["postnet"])
    assert not all(np.array_equal(a, b) for a, b in zip(
        _flat(cold_s["tts"]["postnet"]).values(), _flat(lm_as["postnet"]).values()))
    _equal_trees(warm_p["asr"], asr_p["asr"])
    _equal_trees(warm_s["asr"], asr_s["asr"])
    _equal_trees(warm_p["tts"]["encoder"], cold_p["tts"]["encoder"])
    _equal_trees(warm_s["tts"]["encoder"], cold_s["tts"]["encoder"])


def test_graft_raises_on_a_mismatched_leaf(world, tmp_path):
    """A checkpoint whose table has another width, or that lacks the
    module, stops the graft."""
    params, state = to_jax_params(world["port", "text"].model)
    path = str(tmp_path / "narrow.pth")
    bad = {"codebook": {"learnable_table": params["learnable_table"][:, :3]}, "textlm": params}
    PCK.save_checkpoint(path, params=bad, state=state, opt_state=None, step=0)
    s = _run(VqvaeSolver, world["config"], _paras(str(tmp_path), "g"))
    with pytest.raises(ValueError, match="learnable_table"):
        PCK.apply_pretrained(s.model, {"codebook/learnable_table": path})
    with pytest.raises(KeyError, match="tts/decoder"):
        PCK.apply_pretrained(s.model, {"tts/decoder": path})


def _write_yaml(root, config):
    path = join(root, "cli.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


@pytest.mark.parametrize("flag,fname", [("--pretrain-text", "best_acc.pth"),
                                        ("--pretrain-speech", "best_mel.pth")])
def test_cli_pretrains_and_resumes_a_jax_checkpoint(world, tmp_path, flag, fname):
    """``--pretrain-*`` in process writes its checkpoint; ``--load`` of the
    JAX trainer's checkpoint restores its weights, BatchNorm statistics,
    optimizer state and step exactly, and trains on from there."""
    config = copy.deepcopy(world["config"])
    config["hparas"].update(max_step=1, valid_step=1)
    cfg = _write_yaml(str(tmp_path), config)
    base = ["--cpu", "--no-msg", "--config", cfg, "--logdir", str(tmp_path / "log"),
            "--ckpdir", str(tmp_path / "ckpt"), flag]
    assert cli.main(base) == 0
    assert os.listdir(tmp_path / "ckpt" / "cli-sd0") == [fname]
    mode = "text" if flag == "--pretrain-text" else "speech"
    ckpt = world["jax", "ckpts"]["emb" if mode == "text" else "tts"]
    want = JCK.load_checkpoint(ckpt)
    ps = _run(TextLmSolver if mode == "text" else AudioLmSolver, config,
              _paras(str(tmp_path), "resumed", load=ckpt))
    got_p, got_s = to_jax_params(ps.model)
    prefix = "textlm" if mode == "text" else "tts"
    _equal_trees(got_p, want["model"][prefix])
    _equal_trees(got_s, want["state"].get(prefix, {}))
    _equal_trees(PCK.optimizer_tree(ps.optimizer, ps.model), want["optimizer"])
    assert ps.step == want["global_step"] >= 1
    ps.max_step = ps.step + 1
    ps.exec()
    assert ps.step == want["global_step"] + 1
    assert all(torch.isfinite(p).all() for p in ps.model.parameters())


def test_jax_text_trainer_resumes_the_ports_checkpoint(world):
    """The JAX `TextLmTrainer --load` of the port's best_acc.pth: weights,
    optimizer state and step equal the port's checkpoint exactly."""
    path = world["port", "ckpts"]["emb"]
    want = JCK.load_checkpoint(path)
    jt = _run(TextLmTrainer, world["config"], _paras(world["root"], "jax_resume", load=path))
    _equal_trees(_np(jt.lm_params), want["model"]["textlm"])
    _equal_trees(_np(jt.opt_state), want["optimizer"])
    assert jt.step == want["global_step"]


class _Two(torch.nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.a = torch.nn.Parameter(torch.from_numpy(a.copy()))
        self.sub = torch.nn.Module()
        self.sub.b = torch.nn.Parameter(torch.from_numpy(b.copy()))


@pytest.mark.parametrize("name,wd", [("AdamW", 0.01), ("RMSprop", 0.0), ("SGD", 0.0),
                                     ("Adadelta", 0.0)])
def test_optimizers_match_optax(name, wd):
    """Clip 5 -> the optimizer -> Noam decay -> skip non-finite over three
    steps (a small one, a clipped one of norm ~40, a non-finite one): the
    parameters, the state as the optax tree (keys, shapes, dtypes, values)
    and the counts; the tree loads back into a fresh optimizer."""
    rng = np.random.RandomState(1)
    a, b = rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)
    grads = [{"a": (s * rng.randn(3, 4)).astype(np.float32),
              "sub": {"b": (s * rng.randn(5)).astype(np.float32)}} for s in (0.3, 10.0, 1.0)]
    grads[2]["sub"]["b"][1] = np.nan
    tx, _ = make_optimizer(name, lr=1.0, lr_scheduler="decay", weight_decay=wd)
    jp = {"a": jnp.asarray(a), "sub": {"b": jnp.asarray(b)}}
    state = tx.init(jp)
    m = _Two(a, b)
    opt = PO.Optimizer(m.parameters(), name, lr=1.0, lr_scheduler="decay", weight_decay=wd)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        gnorm = opt.step([torch.from_numpy(g["a"]), torch.from_numpy(g["sub"]["b"])])
        np.testing.assert_allclose(float(gnorm), float(optax.global_norm(g)), rtol=1e-6)
        _close_trees(to_jax_params(m)[0], _np(jp))
    tree = PCK.optimizer_tree(opt, m)
    fp, fj = _flat(tree), _flat(_np(state))
    assert sorted(fp) == sorted(fj)
    for k in fj:
        assert fp[k].dtype == fj[k].dtype and fp[k].shape == fj[k].shape, k
        if k.endswith("__seq__"):
            np.testing.assert_array_equal(fp[k], fj[k], err_msg=k)
        else:
            np.testing.assert_allclose(fp[k], fj[k], rtol=0, atol=ATOL, err_msg=k)
    assert int(opt.schedule_count) == 2 and int(opt.total_notfinite) == 1
    fresh = PO.Optimizer(_Two(a, b).parameters(), name, lr=1.0, lr_scheduler="decay",
                         weight_decay=wd)
    PCK.load_optimizer_tree(fresh, m, JCK._unflatten(fj))
    _equal_trees(PCK.optimizer_tree(fresh, m), JCK._unflatten(fj))


def test_optimizer_tree_of_another_optimizer_raises():
    m = _Two(np.zeros((3, 4), np.float32), np.zeros(5, np.float32))
    adam = PCK.optimizer_tree(PO.Optimizer(m.parameters(), "Adam"), m)
    with pytest.raises(ValueError, match="rmsprop"):
        PCK.load_optimizer_tree(PO.Optimizer(m.parameters(), "RMSprop"), m, adam)
    with pytest.raises(NotImplementedError, match="Lion"):
        PO.Optimizer(m.parameters(), "Lion")
