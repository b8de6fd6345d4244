"""The port's solvers and CLI (`semi_tts_tpu_torch/train/solver.py`,
`train_vqvae.VqvaeSolver`, `train_asr.AsrSolver`, `gen_specgram`,
`gen_gt_specgram`, `asr_decode`, `__main__`) against the JAX package's on
one synthetic corpus: checkpoints that either package resumes from the
other's with the state equal exactly, the inference solvers' files, the
checkpoint policy, a resume that repeats the next step bit for bit, and
the CLI's dispatch and refusals."""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import os
import subprocess
import sys
from os.path import join

import jax
import numpy as np
import pytest
import torch
import yaml

from helpers import REPO, make_paras, make_synthetic_corpus, tiny_config
from semi_tts_tpu.ops.features import AudioFeaturizer as JFeat
from semi_tts_tpu.train import checkpoint as JCK
from semi_tts_tpu.train.asr_decode import VqvaeDecoder as JDecoder
from semi_tts_tpu.train.gen_gt_specgram import SpecgramGenerator as JGtGenerator
from semi_tts_tpu.train.gen_specgram import SpecgramGenerator as JGenerator
from semi_tts_tpu.train.solver import BaseSolver as JBaseSolver
from semi_tts_tpu.train.train_vqvae import VqvaeTrainer as JTrainer
from semi_tts_tpu_torch import __main__ as cli
from semi_tts_tpu_torch.bridge import to_jax_params
from semi_tts_tpu_torch.train import checkpoint as PCK
from semi_tts_tpu_torch.train.asr_decode import VqvaeDecoder as PDecoder
from semi_tts_tpu_torch.train.gen_gt_specgram import SpecgramGenerator as PGtGenerator
from semi_tts_tpu_torch.train.gen_specgram import SpecgramGenerator as PGenerator
from semi_tts_tpu_torch.train.solver import BaseSolver
from semi_tts_tpu_torch.train.train_asr import AsrSolver
from semi_tts_tpu_torch.train.train_vqvae import CKPT_STEP, VqvaeSolver, VqvaeTrainer
from test_torch_features import ATOL as FEATURE_ATOL

# gen_specgram's spectrograms and alignments after (T + 40) // 3 free-running
# decode steps, fp32 in another summation order (test_torch_models.py: 1e-4
# over 10+ autoregressive steps). The ground-truth features are the
# featurizer alone, held to the featurizer tests' tolerance: a linear bin
# near the 1e-5 amplitude floor moves by up to ~2e-4 (2.07e-4 measured here)
# with the DFT's summation order (test_torch_features.py ATOL)
GEN_ATOL = 1e-4
GT_ATOL = FEATURE_ATOL


def _config(root, **kw):
    """`tiny_config` with every dropout 0 (the eval step's prenet draws no
    mask), the cycles' weights on, and a corpus of 4 paired, 4 unpaired, 2
    dev and 3 test utterances."""
    cfg = tiny_config(root, unpair_speech=10.0, unpair_text=1.0, **kw)
    cfg["data"]["corpus"] = make_synthetic_corpus(root, n_per_split=(4, 4, 2, 3), seed=1)
    cfg["model"]["encoder"]["dropout"] = 0.0
    cfg["model"]["decoder"]["decoder"].update(prenet_dropout=0.0, query_dropout=0.0,
                                              dec_dropout=0.0)
    return cfg


def _paras(root, name, **kw):
    return make_paras(root, name=name, logdir=join(root, "log"), ckpdir=join(root, "ckpt"),
                      asr_decode=False, gen_specgram=False, gen_gt_specgram=False,
                      asr_only=False, **kw)


def _run(cls, config, paras, mode="train"):
    """A solver after load_data and set_model. A JAX solver's featurizer
    computes its DFT at "highest" precision, as the featurizer tests build
    it (its default on the CPU moves the linear features by ~2e-4)."""
    s = cls(config, paras, mode)
    s.load_data()
    if isinstance(s, JBaseSolver):
        s.featurizer = JFeat(dataclasses.replace(s.featurizer.cfg, dft_precision="highest"))
    s.set_model()
    return s


def _flat(tree):
    """A checkpoint group's leaves by path, as the JAX package saves them."""
    return JCK._flatten(tree)


def _assert_same_leaves(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The corpus and config; a JAX checkpoint at step 5 (the JAX
    trainer's init, its optimizer moments and counts filled with draws) and
    a port checkpoint after two port train steps (a paired and a
    text-first step)."""
    root = str(tmp_path_factory.mktemp("solver"))
    config = _config(root, max_step=2, valid_step=100)
    jt = _run(JTrainer, config, _paras(root, "jax"))
    rng = np.random.RandomState(0)
    opt = jax.tree_util.tree_map(np.asarray, jt.opt_state)
    adam = opt.inner_state[1]
    adam = adam._replace(count=np.int32(4),
                         mu=jax.tree_util.tree_map(lambda x: rng.randn(*x.shape).astype(x.dtype),
                                                   adam.mu),
                         nu=jax.tree_util.tree_map(lambda x: rng.rand(*x.shape).astype(x.dtype),
                                                   adam.nu))
    sched = opt.inner_state[2]._replace(count=np.int32(5))
    opt = opt._replace(notfinite_count=np.int32(1), last_finite=np.bool_(False),
                       total_notfinite=np.int32(2),
                       inner_state=(opt.inner_state[0], adam, sched))
    jax_ckpt = join(root, "jax.pth")
    params = jax.tree_util.tree_map(np.asarray, jt.params)
    state = jax.tree_util.tree_map(np.asarray, jt.state)
    JCK.save_checkpoint(jax_ckpt, params=params, state=state, opt_state=opt, step=5,
                        extra={"best_tts_loss": 0.5, "best_per": 0.75})
    ps = _run(VqvaeSolver, config, _paras(root, "port"))
    ps.exec()
    ps.save("port.pth", 0.0)
    return dict(root=root, config=config, jax_ckpt=jax_ckpt, jax=(params, state, opt),
                port=ps, port_ckpt=join(ps.ckpdir, "port.pth"))


def test_checkpoint_keys_shapes_and_dtypes_match_jax(world):
    """A port save and a JAX save of the same config: the same flattened
    keys (the optax classes' names among them), shapes and dtypes."""
    with np.load(world["port_ckpt"]) as p, np.load(world["jax_ckpt"]) as j:
        assert sorted(p.files) == sorted(j.files)
        for k in p.files:
            if k == "extra_json":  # the watermarks as JSON text, of any length
                assert p[k].dtype.kind == j[k].dtype.kind == "U"
                continue
            assert p[k].dtype == j[k].dtype and p[k].shape == j[k].shape, k
            if k.endswith("__seq__"):
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)


def test_jax_trainer_resumes_the_ports_checkpoint(world):
    """The JAX `VqvaeTrainer --load` of a port checkpoint: params, state,
    optimizer state, step and watermarks equal the port's exactly."""
    ps = world["port"]
    jt = _run(JTrainer, world["config"], _paras(world["root"], "jax_load",
                                                load=world["port_ckpt"]))
    params, state = to_jax_params(ps.model)
    _assert_same_leaves(jt.params, params)
    _assert_same_leaves(jt.state, state)
    _assert_same_leaves(jt.opt_state, PCK.optimizer_tree(ps.optimizer, ps.model))
    assert int(np.asarray(jt.opt_state.inner_state[1].count)) == 2
    assert jt.step == ps.trainer.step == 2
    assert (jt.best_tts_loss, jt.best_per) == (ps.trainer.best_tts_loss, ps.trainer.best_per)


def test_port_resumes_a_jax_checkpoint(world):
    """The port's `--load` of a JAX checkpoint: every parameter and BN
    statistic, and the optimizer state mapped leaf by leaf (moments in JAX's
    sorted-key order, counts, the finite flags), equal the checkpoint's."""
    params, state, opt = world["jax"]
    ps = _run(VqvaeSolver, world["config"], _paras(world["root"], "port_load",
                                                   load=world["jax_ckpt"]))
    got_p, got_s = to_jax_params(ps.model)
    _assert_same_leaves(got_p, params)
    _assert_same_leaves(got_s, state)
    _assert_same_leaves(PCK.optimizer_tree(ps.optimizer, ps.model), opt)
    assert ps.trainer.step == 5
    assert (ps.trainer.best_tts_loss, ps.trainer.best_per) == (0.5, 0.75)


def test_lr_schedule_advances_without_optimizer_state(world, tmp_path):
    """A checkpoint whose optimizer is None (an imported one): both
    packages start fresh moments and an Adam count of 0, and advance the
    schedule count to the step."""
    params, state, _ = world["jax"]
    path = str(tmp_path / "imported.pth")
    JCK.save_checkpoint(path, params=params, state=state, opt_state=None, step=7)
    ps = _run(VqvaeSolver, world["config"], _paras(world["root"], "port_imp", load=path))
    jt = _run(JTrainer, world["config"], _paras(world["root"], "jax_imp", load=path))
    assert int(ps.optimizer.schedule_count) == 7 and int(ps.optimizer.count) == 0
    assert not ps.optimizer.mu.any() and not ps.optimizer.nu.any()
    _assert_same_leaves(PCK.optimizer_tree(ps.optimizer, ps.model), jt.opt_state)


def test_load_subtree(world):
    params = world["jax"][0]
    got = PCK.load_subtree(world["jax_ckpt"], "tts/decoder")
    _assert_same_leaves(got, params["tts"]["decoder"])
    with pytest.raises(KeyError, match="nope"):
        PCK.load_subtree(world["jax_ckpt"], "tts/nope")


@pytest.fixture(scope="module")
def generated(world):
    """gen_specgram, gen_gt_specgram and asr_decode of both packages on the
    JAX checkpoint (the port's gen_specgram with --gen-wav)."""
    root, config, out = world["root"], world["config"], {}
    for pkg, classes in (("jax", (JGenerator, JGtGenerator, JDecoder)),
                         ("port", (PGenerator, PGtGenerator, PDecoder))):
        for cls, flag in zip(classes, ("gen_specgram", "gen_gt_specgram", "asr_decode")):
            paras = _paras(root, pkg, load=world["jax_ckpt"], gen_wav=pkg == "port" and
                           flag == "gen_specgram", verbose=True)
            setattr(paras, flag, True)
            s = _run(cls, config, paras, "test")
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                s.exec()
            out[pkg, flag] = s
            out[pkg, flag, "printed"] = printed.getvalue()
    return out


def _files(d):
    return sorted(os.listdir(d))


def test_gen_specgram_matches_jax(generated):
    """Every test utterance's -mel, -spec and -align.npy within GEN_ATOL of
    JAX's (the same shapes); the port's --gen-wav waves are finite, in
    [-1, 1], one hop per predicted frame but the last."""
    jd = generated["jax", "gen_specgram"].logdir + "_0k"
    pd_ = generated["port", "gen_specgram"].logdir + "_0k"
    want = _files(jd)
    assert len(want) == 3 * 3
    assert _files(pd_) == sorted(want + [f.replace("-mel.npy", "-pred.wav")
                                         for f in want if f.endswith("-mel.npy")])
    hop = generated["port", "gen_specgram"].featurizer.cfg.hop_length
    from semi_tts_tpu_torch.data import wavio

    for f in want:
        a, b = np.load(join(pd_, f)), np.load(join(jd, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_allclose(a, b, rtol=0, atol=GEN_ATOL, err_msg=f)
        if f.endswith("-mel.npy"):
            assert a.shape[0] >= 40 + 3 * 10  # the margin and 10+ decode steps
            wav, sr = wavio.read(join(pd_, f.replace("-mel.npy", "-pred.wav")))
            assert sr == 22050 and wav.shape == (1, hop * (a.shape[0] - 1))
            assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0


def test_gen_gt_specgram_matches_jax(generated):
    jd = generated["jax", "gen_gt_specgram"].logdir + "_gt"
    pd_ = generated["port", "gen_gt_specgram"].logdir + "_gt"
    assert _files(pd_) == _files(jd) and len(_files(jd)) == 2 * 3
    for f in _files(jd):
        a, b = np.load(join(pd_, f)), np.load(join(jd, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=0, atol=GT_ATOL, err_msg=f)
        assert np.median(np.abs(a - b)) <= 1e-5, f  # the bulk of the bins


def test_asr_decode_matches_jax(generated):
    """The same hypotheses, file for file, and the same PER."""
    jd = generated["jax", "asr_decode"].logdir + "_decode"
    pd_ = generated["port", "asr_decode"].logdir + "_decode"
    with open(join(jd, "hyp.tsv")) as a, open(join(pd_, "hyp.tsv")) as b:
        want, got = a.read(), b.read()
    assert got == want and len(want.splitlines()) == 4
    printed = generated["jax", "asr_decode", "printed"]
    assert f"PER = {generated['port', 'asr_decode'].per:.3f} ->" in printed, printed


@pytest.mark.parametrize("store_best_per", [False, True])
@pytest.mark.parametrize("post", [False, True])
def test_checkpoint_policy_names(store_best_per, post):
    """`VqvaeTrainer.keep_best` writes the JAX trainer's checkpoints over a
    run of validations: dev (TTS loss, PER, postnet PER)."""
    saved = []
    t = VqvaeTrainer.__new__(VqvaeTrainer)
    t.best_tts_loss, t.best_per, t.store_best_per = 100.0, 2.0, store_best_per
    t.save = lambda name, score: saved.append((t.step, name))
    for step, tts, per, post_per in ((1, 5.0, 1.5, 1.4), (2, 4.0, 1.6, 1.7), (3, 4.5, 1.0, 0.9),
                                     (CKPT_STEP, 3.0, 1.2, 1.1)):
        t.step = step
        t.keep_best(tts, per, post_per if post else None)
    if store_best_per:
        want = [(1, "best_per.pth")] + ([(1, "best_post_per.pth")] if post else []) + \
            [(3, "best_per.pth")] + ([(3, "best_post_per.pth")] if post else [])
    else:
        want = ([(1, "best_post_per.pth")] if post else []) + [(2, "tts_2.pth")] + \
            [(3, "asr_3.pth")] + ([(3, "best_post_per.pth")] if post else []) + \
            [(CKPT_STEP, f"tts_{CKPT_STEP}.pth"), (CKPT_STEP, f"step_{CKPT_STEP}.pth")]
    assert saved == want


@pytest.mark.parametrize("solver", [VqvaeSolver, AsrSolver])
def test_solver_runs_two_steps_and_writes_the_policys_checkpoints(world, solver, tmp_path):
    """Two steps with a validation after each: finite logged losses, and in
    the checkpoint directory exactly the files the policy names for the
    logged dev metrics (``best_per`` for --asr-only)."""
    config = copy.deepcopy(world["config"])
    config["hparas"].update(valid_step=1, lr_scheduler="fixed", lr=0.01)
    s = _run(solver, config, _paras(str(tmp_path), solver.__name__))
    logged = []
    log = s.trainer.log
    s.trainer.log = lambda step, name, value: (logged.append((step, name, value)),
                                               log(step, name, value))
    s.exec()
    assert s.trainer.step == 2
    # with a writer the log also carries figures, texts, waves and the projector
    assert all(np.isfinite(v) for _, _, v in logged if isinstance(v, (int, float)))
    dev = {(st, n): v for st, n, v in logged if n in ("speech_loss/dev", "per/dev")}
    names, best_tts, best_per = set(), 100.0, 2.0
    for st in (1, 2):
        per = dev[st, "per/dev"]
        if solver is AsrSolver:
            if per < best_per:
                best_per = per
                names.add("best_per.pth")
            continue
        if dev[st, "speech_loss/dev"] < best_tts:
            best_tts = dev[st, "speech_loss/dev"]
            names |= {f"tts_{st}.pth"} if st > 1 else set()
        if per < best_per:
            best_per = per
            names |= {f"asr_{st}.pth"} if st > 1 else set()
    assert set(os.listdir(s.ckpdir)) == names
    assert solver is VqvaeSolver or names == {"best_per.pth"}


def test_resume_repeats_the_next_step_bit_for_bit(world, tmp_path):
    """Train 3 steps (paired, text-first, speech-first) saving after step
    2; a solver resumed from that checkpoint gives the third step, on the
    batches the straight run took, the same loss and parameters bit for
    bit."""
    config = copy.deepcopy(world["config"])
    config["hparas"]["max_step"] = 3
    s = _run(VqvaeSolver, config, _paras(str(tmp_path), "straight"))
    run_step, seen = s.trainer._train_step, {}

    def train_step(batch, unpaired=None):
        if s.trainer.step == 2:
            s.save("at_2.pth", 0.0)
            seen["args"] = (batch, unpaired)
        mets = run_step(batch, unpaired)
        if s.trainer.step == 2:
            seen["loss"] = mets["total_loss"].clone()
            seen["params"] = [p.detach().clone() for p in s.model.parameters()]
        return mets

    s.trainer._train_step = train_step
    s.exec()
    r = _run(VqvaeSolver, config, _paras(str(tmp_path), "resumed",
                                         load=join(s.ckpdir, "at_2.pth")))
    assert r.trainer.step == 2 and r.trainer.step_kind() == "speech_first"
    mets = r.trainer._train_step(*seen["args"])
    assert torch.equal(mets["total_loss"], seen["loss"])
    for a, b in zip(r.model.parameters(), seen["params"]):
        assert torch.equal(a, b)


def test_eval_step_decodes_the_margin(world):
    ps = world["port"]
    batch = next(iter(ps.dev_set))
    waves, wave_len, text, sid = (torch.from_numpy(batch[k])
                                  for k in ("waves", "wave_len", "text", "sid"))
    step = ps.builder.make_eval_step()
    base = step(ps.model, waves, wave_len, text, sid)
    more = step(ps.model, waves, wave_len, text, sid, margin_frames=7)
    T, r = base["mel"].shape[1], 3
    assert base["mel_pred"].shape[1] == T and more["mel_pred"].shape[1] == (T + 7) // r * r


def _write_yaml(root, config):
    path = join(root, "cli.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def test_cli_trains_one_step_in_a_subprocess(world, tmp_path):
    config = copy.deepcopy(world["config"])
    config["hparas"].update(max_step=1, valid_step=1)
    cfg = _write_yaml(str(tmp_path), config)
    res = subprocess.run([sys.executable, "-m", "semi_tts_tpu_torch", "--cpu", "--config", cfg,
                          "--logdir", str(tmp_path / "log"), "--ckpdir", str(tmp_path / "ckpt")],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Total training steps" in res.stdout
    assert os.path.isdir(tmp_path / "ckpt" / "cli-sd0") and os.listdir(tmp_path / "log" / "cli-sd0")


@pytest.mark.parametrize("flags,item", [(["--mesh", "2x1"], "A11"), (["--mesh", "1x2"], "A11")])
def test_cli_refuses_unported_flags(world, tmp_path, capsys, flags, item):
    cfg = _write_yaml(str(tmp_path), world["config"])
    with pytest.raises(SystemExit) as e:
        cli.main(["--cpu", "--config", cfg] + flags)
    assert e.value.code != 0 and f"ROADMAP {item}" in capsys.readouterr().err


@pytest.mark.parametrize("flag,fname", [("--pretrain-speech", "best_mel.pth"),
                                        ("--pretrain-text", "best_acc.pth")])
def test_cli_pretrain_flags_run_one_step(world, tmp_path, flag, fname):
    """``--pretrain-speech`` and ``--pretrain-text`` (refused until the
    language models were ported) train one step on the CPU and write their
    checkpoint."""
    config = copy.deepcopy(world["config"])
    config["hparas"].update(max_step=1, valid_step=1)
    cfg = _write_yaml(str(tmp_path), config)
    assert cli.main(["--cpu", "--no-msg", "--config", cfg, "--logdir", str(tmp_path / "log"),
                     "--ckpdir", str(tmp_path / "ckpt"), flag]) == 0
    assert _files(tmp_path / "ckpt" / "cli-sd0") == [fname]
    assert PCK.load_checkpoint(str(tmp_path / "ckpt" / "cli-sd0" / fname))["global_step"] == 1


def test_cli_refused_flag_exits_nonzero_in_a_subprocess(tmp_path):
    res = subprocess.run([sys.executable, "-m", "semi_tts_tpu_torch", "--mesh", "2x1", "--config",
                          "x"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "ROADMAP A11" in res.stderr


@pytest.mark.parametrize("mode,out", [("--gen-specgram", "_0k"), ("--gen-gt-specgram", "_gt"),
                                      ("--asr-decode", "_decode"), ("--asr-only", "")])
def test_cli_runs_each_mode(world, tmp_path, mode, out):
    config = copy.deepcopy(world["config"])
    config["hparas"].update(max_step=1, valid_step=1)
    cfg = _write_yaml(str(tmp_path), config)
    extra = ["--gen-wav"] if mode == "--gen-specgram" else []
    assert cli.main(["--cpu", "--no-msg", "--config", cfg, "--logdir", str(tmp_path / "log"),
                     "--ckpdir", str(tmp_path / "ckpt"), "--load", world["jax_ckpt"],
                     mode] + extra) == 0
    got = _files(tmp_path / "log" / f"cli-sd0{out}")
    assert got and (mode != "--gen-specgram" or any(f.endswith("-pred.wav") for f in got))


def test_cli_needs_a_card_without_cpu(world, tmp_path):
    """Without --cpu the solver resolves to the card; a host without one
    raises."""
    paras = _paras(str(tmp_path), "card", cpu=False)
    if torch.cuda.is_available():
        assert BaseSolver(world["config"], paras, "test").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BaseSolver(world["config"], paras, "test")


def test_cli_without_pyyaml_says_so(world, tmp_path, capsys, monkeypatch):
    cfg = _write_yaml(str(tmp_path), world["config"])
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(SystemExit):
        cli.main(["--cpu", "--config", cfg])
    assert "PyYAML" in capsys.readouterr().err


def test_pretrained_grafts_and_figures_are_refused(world, tmp_path):
    """A ``pretrained_asr`` graft (refused until the grafts were ported)
    now takes the checkpoint's whole ASR, parameters and BatchNorm
    statistics, and nothing else; figures (refused until they were
    ported) now reach the writer as images."""
    params, state, _ = world["jax"]
    config = copy.deepcopy(world["config"])
    config["model"]["pretrained_asr"] = world["jax_ckpt"]
    s = _run(VqvaeSolver, config, _paras(str(tmp_path), "graft"))
    got_p, got_s = to_jax_params(s.model)
    _assert_same_leaves(got_p["asr"], params["asr"])
    _assert_same_leaves(got_s["asr"], state["asr"])
    assert not np.array_equal(got_p["spkr_embed"], params["spkr_embed"])
    images = []
    s.log = type("Writer", (), {"add_image": lambda self, *a, **k: images.append((a, k))})()
    s.write_log("pair_align0", (np.zeros((2, 2)), "HW"))
    assert [(a[0], k["dataformats"]) for a, k in images] == [("pair_align0", "HW")]
