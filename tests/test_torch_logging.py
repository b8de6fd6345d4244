"""What a training run shows its user, the port against the JAX package:
the progress timer (`utils/timer.py`), the ``--profile`` window, the
TensorBoard routing of `BaseSolver.write_log`, the figures' inputs
(`utils/viz.py`), the mel-to-linear inverse, the codebook projector's
table, and the tags a short `VqvaeSolver` run logs. The JAX trainer runs
with its steps stubbed (the loop's logic is what is compared; the steps are
held to JAX in the training tests)."""

from __future__ import annotations

import contextlib
import glob
import itertools
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_paras, tiny_config
from semi_tts_tpu.models import embed as JE
from semi_tts_tpu.ops import features as JF
from semi_tts_tpu.ops import griffin_lim as JG
from semi_tts_tpu.train import train_vqvae as JTV
from semi_tts_tpu.train.solver import BaseSolver as JBaseSolver
from semi_tts_tpu.utils import timer as JT
from semi_tts_tpu.utils import viz as JVZ
from semi_tts_tpu_torch.bridge import to_jax_params
from semi_tts_tpu_torch.models import embed as PE
from semi_tts_tpu_torch.ops import features as PF
from semi_tts_tpu_torch.train import train_vqvae as PTV
from semi_tts_tpu_torch.train.solver import BaseSolver
from semi_tts_tpu_torch.train.steps import Weights
from semi_tts_tpu_torch.utils import timer as PT
from semi_tts_tpu_torch.utils import viz as PVZ
from test_torch_tools import _model


def _shape(v):
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return ("array", tuple(v.shape), float(np.asarray(v, np.float64).sum()))
    if isinstance(v, (list, tuple)):
        return tuple(_shape(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _shape(x)) for k, x in v.items()))
    return v


class Recorder:
    """A TensorBoard writer that keeps (method, arguments) of each call,
    arrays as (shape, sum)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, method):
        if method.startswith("_"):
            raise AttributeError(method)
        return lambda *a, **k: self.calls.append((method, _shape(a), _shape(k)))

    def tags(self):
        """{(method, tag, step)}: the tag is the first argument (add_embedding's
        ``tag``), the step the last positional or ``global_step``."""
        out = set()
        for method, a, k in self.calls:
            kw = dict(k)
            tag = kw.get("tag", a[0] if a else None)
            step = kw.get("global_step", a[2] if len(a) > 2 else None)
            out.add((method, tag, step))
        return out


def test_timer_prints_jax_string(monkeypatch):
    clock = itertools.count(0.0, 0.25)
    monkeypatch.setattr("time.time", lambda: next(clock))
    shown = []
    for mod in (JT, PT):
        t = mod.Timer()
        t.set()
        for mode in ("rd", "fw", "bw", "rd", "fw", "bw", "bw"):
            t.cnt(mode)
        shown.append((t.show(), t.show()))
    assert shown[0] == shown[1]
    assert shown[1][0].endswith("sec/step (rd 28.6% | fw 28.6% | bw 42.9%)")
    assert shown[1][1] == "0.000 sec/step ()"


def _window_run(trainer, start, max_step, record):
    """Drive ``trainer``'s exec from ``start`` to ``max_step`` with every
    step and validation stubbed; returns the (entered, closed) steps of its
    profiler windows."""
    trainer.step, trainer.max_step = start, max_step

    @contextlib.contextmanager
    def trace(logdir):
        record.append(["enter", trainer.step])
        yield
        record.append(["close", trainer.step])

    return trace


def _jax_stub_trainer(root, batch):
    config = tiny_config(root, max_step=10, valid_step=10 ** 6)
    t = JTV.VqvaeTrainer(config, make_paras(root, profile=True), "train")
    t.log, t.model_cfg, t.mesh = None, types.SimpleNamespace(use_asr_postnet=False), None
    t.params = t.state = t.opt_state = t.rng = None
    t.pair_iter, t.tf_rate = itertools.repeat(batch), lambda s: 1.0
    t.vocab_size, t.tokenizer = 4, types.SimpleNamespace(_vocab_list=list("abcd"))
    mets = dict(total_loss=1.0, grad_norm=1.0, asr_loss=1.0, tts_loss=1.0,
                pair_pred=np.ones((1, 4), np.int32), pair_pred_len=np.array([4]),
                pair_align=np.zeros((1, 3, 3)))
    t._paired_step = lambda *a: (None, None, None, mets)
    t.validate = lambda: None
    return t


@pytest.mark.parametrize("start,max_step", [(0, 2), (0, 3), (0, 100), (37, 60), (5, 6)])
def test_profile_window_matches_jax(tmp_path, monkeypatch, start, max_step):
    """The window opens and closes at the JAX trainer's steps, anchored to
    the step a (resumed) run starts from, and closes at the end of a run
    whose ``max_step`` falls inside it."""
    batch = types.SimpleNamespace(waves=None, wave_len=None, text=np.full((1, 4), 5, np.int32),
                                  sid=None)
    monkeypatch.setattr(JTV, "feat_to_fig", lambda x: None)
    got, want = [], []
    jt = _jax_stub_trainer(str(tmp_path), batch)
    monkeypatch.setattr(JT, "profile_trace", _window_run(jt, start, max_step, want))
    jt.exec()
    pt = object.__new__(PTV.VqvaeTrainer)
    pt.builder = types.SimpleNamespace(w=Weights())
    pt.timer, pt.profile_dir, pt.progress_step, pt.valid_step = PT.Timer(), "x", 20, 10 ** 6
    pt.pair_iter, pt._pending = itertools.repeat(None), []
    pt._train_step = lambda *a: {}
    pt._progress = pt.validate = lambda *a: None
    monkeypatch.setattr(PTV, "profile_trace", _window_run(pt, start, max_step, got))
    pt.exec()
    assert got == want and (want == []) == (start + 1 >= max_step)
    assert PT.profile_window(start, max_step) == (
        start + min(40, max(1, (max_step - start) // 2)),
        min(max_step, start + min(40, max(1, (max_step - start) // 2)) + 20))


LOGS = [("pair_align0", (np.ones((4, 5, 3)), "HWC")), ("mel_spec1_gt", (np.ones((3, 2, 3)), "HWC")),
        ("unpair_hist", (np.zeros((2, 2, 3)), "HWC")),
        ("codebook", (np.arange(6.0).reshape(3, 2), ["<pad>", "a", "b"])),
        ("mel_wave0", (np.linspace(-1, 1, 7), 22050)), ("linear_wave2_gt", (np.zeros(3), 16000)),
        ("hyp_text0", "AH B"), ("truth_text3", "K"), ("per", {"pair": 0.5, "unpair": None}),
        ("speech_loss", {"dev": float("nan"), "pair": 2.0}), ("txt_loss", {}), ("grad", None)]


@pytest.mark.parametrize("soundfile", [False, True])
@pytest.mark.parametrize("name,value", LOGS, ids=[n for n, _ in LOGS])
def test_write_log_routes_as_jax(monkeypatch, name, value, soundfile):
    """The same writer methods with the same tags, values and steps as JAX's
    `BaseSolver.write_log`, for every class of name; audio only with
    ``soundfile`` importable."""
    monkeypatch.setitem(sys.modules, "soundfile",
                        types.ModuleType("soundfile") if soundfile else None)
    calls = []
    for cls in (JBaseSolver, BaseSolver):
        s = object.__new__(cls)
        s.log, s.step = Recorder(), 7
        s.write_log(name, value)
        calls.append(s.log.calls)
    assert calls[0] == calls[1]
    assert bool(calls[1]) == (name not in ("txt_loss", "grad")
                              and ("wave" not in name or soundfile))


def test_data_to_bar_gets_jax_counts(monkeypatch):
    """The bars drawn from count vectors are JAX's bars drawn from token lists."""
    rng = np.random.RandomState(5)
    seen = {}
    for key, mod in (("jax", JVZ), ("port", PVZ)):
        monkeypatch.setattr(mod, "_save_canvas",
                            lambda data, meta=None, key=key: seen.setdefault(key, []).append(
                                ([list(map(float, d)) for d in data], list(meta[0]), meta[1])))
    tick = [str(i) for i in range(9)]
    for n, m in ((50, 30), (7, 1), (3, 0)):
        tok, gt = rng.randint(0, 9, n).tolist(), rng.randint(0, 9, m).tolist()
        want = JVZ.data_to_bar(tok, gt, 9, tick)
        got = PVZ.data_to_bar(np.bincount(tok), np.bincount(gt, minlength=1), 9, tick)
        assert (got is None) == (want is None) == (m == 0)
    assert seen["port"] == seen["jax"] and len(seen["jax"]) == 2


def test_mel_to_linear_amp_matches_jax():
    rng = np.random.RandomState(6)
    mel = (rng.rand(2, 9, 20) * 1.2 - 0.1).astype(np.float32)
    want = np.asarray(JF.AudioFeaturizer(JF.AudioConfig(num_freq=257, num_mels=20))
                      .mel_to_linear_amp(jnp.asarray(mel)))
    got = PF.AudioFeaturizer(PF.AudioConfig(num_freq=257, num_mels=20), device="cpu") \
        .mel_to_linear_amp(torch.from_numpy(mel)).numpy()
    assert got.shape == (2, 9, 257)
    # amplitudes reach ~300 here; fp32 products in another order: 1e-5 of the largest
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bone", ["seperate", "l2"])
def test_full_codebook_table_matches_jax(tmp_path, bone):
    _, cfg, jcfg, model, attr = _model(str(tmp_path), bone)
    want = np.asarray(JE.full_codebook_table(
        {k: jnp.asarray(v) if not isinstance(v, dict) else {a: jnp.asarray(b) for a, b in v.items()}
         for k, v in to_jax_params(model)[0]["codebook"].items()},
        jcfg.codebook, jnp.asarray(attr)))
    got = PE.full_codebook_table(model.codebook, cfg.codebook, torch.from_numpy(attr))
    assert got.shape == (cfg.vocab_size, cfg.codebook.latent_dim)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)


def _jax_tags(root, config, batches):
    """The tags JAX's `VqvaeTrainer` logs over 2 steps validated every
    step, its train and eval steps, Griffin-Lim and figures stubbed by
    arrays of the shapes they return."""
    t = JTV.VqvaeTrainer(config, make_paras(root, name="jax"), "train")
    t.load_data()
    t.log = Recorder()
    r, n_mels, n_lin = 3, config["data"]["audio"]["num_mels"], config["data"]["audio"]["num_freq"]
    t.model_cfg = types.SimpleNamespace(use_asr_postnet=False, codebook=None)
    t.params, t.state, t.opt_state, t.phn_attr, t.mesh = {"codebook": None}, None, None, None, None
    t.rng, t.tf_rate, t.pair_iter = JTV.jax.random.PRNGKey(0), lambda s: 1.0, iter(batches)
    t.save_checkpoint_triple = lambda *a, **k: None

    def paired(*a):
        B, U = a[8].shape
        return t.params, None, None, dict(
            total_loss=1.0, grad_norm=1.0, asr_loss=1.0, tts_loss=1.0,
            pair_pred=np.ones((B, 6), np.int32), pair_pred_len=np.full(B, 6),
            pair_align=np.zeros((B, 4, U)))

    def evaluate(params, state, rng, key, waves, wave_len, text, sid):
        B, U = text.shape
        T = 12
        return dict(enc_len=np.full(B, 6), p_code=np.ones((B, 6, 5)), post_prob=None,
                    tts_loss=1.0, mel_pred=np.zeros((B, T, n_mels)),
                    lin_pred=np.zeros((B, T, n_lin)), align=np.zeros((B, T // r, U)),
                    mel=np.zeros((B, T - 3, n_mels)), linear=np.zeros((B, T - 3, n_lin)))

    t._paired_step, t._eval_step = paired, evaluate
    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(JG, "specgram_to_waveform",
                                     lambda amp, rng, **k: np.zeros(amp.shape[:2])))
        stack.enter_context(_patched(JE, "full_codebook_table", lambda *a: np.zeros((5, 3))))
        # the port's run draws its own figures
        fig = (np.zeros((1, 1, 3)), "HWC")
        stack.enter_context(_patched(JTV, "feat_to_fig", lambda feat: fig))
        stack.enter_context(_patched(JTV, "data_to_bar", lambda d, gt, *a: fig if gt else None))
        t.exec()
    return t.log.tags()


@contextlib.contextmanager
def _patched(mod, name, value):
    old = getattr(mod, name)
    setattr(mod, name, value)
    try:
        yield
    finally:
        setattr(mod, name, old)


def test_solver_run_logs_jax_tags_and_profiles(tmp_path, monkeypatch):
    """A 2-step `VqvaeSolver` run validated every step, with a writer,
    ``soundfile`` and ``--profile``: every figure, text, audio and
    projector tag of JAX's run at the same steps (and JAX's scalar tags
    among its own), Griffin-Lim audio of the dev predictions and, at step
    1, of the ground truth, and a trace in the log directory."""
    monkeypatch.setitem(sys.modules, "soundfile", types.ModuleType("soundfile"))
    root = str(tmp_path)
    config = tiny_config(root, max_step=2, valid_step=1)
    s = PTV.VqvaeSolver(config, make_paras(root, name="port", profile=True), "train")
    s.log = Recorder()
    s.load_data()
    s.set_model()
    batches = []
    pairs = s.trainer.pair_iter
    s.trainer.pair_iter = (batches.append(b) or b for b in pairs)
    s.exec()
    got = s.log.tags()
    host = [types.SimpleNamespace(waves=w.numpy(), wave_len=wl.numpy(), text=tx.numpy(),
                                  sid=sd.numpy()) for w, wl, tx, sd in batches]
    want = _jax_tags(root, config, host)
    media = {x for x in want if x[0] != "add_scalars"}
    assert {x for x in got if x[0] != "add_scalars"} == media
    assert want <= got
    for tag in ("pair_align0", "hyp_text0", "mel_spec0", "linear_spec0", "dv_align0",
                "mel_wave0", "linear_wave0", "mel_spec0_gt", "linear_spec0_gt", "mel_wave0_gt",
                "linear_wave0_gt", "truth_text0", "codebook"):
        assert any(x[1] == tag for x in media), tag
    audio = [a for m, a, _ in s.log.calls if m == "add_audio"]
    assert all(a[1][0] == "array" and a[1][1][1] == 1 and a[3] == 22050 for a in audio)
    assert glob.glob(f"{s.logdir}/*.pt.trace.json")
