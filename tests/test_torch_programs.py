"""The port's programs beside its train steps', on the CPU, where a
program cache holds the eager functions (`semi_tts_tpu_torch/graphs.py`
`NoGradProgram`, `StepProgram`, `GraphOwner`):

- the eval step (`StepBuilder.make_eval_step`), Griffin-Lim
  (`ops/griffin_lim.griffin_lim_program`), the featurizer
  (`ops/features.featurize_program`), both LM steps and both LM dev losses
  (`train/train_lm.py`): each one's cache key (``margin_frames`` among the
  eval step's), capture at a shape's second call, its eager twin, and a
  body free of host round trips (`test_torch_graphs._NoHostSync`);
- the eval step's and Griffin-Lim's generators reseeded with `step_seed`:
  bit for bit the draws of the per-call `step_generator` that the callers
  made before (Griffin-Lim's also drawing on across calls without a seed);
- the byte budget of a `GraphOwner`, driven by an injected meter: past it a
  new shape runs eagerly with equal results, nothing is evicted, and
  ``over_budget_calls`` counts;
- parameters, buffers and every optimizer's state keep their storage across
  a step and a checkpoint restore (a graph replays by address);
- `data/step_shapes.py`'s dev, LM and budget counts.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import pytest
import torch

from helpers import make_paras, make_synthetic_corpus, tiny_config
from semi_tts_tpu_torch import graphs
from semi_tts_tpu_torch.data import step_shapes as SS
from semi_tts_tpu_torch.graphs import step_seed
from semi_tts_tpu_torch.ops.features import featurize_program, linear_to_amp
from semi_tts_tpu_torch.ops.griffin_lim import griffin_lim_program, specgram_to_waveform
from semi_tts_tpu_torch.train.solver import to_device
from semi_tts_tpu_torch.train.train_lm import (AudioLmSolver, TextLmSolver, make_audiolm_step,
                                                make_textlm_step)
from semi_tts_tpu_torch.train.train_vqvae import VqvaeSolver
from test_torch_graphs import no_host_sync  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTIMIZERS = ("Adam", "AdamW", "RMSprop", "SGD", "Adadelta")


def step_generator(seed, step_no, device):
    """A generator made per call and seeded with `step_seed`, as the eval
    step's and Griffin-Lim's callers made one before they were programs."""
    return torch.Generator(device=device).manual_seed(step_seed(seed, step_no))


def _paras(root, name, **kw):
    return make_paras(root, name=name, asr_decode=False, gen_specgram=False,
                      gen_gt_specgram=False, asr_only=False, **kw)


def _solver(cls, config, root, name):
    s = cls(config, _paras(root, name), "train")
    s.load_data()
    s.set_model()
    return s


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A tiny `VqvaeSolver` and both LM solvers on one synthetic corpus, a
    dev batch of two rows, and the two rows cut to other lengths."""
    root = str(tmp_path_factory.mktemp("torch_programs"))
    config = tiny_config(root)
    config["data"]["corpus"] = make_synthetic_corpus(root, n_per_split=(2, 2, 2, 1), seed=5)
    w = {"root": root, "config": config,
         "vqvae": _solver(VqvaeSolver, config, root, "vqvae"),
         "text": _solver(TextLmSolver, config, root, "text"),
         "speech": _solver(AudioLmSolver, config, root, "speech")}
    s = w["vqvae"]
    w["batch"] = tuple(t[:2] for t in to_device(next(iter(s.dev_set)), "cpu"))
    waves, wave_len, text, sid = w["batch"]
    w["short"] = (waves[:, :-441], torch.clamp(wave_len, max=waves.shape[1] - 441), text, sid)
    return w


def _eq(a, b):
    """Equal pytrees of tensors (None where both are None)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_eq(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    return (a is None and b is None) or torch.equal(a, b)


def _geo(acfg):
    return dict(n_fft=acfg.n_fft, hop=acfg.hop_length, win_length=acfg.win_length,
                preemphasis_coeff=acfg.preemphasis_coeff)


def _amp(world, T=8, seed=0):
    acfg = world["vqvae"].featurizer.cfg
    rng = np.random.RandomState(seed)
    return linear_to_amp(torch.from_numpy(rng.rand(2, T, acfg.num_freq).astype(np.float32)))


# ---- each program: key, capture at the second call, eager twin ---------------

def test_eval_program_keys_shape_model_and_margin(world):
    """One eval program a model, batch shape and ``margin_frames``, built at
    the key's second call; its outputs equal its eager twin's."""
    s = world["vqvae"]
    ev = s.builder.make_eval_step()
    m2 = copy.deepcopy(s.model)
    ev(s.model, *world["batch"], seed=1)
    ev(s.model, *world["batch"], seed=1, margin_frames=6)
    ev(m2, *world["batch"], seed=1)
    ev(s.model, *world["short"], seed=1)
    assert ev.programs() == [] and len(ev.calls) == 4
    got = ev(s.model, *world["batch"], seed=3, margin_frames=6)
    assert len(ev.programs()) == 1 and isinstance(ev.programs()[0], graphs.Eager)
    assert got["mel_pred"].shape[1] == (got["mel"].shape[1] + 6) // 3 * 3
    assert _eq(got, ev.eager(s.model, *world["batch"], seed=3, margin_frames=6))
    ev(s.model, *world["batch"], seed=1)
    assert len(ev.programs()) == 2


def test_eval_reseeding_matches_step_generator(world):
    """The trainer's eval program, reseeded with `step_seed` of (seed + 1,
    step * 100003 + i), draws the prenet dropout a per-call `step_generator`
    of the same pair drew (prenet dropout 0.5 here), at the first call and
    from the program."""
    s = world["vqvae"]
    t = s.trainer
    ev = s.builder.make_eval_step()
    for step in (4, 4, 5):
        t.step = step
        got = t._eval(1, *world["batch"])
        with torch.no_grad():
            want = ev.body(s.model, *world["batch"],
                           generator=step_generator(t.seed + 1, step * 100003 + 1, "cpu"))
        assert _eq(got, want)
    other = ev.body(s.model, *world["batch"], generator=step_generator(t.seed + 1, 7, "cpu"))
    assert not torch.equal(got["mel_pred"], other["mel_pred"])  # the dropout is drawn
    assert len(t._eval_step.programs()) == 1
    t.step = 0


def test_griffin_lim_program_keys_and_draws(world):
    """One Griffin-Lim program a magnitude shape and geometry; its phases
    come from its generator: reseeded with a seed, the draws of a
    `step_generator` of the same pair, and without one they go on as that
    generator's would over the callers' successive calls."""
    acfg = world["vqvae"].featurizer.cfg
    gl, geo = griffin_lim_program(), _geo(acfg)
    a, b = _amp(world), _amp(world, seed=1)
    g = step_generator(3, 9, "cpu")
    want = [specgram_to_waveform(x, g, n_iter=4, **geo) for x in (a, b, a)]
    got = [gl(a, seed=step_seed(3, 9), n_iter=4, **geo), gl(b, n_iter=4, **geo),
           gl(a, n_iter=4, **geo)]
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert len(gl.programs()) == 1  # built at the shape's second call
    assert torch.equal(gl(a, seed=step_seed(3, 9), n_iter=4, **geo), want[0])
    gl(a, seed=0, n_iter=3, **geo)
    gl(_amp(world, T=9), seed=0, n_iter=4, **geo)
    assert len(gl.calls) == 3 and len(gl.programs()) == 1
    assert torch.equal(gl.eager(a, seed=5, n_iter=4, **geo),
                       specgram_to_waveform(a, torch.Generator().manual_seed(5), n_iter=4, **geo))


def test_featurize_program_keys_by_shape(world):
    s = world["vqvae"]
    feat = featurize_program(s.featurizer)
    waves, wave_len, _, _ = world["batch"]
    want = s.featurizer.featurize(waves, wave_len)
    assert _eq(feat(waves, wave_len), want) and feat.programs() == []
    assert _eq(feat(waves, wave_len), want) and len(feat.programs()) == 1
    feat(*world["short"][:2])
    assert len(feat.programs()) == 1 and len(feat.calls) == 2


def _lm_step(lm):
    """A copy of an LM solver's model and optimizer and a step program of
    its kind over them, on an owner of its own."""
    model, opt = copy.deepcopy((lm.model, lm.optimizer))
    owner = graphs.GraphOwner("cpu")
    if lm.lm_mode == "speech":
        step = make_audiolm_step(lm.featurizer, opt, lm.floss, lambda dev: owner,
                                 seed=lm.paras.seed)
    else:
        step = make_textlm_step(opt, lambda dev: owner)
    return model, opt, step


@pytest.mark.parametrize("mode", ["text", "speech"])
def test_lm_step_program_matches_its_eager_twin(world, mode):
    """An LM solver's step is a `StepProgram` built at a shape's second
    call; from one copied state its steps equal the eager twin's, bit for
    bit, parameters, BatchNorm statistics and optimizer state included."""
    lm, batch = world[mode], world["batch"]
    assert isinstance(lm._step, graphs.StepProgram)
    (m, opt, step), (m2, opt2, twin) = _lm_step(lm), _lm_step(lm)
    for n in (1, 2, 3):
        assert _eq(step(m, n, *lm._args(batch)), twin.eager(m2, n, *lm._args(batch)))
    assert len(step.programs()) == 1 and len(step.calls) == 1
    for a, b in zip(opt.state_tensors() + list(m.state_dict().values()),
                    opt2.state_tensors() + list(m2.state_dict().values())):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["text", "speech"])
def test_lm_dev_program_returns_the_loss_tensor(world, mode):
    """`LmSolver.dev_loss` runs the dev program and returns a 0-d tensor
    (read on the host by `validate`), equal to the loss of the eager body
    with the per-call generator of (seed + 1, step * 100003 + i)."""
    s = world[mode]
    s.step = 3
    batch = world["batch"]
    got = [s.dev_loss(1, batch) for _ in range(3)]
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in got)
    g = step_generator(s.paras.seed + 1, 3 * 100003 + 1, "cpu")
    with torch.no_grad():
        want = s._dev.body(s.model, *s._args(batch), generator=g)
    assert all(torch.equal(v, want) for v in got)
    assert len(s._dev.programs()) == 1
    s.step = 0


# ---- no host round trip in a body -------------------------------------------

PROGRAMS = ("eval", "griffin_lim", "featurize", "text_lm", "speech_lm", "text_lm_dev",
            "speech_lm_dev")


@pytest.mark.parametrize("kind", PROGRAMS)
def test_program_body_has_no_host_sync(world, no_host_sync, kind):  # noqa: F811
    s, batch = world["vqvae"], world["batch"]
    if kind == "eval":
        prog, args, kw = s.builder.make_eval_step(), (s.model,) + batch, dict(margin_frames=6)
    elif kind == "griffin_lim":
        prog, args, kw = griffin_lim_program(), (_amp(world),), dict(n_iter=3,
                                                                     **_geo(s.featurizer.cfg))
    elif kind == "featurize":
        prog, args, kw = featurize_program(s.featurizer), batch[:2], {}
    else:
        lm = world[kind.split("_")[0]]
        if kind.endswith("dev"):
            prog, args, kw = lm._dev, (lm.model,) + lm._args(batch), {}
        else:
            model, _, prog = _lm_step(lm)
            args, kw = (model, 2) + lm._args(batch), {}
    prog(*args, **kw)  # warm the cached tables
    with no_host_sync:
        out = prog(*args, **kw)
    assert all(torch.isfinite(t).all() for t in torch.utils._pytree.tree_leaves(out)
               if isinstance(t, torch.Tensor) and t.is_floating_point())


# ---- the byte budget -----------------------------------------------------------

class _Meter:
    """An injected byte meter: each call of a program's body takes ``per``
    more bytes, half in the owner's pool (which the allocator reserves) and
    half outside the allocator."""

    def __init__(self, per=100):
        self.per, self.pool, self.used = per, 0, 0

    def take(self):
        self.pool += self.per // 2
        self.used += self.per

    def __call__(self):
        return self.pool, self.pool, self.used


def _budget_programs(kind, meter, owner):
    if kind == "no_grad":
        def body(x, *, generator):
            meter.take()
            return x * 2 + torch.rand(x.shape, generator=generator)
        prog = graphs.NoGradProgram(body, lambda dev: owner)
        return prog, lambda x, seed: prog(x, seed=seed), lambda x, seed: prog.eager(x, seed=seed)

    def step(model, step_no, x, *, generator):
        meter.take()
        return {"y": x * step_no + torch.rand(x.shape, generator=generator)}
    prog = graphs.StepProgram(step, None, 7, lambda dev: owner)
    model = torch.nn.Linear(1, 1)
    return (prog, lambda x, seed: prog(model, seed, x)["y"],
            lambda x, seed: prog.eager(model, seed, x)["y"])


@pytest.mark.parametrize("kind", ["no_grad", "step"])
def test_budget_runs_new_shapes_eagerly_and_evicts_nothing(kind):
    """Under a budget of two captures, a third shape's later calls run
    eagerly (each counted in ``over_budget_calls``; the notice once), equal
    to its eager twin, while the two programs stay cached and replay."""
    meter, notes = _Meter(), []
    owner = graphs.GraphOwner("cpu", budget_bytes=200, meter=meter, notify=notes.append)
    prog, call, eager = _budget_programs(kind, meter, owner)
    xs = [torch.ones(n) for n in (2, 3, 4)]
    for x in xs[:2]:
        call(x, 1)
        call(x, 1)
    assert len(prog.programs()) == 2 and owner.graph_bytes == [{"pool": 50, "outside": 50}] * 2
    assert owner.spent() == 200 and not owner.admit()
    first = prog.programs()
    for n in range(4):
        assert torch.equal(call(xs[2], n + 3), eager(xs[2], n + 3))
    assert owner.over_budget_calls == 3 and len(notes) == 1
    assert prog.programs() == first and len(owner.graph_bytes) == 2
    assert torch.equal(call(xs[0], 9), eager(xs[0], 9))  # a cached shape still runs its program
    owner.budget_bytes = 300  # room for one more: the third shape is built at its next call
    call(xs[2], 4)
    assert len(prog.programs()) == 3 and owner.spent() == 300 and owner.over_budget_calls == 3


def test_owner_on_the_cpu_has_no_budget():
    owner = graphs.GraphOwner("cpu")
    assert owner.budget_bytes is None and owner.meter is None and owner.admit()
    with owner.metered():
        pass
    assert owner.graph_bytes == [] and owner.spent() == 0


def test_trainers_and_solvers_share_one_owner(world):
    """The eval, train and Griffin-Lim programs of a trainer share its
    builder's owner; an LM solver's step and dev programs share its own."""
    s = world["vqvae"]
    owner = s.builder.graph_owner("cpu")
    t = s.trainer
    assert all(p.owner("cpu") is owner for p in (t._step_fn, t._eval_step, t._vocoder))
    assert owner.notify == s.verbose
    for mode in ("text", "speech"):
        lm = world[mode]
        assert lm._step.owner("cpu") is lm._dev.owner("cpu") is lm.graph_owner


# ---- storage kept across a step and a restore ------------------------------------

def _ptrs(solver):
    return [t.data_ptr() for t in list(solver.model.parameters()) + list(solver.model.buffers())
            + solver.optimizer.state_tensors()]


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_lm_state_stays_in_place(world, tmp_path, optimizer):
    """Each optimizer writes its state in place: the text LM's parameters
    and every optimizer state tensor keep their storage across steps and
    across `LmSolver.load` of its own checkpoint, whose values come back."""
    config = copy.deepcopy(world["config"])
    config["hparas"]["optimizer"] = optimizer
    s = _solver(TextLmSolver, config, str(tmp_path), f"inplace_{optimizer}")
    ptrs = _ptrs(s)
    for step in range(3):
        s.step = step
        s.train_step(world["batch"])
        assert _ptrs(s) == ptrs
    s.step = 3
    s._save(1.0)
    saved = [t.clone() for t in s.optimizer.state_tensors() + list(s.model.parameters())]
    s.train_step(world["batch"])
    s.load(os.path.join(s.ckpdir, "best_acc.pth"))
    assert _ptrs(s) == ptrs
    assert all(torch.equal(a, b) for a, b in
               zip(s.optimizer.state_tensors() + list(s.model.parameters()), saved))


def test_vqvae_state_stays_in_place_across_load_and_grafts(world, tmp_path):
    """`VqvaeSolver.load` and the ``pretrained_*`` grafts write into the
    tensors a captured graph reads."""
    s = _solver(VqvaeSolver, world["config"], str(tmp_path), "inplace")
    ptrs = _ptrs(s)
    s.trainer.step = 1
    s.trainer._train_step(world["batch"])
    s.ckpdir = str(tmp_path)
    s.save("resume.pth", 0.0)
    s.load(os.path.join(str(tmp_path), "resume.pth"))
    assert _ptrs(s) == ptrs
    from semi_tts_tpu_torch.train.checkpoint import apply_pretrained

    apply_pretrained(s.model, {"asr": os.path.join(str(tmp_path), "resume.pth")})
    assert _ptrs(s) == ptrs


# ---- shape counts ---------------------------------------------------------------

def test_step_shapes_counts_dev_lm_and_budget():
    """The dev split's shapes are one pass longest first, the last batch
    short; the LMs' keys are the wave and text buckets of the unpaired
    batches; a budget of as many graphs as shapes replays what an unbounded
    cache does, and fewer graphs replay less."""
    d = [3.1, 1.2, 2.9, 0.8, 1.9, 3.0, 2.2, 1.0, 0.9, 2.5, 1.1]
    keys = SS.dev_keys(d, batch_size=4)
    assert len(keys) == 3 and keys[0][0] == 4 * 22050 and keys[-1][0] == 22050
    assert SS.dev_keys(d, batch_size=4, text=False)[1] == (int(2.5 * 22050), 0)
    table = os.path.join(REPO, "data/partition_tables/semi-multi-spkr-sd0.csv")
    lm = SS.lm_keys(table, 200)
    both = SS.batch_keys([r["duration"] for r in SS.read_partition(table, "unpaired")], 200)
    assert lm["audio_lm"] == [(w,) for w, _ in both] and lm["text_lm"] == [(t,) for _, t in both]
    steps = SS.step_keys(table, 400)
    all_shapes = len(set(steps))
    unbounded = SS.cache_counts(steps, 8)["replays"] / len(steps)
    assert SS.budgeted_replays(steps, all_shapes) == unbounded
    assert SS.budgeted_replays(steps, 4) < unbounded
