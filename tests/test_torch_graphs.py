"""The port's compiled programs (`semi_tts_tpu_torch/graphs.py`) on the CPU,
where the program cache holds the eager stages and steps:

- twins of the JAX server's cache tests (`tests/test_serve.py`) against the
  port's `TTSServer(device="cpu")`: eviction and rebuild, an 8-thread
  hammer against a 2-entry cache, and an in-flight build that is neither
  evicted nor duplicated;
- the optimizer's state tensors stay where they were allocated (the
  storage a CUDA graph captured) across steps, `advance_lr_schedule` and a
  checkpoint restore, with the moments equal to optax's;
- a guard that one serving synthesis and one train step of each kind
  (paired, speech-first, text-first, ASR) make no host round trip inside
  their body: no ``aten::_local_scalar_dense`` (``.item()``, ``float(t)``,
  ``bool(t)``) and no ``aten::lift_fresh`` (a tensor made from host data),
  either of which a captured graph cannot replay. The kernels' plain
  versions, which never run on the card, are exempt.
"""

from __future__ import annotations

import copy
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from helpers import make_paras, make_synthetic_corpus, tiny_config
from semi_tts_tpu.train.optim import make_optimizer
from semi_tts_tpu_torch import graphs
from semi_tts_tpu_torch.serve import TTSServer
from semi_tts_tpu_torch.train import optim as PO
from semi_tts_tpu_torch.train.checkpoint import (load_checkpoint, load_optimizer_tree,
                                                 optimizer_tree, save_checkpoint)
from semi_tts_tpu_torch.train.train_asr import make_asr_step
from semi_tts_tpu_torch.train.train_vqvae import SPEECH_FIRST, TEXT_FIRST, VqvaeSolver


@pytest.fixture(scope="module")
def solver(tmp_path_factory):
    """A tiny `VqvaeSolver` with both cycles on, after load_data and
    set_model, and one batch of each loader."""
    root = str(tmp_path_factory.mktemp("torch_graphs"))
    config = tiny_config(root, unpair_speech=1.0, unpair_text=1.0)
    config["data"]["corpus"] = make_synthetic_corpus(root, n_per_split=(2, 2, 1, 1), seed=3)
    s = VqvaeSolver(config, make_paras(root, name="graphs", asr_decode=False,
                                       gen_specgram=False, gen_gt_specgram=False,
                                       asr_only=False), "train")
    s.load_data()
    s.set_model()
    s.batch, s.u_batch = (tuple(t[:1] for t in next(it))  # one row a batch: the plain
                          for it in (s.trainer.pair_iter, s.trainer.unpair_iter))  # path is slow
    return s


def _server(solver, size):
    return TTSServer(solver.model_cfg, solver.featurizer.cfg, solver.phn_attr,
                     copy.deepcopy(solver.model), device="cpu", program_cache_size=size)


def _requests(B=2, U=6, seed=0):
    rng = np.random.RandomState(seed)
    text = np.zeros((B, U), np.int32)
    text[:, :U - 2] = rng.randint(3, 40, size=(B, U - 2))
    return text, rng.randint(0, 3, size=B).astype(np.int32)


# ---- twins of tests/test_serve.py's program-cache tests -----------------------

def test_program_cache_eviction_recompiles(solver):
    """The per-instance program cache is BOUNDED: eviction drops the LRU
    program and a re-requested bucket rebuilds it to an identical result."""
    small = _server(solver, 1)
    text, sid = _requests()
    wav_a = small.synthesize(text, sid, 17, decode_steps=4)
    first = small.stages(4, *text.shape)
    small.synthesize(text, sid, 17, decode_steps=8)  # evicts the 4-bucket
    assert ("stages", 4) + text.shape not in small._cache._programs
    assert len(small._cache._programs) == 1
    wav_b = small.synthesize(text, sid, 17, decode_steps=4)  # rebuild
    assert small.stages(4, *text.shape) is not first
    np.testing.assert_array_equal(wav_a, wav_b)


def test_synthesize_thread_safety_hammer(solver):
    """8 threads hammer `synthesize` with mixed decode lengths against a
    2-entry program cache: every waveform is finite and identical to the
    single-threaded result for the same key, and the LRU never exceeds its
    bound (completed cells; mid-build cells are never eviction victims)."""
    srv = _server(solver, 2)
    text, sid = _requests()
    lengths = [2, 3, 4]  # 3 buckets > cache size 2 -> constant eviction
    keys = {d: 100 + d for d in lengths}
    expect = {d: srv.synthesize(text, sid, keys[d], decode_steps=d) for d in lengths}
    n_threads, n_reqs = 8, 3
    errors, bound_violations = [], []
    barrier = threading.Barrier(n_threads)

    def worker(tid):
        try:
            barrier.wait()
            for i in range(n_reqs):
                d = lengths[(tid + i) % len(lengths)]
                wav = srv.synthesize(text, sid, keys[d], decode_steps=d)
                if not np.isfinite(wav).all():
                    errors.append((tid, d, "non-finite"))
                if not np.array_equal(wav, expect[d]):
                    errors.append((tid, d, "nondeterministic"))
                with srv._cache._lock:
                    n_done = sum(v._done for v in srv._cache._programs.values())
                    n_all = len(srv._cache._programs)
                if n_done > srv.program_cache_size + 1:  # +1: before the post-build trim
                    bound_violations.append(("done", n_done))
                if n_all > srv.program_cache_size + len(lengths):
                    bound_violations.append(("all", n_all))
        except Exception as e:  # noqa: BLE001 — surface in the main thread
            errors.append((tid, None, repr(e)))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
    assert not bound_violations, bound_violations
    assert len(srv._cache._programs) <= srv.program_cache_size


def test_inflight_build_never_evicted_or_duplicated(solver):
    """Eviction pressure while a bucket's build is in flight neither evicts
    the mid-build cell nor runs the build twice; concurrent requests for
    the same bucket share one build (`graphs._Once` + done-only eviction)."""
    srv = _server(solver, 1)
    calls = []
    started, release = threading.Event(), threading.Event()

    def slow_build():
        calls.append(1)
        started.set()
        release.wait(60)
        return "slow-value"

    out = {}
    t1 = threading.Thread(
        target=lambda: out.setdefault("a", srv._cached_program("t", 1, 2, 6, slow_build)))
    t1.start()
    assert started.wait(10)
    for i in range(2, 5):  # fill and churn the 1-entry cache while slow is live
        assert srv._cached_program("t", i, 2, 6, lambda i=i: "v%d" % i) == "v%d" % i
    assert ("t", 1, 2, 6) in srv._cache._programs, "in-flight cell was evicted"
    t2 = threading.Thread(
        target=lambda: out.setdefault("b", srv._cached_program("t", 1, 2, 6, slow_build)))
    t2.start()
    time.sleep(0.2)
    release.set()
    t1.join(30)
    t2.join(30)
    assert not t1.is_alive() and not t2.is_alive()
    assert out["a"] == out["b"] == "slow-value"
    assert len(calls) == 1, "duplicate build of an in-flight bucket"
    assert len(srv._cache._programs) <= srv.program_cache_size


def test_step_programs_cache_by_shape_and_keywords(solver):
    """A train step keeps one program a model, set of input shapes and
    given keywords, built at the shape's second call (the first runs
    eagerly); its metrics equal its eager twin's, which reseeds the same
    generator from (seed, step_no)."""
    m = copy.deepcopy(solver.model)
    opt = PO.Optimizer(m.parameters(), lr=1e-3, lr_scheduler="fixed")
    step = solver.builder.make_paired_step(opt, seed=5)
    waves, wave_len, text, sid = solver.batch
    step(m, 1, 1.0, waves, wave_len, text, sid)
    step(m, 2, 1.0, waves[:, :-1], wave_len, text, sid)
    assert step.programs() == []  # each shape seen once
    step(m, 3, 1.0, waves[:, :-1], wave_len, text, sid)
    assert len(step.programs()) == 1
    step(m, 4, 1.0, waves, wave_len, text, sid)
    assert len(step.programs()) == 2
    m2 = copy.deepcopy(m)
    opt2 = PO.Optimizer(m2.parameters(), lr=1e-3, lr_scheduler="fixed")
    for a, b in zip(opt2.state_tensors(), opt.state_tensors()):
        a.copy_(b)
    step2 = solver.builder.make_paired_step(opt2, seed=5)
    got = step(m, 5, 0.5, waves, wave_len, text, sid)
    assert len(step.programs()) == 2 and sum(step.calls.values()) == 5
    want = step2.eager(m2, 5, 0.5, waves, wave_len, text, sid)
    assert torch.equal(got["total_loss"], want["total_loss"])
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), m2.parameters()))


def test_step_program_cache_is_unbounded():
    """A step keeps every shape it captured (as `jax.jit` does): a corpus
    gives hundreds of step shapes (`data/step_shapes.py`), and a bounded
    LRU over them would capture again on most steps. A server's cache
    stays bounded."""
    step = graphs.StepProgram(lambda m, n, x, *, generator: x * 2, None, 0, None)
    model = torch.nn.Linear(1, 1)
    step.capture_at = 1
    for n in range(12):
        assert torch.equal(step(model, n, torch.ones(n + 1)), torch.full((n + 1,), 2.0))
    assert len(step.programs()) == 12
    cache = graphs.ProgramCache(2)
    for k in range(5):
        cache.get(k, lambda k=k: k)
    assert list(cache._programs) == [3, 4]


def test_signature_keys_shapes_dtypes_and_constants():
    """A program's key holds every tensor's shape and dtype and every other
    leaf's value: a change to any of them is another program."""
    t = torch.zeros(2, 3)
    key = graphs.signature((t, {"augment": None, "flag": True}))[2]
    same = graphs.signature((torch.ones(2, 3), {"augment": None, "flag": True}))[2]
    assert key == same and hash(key) == hash(same)
    for other in ((t[:1], {"augment": None, "flag": True}),
                  (t.double(), {"augment": None, "flag": True}),
                  (t, {"augment": t, "flag": True}),
                  (t, {"augment": None, "flag": False}),
                  (t, {"flag": True, "augment": None})):
        assert graphs.signature(other)[2] != key


# ---- optimizer state written in place ------------------------------------------

class _Two(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.a = torch.nn.Parameter(torch.from_numpy(params["a"].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(params["b"].copy()))


def test_optimizer_state_stays_in_place(tmp_path):
    """Every state tensor keeps its storage across three steps (one of them
    not finite), `advance_lr_schedule` and a checkpoint restore, and the
    restored moments and counts equal optax's after those three steps."""
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (s * rng.randn(*v.shape)).astype(np.float32) for k, v in params.items()}
             for s in (0.3, 10.0, 1.0)]
    grads[1]["b"][1] = np.nan
    tx, _ = make_optimizer("Adam", lr=1.0, lr_scheduler="decay")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    model = _Two(params)
    opt = PO.Optimizer(model.parameters(), lr=1.0, lr_scheduler="decay")
    ptrs = [t.data_ptr() for t in opt.state_tensors()]
    assert len(set(ptrs)) == len(ptrs) == 7
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(g[k]) for k in ("a", "b")])
        assert [t.data_ptr() for t in opt.state_tensors()] == ptrs
    path = str(tmp_path / "opt.pth")
    save_checkpoint(path, params={}, state={}, opt_state=optimizer_tree(opt, model), step=3)
    PO.advance_lr_schedule(opt, 40)
    assert int(opt.schedule_count) == 40
    opt.step([torch.ones(3, 4), torch.ones(5)])
    assert [t.data_ptr() for t in opt.state_tensors()] == ptrs
    load_optimizer_tree(opt, model, load_checkpoint(path)["optimizer"])
    assert [t.data_ptr() for t in opt.state_tensors()] == ptrs
    adam = state.inner_state[1]
    assert int(opt.count) == int(adam.count) == 2
    assert int(opt.schedule_count) == int(state.inner_state[-1].count) == 2
    assert int(opt.total_notfinite) == int(state.total_notfinite) == 1
    assert bool(opt.last_finite) == bool(state.last_finite)
    for k, m, n in zip(("a", "b"), opt.views(opt.mu), opt.views(opt.nu)):
        np.testing.assert_allclose(m.numpy(), np.asarray(adam.mu[k]), rtol=0, atol=1e-7)
        np.testing.assert_allclose(n.numpy(), np.asarray(adam.nu[k]), rtol=0, atol=1e-7)


# ---- no host round trip inside a program's body --------------------------------

HOST_OPS = (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.lift_fresh.default)
KERNEL_MODULES = ("attention", "ctc", "features", "griffin_lim", "quantize", "rnn")


class _NoHostSync(TorchDispatchMode):
    """Raises on an op that reads a tensor's value to the host or makes a
    tensor from host data, outside an exempt function."""

    def __init__(self):
        super().__init__()
        self.exempt = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in HOST_OPS and not self.exempt:
            raise AssertionError(f"host round trip in a program body: {func}")
        return func(*args, **(kwargs or {}))


@pytest.fixture
def no_host_sync(monkeypatch):
    """The guard, with every kernel's plain version (``*_plain`` of
    `semi_tts_tpu_torch.kernels`) and the step's host-side input
    conversion (`graphs.to_device_scalars`) exempt."""
    import importlib

    guard = _NoHostSync()

    def exempt(fn):
        def run(*a, **kw):
            guard.exempt += 1
            try:
                return fn(*a, **kw)
            finally:
                guard.exempt -= 1
        return run

    for name in KERNEL_MODULES:
        mod = importlib.import_module(f"semi_tts_tpu_torch.kernels.{name}")
        for attr in [a for a in vars(mod) if a.endswith("_plain") and callable(getattr(mod, a))]:
            monkeypatch.setattr(mod, attr, exempt(getattr(mod, attr)))
    monkeypatch.setattr(graphs, "to_device_scalars", exempt(graphs.to_device_scalars))
    return guard


def test_guard_catches_host_round_trips():
    x = torch.ones(3)
    for bad in (lambda: x.sum().item(), lambda: float(x.sum()), lambda: bool(x.sum() > 0),
                lambda: torch.tensor([1.0, 2.0]), lambda: torch.as_tensor(2.0)):
        with pytest.raises(AssertionError, match="host round trip"), _NoHostSync():
            bad()


def test_serving_body_has_no_host_sync(solver, no_host_sync):
    srv = _server(solver, 2)
    text, sid = srv._place(*_requests())
    synth, vocode = srv.stages(4, *text.shape)
    full = srv._full_stage(4, *text.shape)
    vocode(synth(text, sid, seed=0))  # warm the cached tables
    full(text, sid, seed=0)
    with no_host_sync:
        amp = synth(text, sid, seed=1)
        wav = vocode(amp)
        full(text, sid, seed=1)
    assert torch.isfinite(wav).all()


@pytest.mark.parametrize("kind", ["paired", SPEECH_FIRST, TEXT_FIRST, "asr"])
def test_step_body_has_no_host_sync(solver, no_host_sync, kind):
    m = copy.deepcopy(solver.model)
    opt = PO.Optimizer(m.parameters(), lr=1e-3, lr_scheduler="decay")
    b = solver.builder
    steps = {"paired": b.make_paired_step, SPEECH_FIRST: b.make_speech_first_step,
             TEXT_FIRST: b.make_text_first_step}
    if kind == "asr":
        step, args = make_asr_step(b, opt), (m, 3) + tuple(solver.batch)
    else:
        step = steps[kind](opt)
        extra = () if kind == "paired" else tuple(solver.u_batch)
        args = (m, 2 if kind == SPEECH_FIRST else 3, 1.0) + tuple(solver.batch) + extra
    step(*args)  # warm the cached tables
    with no_host_sync:
        mets = step(*args)
    assert torch.isfinite(mets["grad_norm"])
