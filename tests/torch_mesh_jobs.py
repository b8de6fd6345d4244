"""What the ranks of `tests/test_torch_parallel.py` run: `run_world` spawns
a gloo world of processes over a `FileStore` and joins it with a deadline
that kills every rank still running and fails; each ``job_*`` runs in
every rank and returns numpy results to the test. Nothing here imports JAX,
so a rank starts in a few seconds."""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

DEADLINE_S = 120


def _rank(rank, n, store, job, args, out):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=60))
        result = ("ok", job(*args))
    except Exception as e:  # handed to the test, which fails with it
        result = ("error", f"rank {rank}: {type(e).__name__}: {e}\n{traceback.format_exc()}")
    with open(out, "wb") as f:
        pickle.dump(result, f)
    if dist.is_initialized():
        dist.destroy_process_group()
    os._exit(0 if result[0] == "ok" else 1)


def run_world(n, job, tmpdir, *args, deadline=DEADLINE_S):
    """``job(*args)`` in each of ``n`` spawned ranks of a gloo world; returns
    the ranks' results in rank order. Raises AssertionError when a rank
    fails or the world outlives ``deadline`` seconds (its ranks killed)."""
    tmpdir = str(tmpdir)
    os.makedirs(tmpdir, exist_ok=True)
    store = os.path.join(tmpdir, f"store-{time.monotonic_ns()}")
    outs = [os.path.join(tmpdir, f"rank{r}-{os.path.basename(store)}.pkl") for r in range(n)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, n, store, job, args, outs[r]), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if alive:
        raise AssertionError(f"ranks {alive} of {n} still running after {deadline} s: killed")
    results = []
    for r in range(n):
        if not os.path.exists(outs[r]):
            raise AssertionError(f"rank {r} died (exit code {procs[r].exitcode}) with no result")
        with open(outs[r], "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise AssertionError(value)
        results.append(value)
    return results


# ---- jobs -------------------------------------------------------------------

def _model(case):
    from semi_tts_tpu_torch import bridge
    from semi_tts_tpu_torch.models import vqvae as PV

    model = PV.VQVAE(case["pcfg"], generator=torch.Generator().manual_seed(1))
    return bridge.load_jax_params(model, case["params"], case["state"])


def _rows(mesh, *arrays):
    from semi_tts_tpu_torch.parallel.mesh import shard_batch

    return shard_batch(tuple(torch.from_numpy(np.asarray(a)) for a in arrays), mesh)


def _augment_rows(mesh, aug):
    snrs, rate, noise = aug
    s, n = _rows(mesh, snrs, noise)
    return s, float(rate), n


def job_step(case, kind, model_parallel):
    """Runs ``case["steps"]`` of ``kind`` ("paired" or "speech") on the
    ``(world // model_parallel) x model_parallel`` mesh from ``case``'s
    weights, each on this rank's rows; returns per step the 0-d metrics, the
    reduced gradient (one array a parameter), and after the step the
    parameters and BN statistics and Adam's moments gathered whole."""
    from semi_tts_tpu_torch import bridge
    from semi_tts_tpu_torch.ops.features import AudioConfig, AudioFeaturizer
    from semi_tts_tpu_torch.parallel.mesh import make_mesh, shard_params
    from semi_tts_tpu_torch.train import optim as PO
    from semi_tts_tpu_torch.train.steps import StepBuilder, Weights

    class Recording(PO.Optimizer):
        def reduce(self, g):
            g = super().reduce(g)
            self.g = g.clone()
            return g

    mesh = make_mesh(model_parallel=model_parallel)
    model = _model(case)
    placement = shard_params(model, mesh)
    opt = Recording(model.parameters(), lr=1e-3, lr_scheduler="decay", mesh=mesh,
                    specs=list(placement.values()))
    builder = StepBuilder(case["pcfg"], AudioFeaturizer(AudioConfig(**case["audio"]), device="cpu"),
                          torch.from_numpy(case["phn_attr"]), weights=Weights(**case["weights"]),
                          freq_loss_kwargs=case["floss"], mesh=mesh)
    step = (builder.make_paired_step if kind == "paired" else builder.make_speech_first_step)(opt)
    out = []
    for s in case["steps"]:
        kw = dict(augment=_augment_rows(mesh, s["augment"]))
        args = _rows(mesh, *s["pair"])
        if kind == "speech":
            args += _rows(mesh, *s["unpair"])
            kw["u_augment"] = _augment_rows(mesh, s["u_augment"])
        mets = step(model, s["step_no"], 1.0, *args, **kw)
        params, state = bridge.to_jax_params(model)
        out.append(dict(
            mets={k: float(v) for k, v in mets.items() if v.ndim == 0},
            grads=[g.numpy().copy() for g in opt.full_views(opt.g)],
            params=params, state=state,
            moments={n: opt.full_moment(n).numpy().copy() for n in opt.moment_names},
            own=sum(opt.sizes), placement=placement))
    return out


def job_capture(case, shapes):
    """The paired step on the 2x1 mesh, captured at a shape's second call
    with `graphs.Graphed` on the host (a stand-in for the card's graph: its
    capture runs nothing, as a capture on the card launches nothing, and a
    replay runs the step on the static inputs), this rank fed its batch in
    the sequence ``shapes[rank]`` of two shapes ("A": the case's first
    paired batch, "B": its waves 441 samples shorter), so that the ranks
    capture at different steps. Returns per step the all-reduces this rank
    issued and whether it captured, and the parameters after the steps."""
    import contextlib

    from torch.utils import _pytree as pytree

    from semi_tts_tpu_torch import graphs

    class HostGraphed(graphs.Graphed):
        captures = 0

        def _side(self):
            return contextlib.nullcontext()

        def _record(self):
            HostGraphed.captures += 1
            self.graph = "recorded"

        def _replay(self):
            self._out, self._out_spec = pytree.tree_flatten(self.fn(*self._inputs()))

    saved = graphs.capturable, graphs.program, dist.all_reduce
    issued = [0]

    def counted(*a, **k):
        issued[0] += 1
        return saved[2](*a, **k)

    graphs.capturable = lambda: True
    graphs.program = lambda fn, device, owner, *, generator=None: HostGraphed(
        fn, owner, generator=generator)
    dist.all_reduce = counted
    try:
        return _capture_steps(case, shapes, issued, HostGraphed)
    finally:
        graphs.capturable, graphs.program, dist.all_reduce = saved


def _capture_steps(case, shapes, issued, graphed):
    from semi_tts_tpu_torch.ops.features import AudioConfig, AudioFeaturizer
    from semi_tts_tpu_torch.parallel.mesh import make_mesh
    from semi_tts_tpu_torch.train import optim as PO
    from semi_tts_tpu_torch.train.steps import StepBuilder, Weights

    mesh = make_mesh()
    model = _model(case)
    opt = PO.Optimizer(model.parameters(), lr=1e-3, lr_scheduler="decay", mesh=mesh)
    builder = StepBuilder(case["pcfg"], AudioFeaturizer(AudioConfig(**case["audio"]), device="cpu"),
                          torch.from_numpy(case["phn_attr"]), weights=Weights(**case["weights"]),
                          freq_loss_kwargs=case["floss"], mesh=mesh)
    step = builder.make_paired_step(opt)
    waves, wave_len, text, sid = _rows(mesh, *case["steps"][0]["pair"])
    short = waves.shape[1] - 441
    batch = {"A": (waves, wave_len, text, sid),
             "B": (waves[:, :short].contiguous(), wave_len.clamp(max=short), text, sid)}
    out = []
    for i, shape in enumerate(shapes[mesh.rank]):
        issued[0], captured = 0, graphed.captures
        step(model, i + 1, 1.0, *batch[shape])
        out.append((issued[0], graphed.captures - captured))
    return dict(steps=out, params=[p.detach().numpy().copy() for p in model.parameters()])


def job_batchnorm(x):
    """`models.common.batchnorm` in train mode on this rank's rows of ``x``
    within `split_rows` over a 2x1 mesh: the output, the running statistics
    and the gradient of ``sum(out * w)`` with respect to the rows."""
    from semi_tts_tpu_torch.models.common import BatchNorm, batchnorm
    from semi_tts_tpu_torch.parallel.mesh import make_mesh, shard_batch, split_rows

    mesh = make_mesh()
    bn = BatchNorm(x.shape[-1])
    rows = shard_batch(torch.from_numpy(x), mesh).clone().requires_grad_(True)
    w = shard_batch(torch.linspace(-1.0, 1.0, x.size).reshape(x.shape), mesh)
    with split_rows(mesh, rows.shape[0]):
        y = batchnorm(bn, rows, train=True)
    (y * w).sum().backward()
    return dict(y=y.detach().numpy(), grad=rows.grad.numpy(), mean=bn.mean.numpy(),
                var=bn.var.numpy())


def job_servers(case):
    """`TTSServer(mesh=)` of ``case``'s model on the 2x1 and the 1x2 mesh of a
    world of 2: ``synthesize`` and ``synthesize_full`` of each request."""
    from semi_tts_tpu_torch.models import vqvae as PV
    from semi_tts_tpu_torch.ops.features import AudioConfig
    from semi_tts_tpu_torch.parallel.mesh import make_mesh
    from semi_tts_tpu_torch.serve import TTSServer

    out = {}
    for m in (1, 2):
        mesh = make_mesh(model_parallel=m)
        model = PV.VQVAE(case["pcfg"], generator=torch.Generator().manual_seed(case["seed"]))
        server = TTSServer(case["pcfg"], AudioConfig(**case["audio"]), case["phn_attr"], model,
                           device="cpu", mesh=mesh)
        for name, (text, sid) in case["requests"].items():
            wav = server.synthesize(text, sid, key=11, decode_steps=case["decode_steps"])
            full = server.synthesize_full(text, sid, key=12, decode_steps=case["decode_steps"])
            out[f"{2 // m}x{m}/{name}"] = dict(wav=wav, full_wav=full["wav"], mel=full["mel"],
                                               align=full["align"])
    return out


def job_cli(argv, bad_argv):
    """``python -m semi_tts_tpu_torch`` on this rank (`__main__.main`) with
    ``argv``, recording the train loaders' item batches (num_shards,
    shard_id, file ids) and the checkpoints this rank writes; then
    ``bad_argv``, whose exit code and error text are returned."""
    import contextlib
    import io
    from os.path import basename

    from semi_tts_tpu_torch import __main__ as cli
    from semi_tts_tpu_torch.data.loader import TTSLoader
    from semi_tts_tpu_torch.train import solver

    batches, saved = [], []
    sharded, save = TTSLoader._sharded_batches, solver.save_checkpoint

    def record_batches(self):
        for items in sharded(self):
            batches.append((self.num_shards, self.shard_id,
                            [basename(str(p)).split(".")[0] for p, _ in items]))
            yield items

    def record_save(path, **kw):
        saved.append(basename(path))
        return save(path, **kw)

    TTSLoader._sharded_batches, solver.save_checkpoint = record_batches, record_save
    try:
        code = cli.main(argv)
    finally:
        TTSLoader._sharded_batches, solver.save_checkpoint = sharded, save
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            bad = cli.main(bad_argv)
        except SystemExit as e:
            bad = e.code
    return dict(code=code, batches=batches, saved=saved, bad_code=bad, bad_err=err.getvalue())


def job_world2(cases):
    """Everything `tests/test_torch_parallel.py` runs in a world of 2, in
    one world: each ``(name, job, args)`` of ``cases``."""
    return {name: globals()[job](*args) for name, job, args in cases}


def job_world4(case):
    """The mesh shapes of a world of 4, the errors of a wrong size, then
    `job_step` of ``case`` on the 2x2 mesh."""
    from semi_tts_tpu_torch.parallel.mesh import make_mesh, mesh_shape

    shapes = {}
    for m in (2, 1):
        mesh = make_mesh(4, model_parallel=m)
        shapes[m] = (dict(mesh.shape), mesh.data_rank, mesh.model_rank,
                     sorted(_members(mesh.data_group)), sorted(_members(mesh.model_group)))
    errors = []
    for call in (lambda: make_mesh(8), lambda: make_mesh(model_parallel=3)):
        try:
            call()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    try:
        mesh_shape("4x2")
    except SystemExit as e:
        errors.append(str(e))
    return dict(shapes=shapes, errors=errors, step=job_step(case, "speech", 2))


def _members(group):
    return [dist.get_global_rank(group, i) for i in range(dist.get_world_size(group))]
