"""The mesh of ranks, the batch split and the collectives of the port's
parallelism (counterpart of `semi_tts_tpu/parallel/mesh.py`).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with a
``data`` axis (the batch split) and a ``model`` axis (the wide weights
split) and lets XLA insert the collectives. The port runs one process a
rank over `torch.distributed`: rank ``d * M + m`` sits at data coordinate
``d`` and model coordinate ``m``, as JAX reshapes its devices to ``(n //
M, M)``. It makes its collectives itself, in a few places:

- the optimizer (`train/optim.py`) all-reduces the flat gradient over the
  data group once a step and averages it; the ranks of a model group each
  keep and update their rows of a leaf that `parallel.sharding` places
  over ``model``, then all-gather the leaf;
- within `split_rows` (this rank holds its rows of a batch split over the
  data axis) BatchNorm's batch statistics are summed over the data group
  (`sync_moments`), and a random draw with a batch axis is made at the
  global batch's shape, of which the rank takes its rows (`draw_rows`):
  every rank's generator then stays where one process's would be;
- the steps' metrics and the outputs of evaluation and serving
  (`mean_over`, `all_gather_rows`, `gather_rows`).

On the card the collectives run over NCCL, which a CUDA graph captures;
over gloo, which a graph cannot capture, the train and evaluation programs
run eagerly (`graphs.capturable`). Gloo's CUDA support covers
``all_reduce`` and ``broadcast``, so a gather is an all-reduce into a
zeroed buffer there.

Several processes: call `init_distributed` before the first device query.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

TIMEOUT_S = 300  # every process group's: a lost rank fails a collective instead of hanging it
DEFAULT_COORDINATOR = "localhost:12321"


def init_distributed(coordinator=None, num_processes=None, process_id=None, *,
                     cpu=False) -> bool:
    """Joins this process to its world (a no-op for a single process).

    With no arguments the environment decides, as the JAX package's
    ``init_distributed`` reads it: ``SEMI_TTS_NUM_PROCESSES``,
    ``SEMI_TTS_PROCESS_ID`` and ``SEMI_TTS_COORDINATOR`` (host:port of rank
    0); ``SEMI_TTS_NUM_PROCESSES=auto``, or none of them under ``torchrun``,
    reads ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT``.
    The backend is NCCL on the card, gloo with ``cpu``; the group's
    timeout is `TIMEOUT_S`. On the card the rank is pinned to ``cuda:LOCAL_RANK`` (the
    process id without ``LOCAL_RANK``), modulo the cards present, before
    the group is made. Returns True when the process is part of a world of
    more than one process, or of one a caller made before."""
    if dist.is_initialized():
        return True
    env_n = os.environ.get("SEMI_TTS_NUM_PROCESSES", "")
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    init_method = None
    if num_processes is None and (env_n.lower() == "auto" or (not env_n and torchrun)):
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    elif num_processes is None and env_n:
        num_processes = int(env_n)
        process_id = int(os.environ.get("SEMI_TTS_PROCESS_ID", "0"))
        coordinator = os.environ.get("SEMI_TTS_COORDINATOR", DEFAULT_COORDINATOR)
    if not num_processes or num_processes <= 1:
        return False
    process_id = int(process_id or 0)
    backend = "gloo" if cpu else "nccl"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass cpu=True (the CLI's --cpu)")
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or f"tcp://{coordinator or DEFAULT_COORDINATOR}",
                            world_size=int(num_processes), rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def world():
    """(rank, world size) of this process: (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


class Mesh:
    """A ``(data, model)`` grid over the ranks of the world.

    ``shape``: ``{"data": D, "model": M}`` (JAX's ``mesh.shape``);
    ``rank``; ``data_rank``, ``model_rank``: this rank's coordinates;
    ``data_group``: the ranks of this rank's model coordinate (the batch is
    split over them, the gradient reduced over them); ``model_group``: the
    ranks of its data coordinate (a sharded leaf is split over them). Both
    are None in a world of one process without a process group, where every
    collective is the identity. ``backend``: the groups' backend."""

    def __init__(self, n_data: int, n_model: int = 1, *, rank: int = 0, data_group=None,
                 model_group=None, backend=None):
        self.shape = {"data": int(n_data), "model": int(n_model)}
        self.rank = int(rank)
        self.data_rank, self.model_rank = divmod(self.rank, self.shape["model"])
        self.data_group, self.model_group = data_group, model_group
        self.backend = backend

    @property
    def is_first(self) -> bool:
        """Rank 0: the one that writes logs and checkpoints."""
        return self.rank == 0

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}, rank={self.rank}, "
                f"backend={self.backend})")


def _device(backend):
    """Where a collective's scratch lives: the current card under NCCL."""
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices=None, *, model_parallel: int = 1) -> Mesh:
    """The ``(data, model)`` mesh over the ranks of the initialised world,
    ``model_parallel`` ranks to a model group. ``n_devices`` must be the
    world size (the whole world by default). Every rank makes every
    subgroup, in one order, and runs one collective on its own two, so that
    an NCCL communicator exists before a graph captures its first
    collective. Raises ValueError when the world is not ``n_devices`` or
    ``model_parallel`` does not divide it."""
    rank, n_world = world()
    n = int(n_devices or n_world)
    M = int(model_parallel)
    if M < 1 or n % M:
        raise ValueError(f"make_mesh: model_parallel={M} does not divide {n} ranks")
    if n != n_world:
        raise ValueError(f"make_mesh: a mesh of {n} ranks in a world of {n_world}")
    D = n // M
    if not dist.is_initialized():
        return Mesh(D, M)
    data_group = model_group = None
    for m in range(M):
        g = dist.new_group([d * M + m for d in range(D)],
                           timeout=datetime.timedelta(seconds=TIMEOUT_S))
        if rank % M == m:
            data_group = g
    for d in range(D):
        g = dist.new_group([d * M + m for m in range(M)],
                           timeout=datetime.timedelta(seconds=TIMEOUT_S))
        if rank // M == d:
            model_group = g
    backend = dist.get_backend()
    mesh = Mesh(D, M, rank=rank, data_group=data_group, model_group=model_group,
                backend=backend)
    probe = torch.zeros(1, device=_device(backend))
    for g in (data_group, model_group):
        dist.all_reduce(probe, group=g)
    if probe.device.type == "cuda":
        torch.cuda.synchronize()
    return mesh


def mesh_shape(spec: str):
    """(D, M) of a ``--mesh DxM`` string. Raises SystemExit with the JAX
    solver's messages for a malformed spec or a world of another size."""
    try:
        d, m = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh must look like 4x2 (data x model), got {spec!r}")
    n = d * m
    _, have = world()
    if n > have:
        raise SystemExit(f"--mesh {spec} needs {n} devices, only {have} visible (start {n} "
                         "processes: torchrun --nproc-per-node N, or SEMI_TTS_NUM_PROCESSES)")
    if n < have:
        raise SystemExit(f"--mesh {spec} covers {n} of the {have} processes of this world")
    return d, m


def mesh_from_spec(spec: str) -> Mesh | None:
    """The mesh of a ``--mesh DxM`` string over the initialised world
    (`mesh_shape`'s checks first); None for an empty one."""
    if not spec:
        return None
    d, m = mesh_shape(spec)
    return make_mesh(d * m, model_parallel=m)


# ---- collectives ------------------------------------------------------------

def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(t, group, op=dist.ReduceOp.SUM):
    """``t`` reduced in place over ``group`` (nothing without one)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def mean_over(t, group):
    """The mean of ``t`` over ``group``'s ranks (a new tensor)."""
    n = group_size(group)
    if n == 1:
        return t
    return all_reduce_(t.clone(), group) / n


def _as_reducible(t):
    """Bools go through the collectives as uint8."""
    return (t.to(torch.uint8), torch.bool) if t.dtype == torch.bool else (t, None)


def all_gather_rows(t, group):
    """Every rank's ``t`` (rows first, the same shape on each) stacked along
    the rows in the group's rank order: (b, ...) -> (n * b, ...)."""
    n = group_size(group)
    if n == 1:
        return t
    t, back = _as_reducible(t.contiguous())
    b = t.shape[0]
    if dist.get_backend(group) == "nccl":
        out = t.new_empty((n * b,) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=group)
    else:
        out = t.new_zeros((n * b,) + tuple(t.shape[1:]))
        i = dist.get_rank(group)
        out[i * b:(i + 1) * b] = t
        dist.all_reduce(out, group=group)
    return out if back is None else out.to(back)


def gather_rows(t, group):
    """`all_gather_rows` of tensors whose shapes may differ between ranks
    (batches of a sharded loader): each is zero-padded to the largest shape
    first. The shapes are exchanged through the host."""
    if group_size(group) == 1:
        return t
    dev = t.device if dist.get_backend(group) == "nccl" else torch.device("cpu")
    shape = torch.tensor(t.shape, dtype=torch.int64, device=dev)
    dist.all_reduce(shape, op=dist.ReduceOp.MAX, group=group)
    pad = []
    for have, want in zip(reversed(t.shape), reversed(shape.tolist())):
        pad += [0, want - have]
    if any(pad):
        t = torch.nn.functional.pad(t.to(torch.float64) if t.dtype == torch.bool else t,
                                    pad).to(t.dtype)
    return all_gather_rows(t, group)


class _SumOver(torch.autograd.Function):
    """The sum over a group's ranks; its gradient is the sum of theirs."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def sync_moments(mean, var, n: int, group):
    """The batch mean and biased variance over every rank of ``group``
    from each rank's ``mean``, ``var`` (over its ``n`` rows and frames):
    two all-reduces that autograd differentiates, the second of the
    deviations from the global mean. Returns (mean, var, count), the count
    a 0-d tensor."""
    cnt = mean.new_full((1,), float(n))
    s1 = _SumOver.apply(torch.cat([mean * n, cnt]), group)
    N = s1[-1]
    mean_g = s1[:-1] / N
    s2 = _SumOver.apply(n * (var + (mean - mean_g) ** 2), group)
    return mean_g, s2 / N, N


# ---- this rank's rows -------------------------------------------------------

_rows = threading.local()


@contextlib.contextmanager
def split_rows(mesh: Mesh | None, *segments: int):
    """Within: this rank's batch is its rows of a batch split over the data
    axis, made of ``segments`` (each segment's row count on this rank, in
    the order a step concatenates them: the paired rows, then the unpaired
    ones). BatchNorm then syncs its statistics over the data group and
    `draw_rows` draws at the global batch's shape. Nothing changes when
    the data axis is 1 or ``mesh`` is None."""
    if mesh is None or mesh.shape["data"] == 1:
        yield
        return
    prev = getattr(_rows, "value", None)
    _rows.value = (mesh, tuple(int(s) for s in segments))
    try:
        yield
    finally:
        _rows.value = prev


def batch_group():
    """The data group BatchNorm syncs over within `split_rows`, else None."""
    value = getattr(_rows, "value", None)
    return None if value is None else value[0].data_group


def draw_rows(draw, shape):
    """``draw(shape)`` (a random tensor of ``shape``, rows first) as one
    process draws it for the whole batch, of which this rank takes its
    rows: within `split_rows` a draw of ``n`` rows (one segment, or all of
    them) is made at ``D`` times the rows, segment by segment in the global
    batch's order. Outside, ``draw(shape)``."""
    value = getattr(_rows, "value", None)
    if value is None or len(shape) == 0:
        return draw(shape)
    mesh, segments = value
    D, d = mesh.shape["data"], mesh.data_rank
    n = shape[0]
    if n == sum(segments):
        parts = segments
    elif n in segments:
        parts = (n,)
    else:
        raise ValueError(f"draw_rows: a draw of {n} rows in a batch of segments {segments}")
    full = draw((D * n,) + tuple(shape[1:]))
    out, at = [], 0
    for s in parts:
        out.append(full[at + d * s: at + (d + 1) * s])
        at += D * s
    return out[0] if len(out) == 1 else torch.cat(out)


# ---- placing batches and parameters -----------------------------------------

def shard_batch(batch_tree, mesh: Mesh):
    """This rank's rows ``[d*b:(d+1)*b]`` of every array or tensor leaf with
    a leading axis that the data axis divides; a leaf whose rows it does
    not divide (a ragged tail batch) stays whole, as JAX replicates it. A
    dict subclass (the loader's ``Batch``) keeps its type."""
    D, d = mesh.shape["data"], mesh.data_rank

    def take(x):
        if not (isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 1):
            return x
        if x.shape[0] % D:
            return x
        b = x.shape[0] // D
        return x[d * b:(d + 1) * b]

    if isinstance(batch_tree, dict) and type(batch_tree) is not dict:
        return type(batch_tree)({k: pytree.tree_map(take, v) for k, v in batch_tree.items()})
    return pytree.tree_map(take, batch_tree)


def replicate(tensors, mesh: Mesh | None = None):
    """Rank 0's values of ``tensors`` (an iterable of tensors, written in
    place) on every rank of the world: one broadcast of them packed flat.
    Returns them as a list."""
    tensors = list(tensors)
    if not dist.is_initialized() or dist.get_world_size() == 1 or not tensors:
        return tensors
    backend = dist.get_backend()
    dev = tensors[0].device if backend == "nccl" else _device(backend)
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1).to(dev, torch.float32) for t in tensors])
        dist.broadcast(flat, src=0)
        at = 0
        for t in tensors:
            t.copy_(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()
    return tensors


def shard_params(model, mesh: Mesh, specs=None):
    """Every rank's parameters and buffers made rank 0's (`replicate`), then
    the placement of each parameter by `parallel.sharding`'s specs (pass
    ``specs``, a ``{name: spec}`` dict, for another model): ``{name:
    spec}`` with `sharding.place_params`' divisibility fallback, in
    ``model.named_parameters()`` order, for the optimizer's ``specs=``."""
    from .sharding import place_params

    replicate(list(model.parameters()) + [b for b in model.buffers() if b.is_floating_point()],
              mesh)
    return place_params(model, mesh, specs)
