"""Compiled programs of the port: CUDA graphs behind the callables that the
server and the trainers call (counterpart of `jax.jit`'s per-shape cache and
of `semi_tts_tpu/serve.py`'s `_Once` and bounded program LRU).

The JAX package runs every hot path as compiled programs: the serving
stages of each decode bucket and each train step, "ONE fused jit program"
with the step number and teacher-forcing rate traced. On the card the
counterpart of such a program is a CUDA graph: the launches of one call,
captured once per input shape and replayed with one host call.

- `ProgramCache`: an LRU of `_Once` build cells, exactly the JAX server's
  (`_cached_program`, `_evict_completed_locked`): only completed cells are
  evicted and no lock is held across a build. The server's is bounded, a
  step's is not.
- `Graphed`: one function at one set of input shapes. Its first call
  copies the inputs into static buffers and runs the function eagerly on a
  side stream: that run is the call's own (its outputs are returned, its
  changes to the parameters, statistics and optimizer state kept), and it
  makes lazy tables, library handles and workspaces outside the graph. It
  then captures the function under `torch.cuda.graph` with its generator
  registered; a capture launches nothing, and the generator is put back
  where the eager run left it. Every later call copies the inputs in,
  reseeds the generator, replays and returns clones of the outputs, so
  that an output outlives the next replay. So every call, the capturing
  one included, runs the function's work once, and a collective inside it
  is issued once a call whichever calls capture: ranks that capture their
  own shapes at different steps still pair their collectives step by
  step. The first replay is followed by a synchronise, since a launch that
  fails inside a graph shows only at replay. A failed capture or replay
  raises; nothing falls back to running eagerly.
- `Eager`: the same call without a graph. On a CPU device the cache holds
  these, as JAX's cache holds a jitted callable on any backend, so the CPU
  tests drive the same cache; on the card it is the yardstick a graph is
  held to (`StepProgram.eager`).
- `StepProgram`: a train step behind an unbounded `ProgramCache` (as
  `jax.jit` keeps a program for every shape it saw), keyed by the model
  and every input's shape and dtype; ``step_no`` and every Python number
  among the inputs (``tf_rate``, a stretch rate) become device scalars fed
  on each call, as JAX traces them, and the generator is reseeded from
  (seed, step_no). A shape is captured at its ``capture_at``-th call (the
  second by default) and runs eagerly before that: a corpus's long tail of
  batch shapes seen once costs an eager step each, not a capture
  (`data/step_shapes.py` counts the shapes of a partition table).
- `NoGradProgram`: a function run without autograd (the eval step,
  Griffin-Lim, the featurizer, an LM's dev loss) under the same cache
  policy, with no optimizer and no state; its keyword arguments are static
  (part of the key, passed as they are) and its generator is reseeded from
  the seed a caller gives, or goes on drawing without one.

While a gloo process group is initialised (`parallel.mesh`), the programs
of `StepProgram` and `NoGradProgram` stay `Eager` on the card too
(`capturable`): their functions may run collectives, and a CUDA graph
captures NCCL's, not gloo's, which run on the host. A server's stages run
no collective (`serve.py` gathers a split request's outputs outside them)
and stay graphs under any group.

Graphs of one owner (a server, a step builder, a solver) share one memory
pool and one capture stream: they never replay at once, and since every
input is copied into a buffer allocated outside the pool and every output
is cloned out of it, nothing in the pool lives from one replay to the next.
An owner also keeps a byte budget over the programs of `StepProgram` and
`NoGradProgram`: each capture records what it cost the card (`GraphOwner`),
and once the next capture would pass the budget a new shape runs eagerly on
every call (``over_budget_calls``). Nothing is evicted, so nothing is
captured twice.

A kernel wrapper's launch counter (`kernels.launch_counts`) moves where the
wrapper launches its kernel: on an eager call, and once at a capture. A
replay launches the whole graph with one host call and moves no counter;
what a replay ran is read from a profile.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from collections import Counter, OrderedDict

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree


class _Once:
    """Build-once cell: the first ``result()`` runs the build, concurrent
    callers for the SAME key wait on this cell's lock (not the cache's lock,
    so other keys keep serving), later callers get the memoized value. A
    failed build leaves the cell retryable."""

    def __init__(self, build):
        self._build = build
        self._lock = threading.Lock()
        self._value = None
        self._done = False

    def result(self):
        with self._lock:
            if not self._done:
                self._value = self._build()
                self._done = True
                self._build = None
            return self._value


class ProgramCache:
    """Bounded LRU over built programs, keyed by any hashable key.

    Thread-safe: dict bookkeeping (hit/move/insert/evict) happens under the
    cache lock; the build runs under the entry's own `_Once` lock, so a slow
    build never blocks hits on other keys. Only COMPLETED cells are
    eviction victims: evicting a mid-build cell would let a re-request of
    the same key start a duplicate build. So the bound holds at rest, and
    during concurrent builds the dict may transiently hold ``size``
    completed cells plus one mid-build cell per distinct key in flight.
    Eviction drops the cache's reference only: a program already handed to
    a caller stays valid. ``size=None``: no bound (a step's cache, as
    `jax.jit`'s)."""

    def __init__(self, size: int | None = 8):
        self.size = None if size is None else max(1, int(size))  # None: unbounded
        self._programs: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, build):
        with self._lock:
            entry = self._programs.get(key)
            if entry is None:
                entry = _Once(build)
                self._programs[key] = entry
            else:
                self._programs.move_to_end(key)
            self._evict_completed_locked()
        value = entry.result()
        with self._lock:  # this build may have pushed the at-rest count over
            self._evict_completed_locked()
        return value

    def _evict_completed_locked(self):
        """Drop oldest COMPLETED cells until within bound (caller holds
        ``self._lock``). ``_done`` is read without the cell's own lock: a
        stale False only postpones eviction to the post-build trim."""
        if self.size is None:
            return
        excess = len(self._programs) - self.size
        if excess > 0:
            for k in [k for k, v in self._programs.items() if v._done][:excess]:
                del self._programs[k]


# ---- pytrees of tensors -----------------------------------------------------

def signature(tree):
    """(leaves, spec, key) of ``tree`` (tuples, lists and dicts are walked):
    the key holds the structure, every tensor leaf's shape and dtype and
    every other leaf itself."""
    leaves, spec = pytree.tree_flatten(tree)
    key = (str(spec), tuple((tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else t
                            for t in leaves))
    return leaves, spec, key


def to_device_scalars(tree, device):
    """``tree`` with every Python float a float32 and every int an int64 0-d
    tensor on ``device`` (bools and None stay)."""
    def scalar(x):
        if isinstance(x, float):
            return torch.tensor(x, dtype=torch.float32, device=device)
        if isinstance(x, int) and not isinstance(x, bool):
            return torch.tensor(x, dtype=torch.int64, device=device)
        return x
    return pytree.tree_map(scalar, tree)


# ---- programs ---------------------------------------------------------------

BUDGET_SHARE = 0.25  # of the card's memory that an owner's graphs may hold (PERF.md §5)


class GraphOwner:
    """What the graphs of one owner share on the card: a memory pool, the
    side stream that warms them up and captures them, and a byte budget.

    ``budget_bytes``: what the owner's captured programs may cost the card
    in all; by default `BUDGET_SHARE` of the card's memory, and no bound on
    the CPU, where the programs are `Eager` and cost nothing. ``meter()``
    -> (bytes of the owner's memory pool, bytes the allocator reserves,
    bytes in use on the device), read around each capture (by default the
    allocator's segments of the pool, `torch.cuda.memory_reserved` and
    `torch.cuda.mem_get_info`; none on the CPU). ``graph_bytes``: for each
    capture, its ``pool`` bytes (the growth of the owner's pool) and
    ``outside`` bytes (the device's growth beyond what the allocator
    reserves: the graph's executable, library workspaces; a capture first
    empties the allocator's cache, which the difference takes out).
    ``over_budget_calls``: calls that ran eagerly because a capture would
    have passed the budget; ``notify`` gets one line when that first
    happens."""

    def __init__(self, device, budget_bytes=None, *, meter=None, notify=print):
        self.device = torch.device(device)
        self.graph_bytes = []
        self.over_budget_calls = 0
        self.notify = notify
        self.meter = meter
        self.budget_bytes = budget_bytes
        if self.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
            with torch.cuda.device(self.device):
                self.stream = torch.cuda.Stream()
            if budget_bytes is None:
                self.budget_bytes = int(BUDGET_SHARE * torch.cuda.mem_get_info(self.device)[1])
            if meter is None:
                self.meter = self._card_bytes

    def _card_bytes(self):
        torch.cuda.synchronize(self.device)
        free, total = torch.cuda.mem_get_info(self.device)
        pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self.pool))
        return pool, torch.cuda.memory_reserved(self.device), total - free

    def spent(self) -> int:
        """What the captures so far cost, in bytes."""
        return sum(b["pool"] + b["outside"] for b in self.graph_bytes)

    def admit(self) -> bool:
        """Whether one more capture stays within the budget, taking it to
        cost the mean of the captures so far (the first capture grows the
        shared pool to a step's working set; later ones mostly reuse it)."""
        if self.budget_bytes is None or not self.graph_bytes:
            return True
        spent = self.spent()
        return spent + spent / len(self.graph_bytes) <= self.budget_bytes

    def refuse(self):
        """Counts a call that runs eagerly past the budget."""
        if not self.over_budget_calls:
            self.notify(f"graphs: {len(self.graph_bytes)} captured, {self.spent() / 1e9:.3f} of "
                        f"a {self.budget_bytes / 1e9:.3f} GB budget; new shapes run eagerly")
        self.over_budget_calls += 1

    @contextlib.contextmanager
    def metered(self):
        """Records in ``graph_bytes`` what the work inside cost the device."""
        if self.meter is None:
            yield
            return
        pool0, reserved0, used0 = self.meter()
        yield
        pool1, reserved1, used1 = self.meter()
        self.graph_bytes.append({"pool": max(pool1 - pool0, 0),
                                 "outside": max((used1 - used0) - (reserved1 - reserved0), 0)})


class Eager:
    """``fn(*args)`` with ``generator`` reseeded to ``seed`` first (when
    both are given): the program a CPU cache holds, and a graph's
    yardstick on the card."""

    def __init__(self, fn, generator=None):
        self.fn = fn
        self.generator = generator

    def __call__(self, *args, seed=None):
        if seed is not None and self.generator is not None:
            self.generator.manual_seed(int(seed))
        return self.fn(*args)


class Graphed:
    """``fn`` as one CUDA graph, captured at its first call's input shapes
    (see the module's docstring). ``generator``: the generator ``fn`` draws
    from, registered with the graph. Attributes after the first call:
    ``capture_s`` (the eager run and the capture, seconds),
    ``host_launches`` (input copies + replay + output clones a call). The
    card's part is in `_side`, `_record` and `_replay`. Not thread-safe:
    its owner runs one call at a time (the server's run lock, a trainer's
    loop)."""

    def __init__(self, fn, owner: GraphOwner, *, generator=None):
        self.fn = fn
        self.owner = owner
        self.generator = generator
        self.graph = None
        self.capture_s = None
        self.host_launches = None
        self._checked = False

    def _inputs(self):
        """The captured call's arguments: its static buffers in the tensor
        leaves' places."""
        static = iter(self._static)
        return pytree.tree_unflatten([next(static) if isinstance(t, torch.Tensor) else t
                                      for t in self._in_leaves], self._in_spec)

    @contextlib.contextmanager
    def _side(self):
        """Work inside runs on the owner's capture stream, after the
        caller's work so far and before the caller's next."""
        stream = self.owner.stream
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            yield
        torch.cuda.current_stream().wait_stream(stream)

    def _record(self):
        """Captures ``fn`` on the static inputs into ``self.graph`` (a
        capture launches nothing); returns its outputs, which every replay
        rewrites."""
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        # a dead program's graph destroyed by the garbage collector during a
        # capture would invalidate it: collect before, none during
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.owner.pool, stream=self.owner.stream):
                out = self.fn(*self._inputs())
        finally:
            gc.enable()
        self.graph = graph
        return out

    def _replay(self):
        self.graph.replay()
        if not self._checked:  # a launch that fails inside a graph raises here
            torch.cuda.synchronize()
            self._checked = True

    def _capture(self, args, seed):
        """The first call: ``fn`` run eagerly (the call's result), then
        captured."""
        t0 = time.perf_counter()
        self._in_leaves, self._in_spec, self._in_key = signature(args)
        self._static = [t.detach().clone() for t in self._in_leaves if isinstance(t, torch.Tensor)]
        if self.generator is not None and seed is not None:
            self.generator.manual_seed(int(seed))
        with self._side():
            out = self.fn(*self._inputs())
        out = pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, out)
        # the capture must not move the generator from where this call left it
        gen_state = None if self.generator is None else self.generator.get_state()
        self._out, self._out_spec = pytree.tree_flatten(self._record())
        if gen_state is not None:
            self.generator.set_state(gen_state)
        self.capture_s = time.perf_counter() - t0
        self.host_launches = (len(self._static) + 1
                              + sum(isinstance(t, torch.Tensor) for t in self._out))
        return out

    def __call__(self, *args, seed=None):
        if self.graph is None:
            return self._capture(args, seed)
        leaves, _, key = signature(args)
        if key != self._in_key:
            raise ValueError(f"a graph captured at {self._in_key} called with {key}")
        for s, t in zip(self._static, (t for t in leaves if isinstance(t, torch.Tensor))):
            s.copy_(t)
        if seed is not None and self.generator is not None:
            self.generator.manual_seed(int(seed))
        self._replay()
        return pytree.tree_unflatten([t.clone() if isinstance(t, torch.Tensor) else t
                                      for t in self._out], self._out_spec)


def program(fn, device, owner, *, generator=None):
    """`Graphed` on the card (``owner``: its `GraphOwner`), `Eager` on the
    CPU."""
    if torch.device(device).type == "cuda":
        return Graphed(fn, owner, generator=generator)
    return Eager(fn, generator)


def capturable() -> bool:
    """Whether a CUDA graph can capture this process's collectives: no
    process group, or an NCCL one (gloo's collectives run on the host)."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_backend() == "nccl"


def step_seed(seed: int, step_no: int) -> int:
    """A 64-bit mix of (seed, step_no): the seed of one step's generator."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(step_no) * 0xBF58476D1CE4E5B9) % (1 << 63)


class _Programs:
    """The cache policy of `StepProgram` and `NoGradProgram`: an unbounded
    `ProgramCache` of programs by key; a key runs eagerly until its
    ``capture_at``-th call, which builds its program (on the card:
    captures its graph) if the owner's budget admits it, else runs eagerly,
    as every later call of that key does; one generator, made on the first
    call's device and registered with every graph. ``owner``: a callable
    giving the `GraphOwner` of a device (None: one of the program's own).
    Every program is `Eager` while a gloo group is initialised
    (`capturable`)."""

    def __init__(self, owner=None):
        self.owner = owner or self._own_owner
        self._owner = None
        self.cache = ProgramCache(None)
        self.capture_at = 2
        self.calls = Counter()
        self.generator = None

    def _own_owner(self, device):
        if self._owner is None:
            self._owner = GraphOwner(device)
        return self._owner

    def _generator(self, device):
        if self.generator is None:
            self.generator = torch.Generator(device=device)
        return self.generator

    def _call(self, key, dev, fn, inputs, seed, keep=None):
        """``fn(*inputs)`` through the program of ``key`` (``keep``: an
        object the program holds, so that an id in the key is not reused)."""
        self.calls[key] += 1
        eager = Eager(fn, self.generator)
        if self.calls[key] < self.capture_at:
            return eager(*inputs, seed=seed)
        with self.cache._lock:
            cell = self.cache._programs.get(key)
        if cell is not None:
            return self.cache.get(key, None)(*inputs, seed=seed)
        owner = self.owner(dev)
        graphs = capturable()
        if graphs and not owner.admit():
            owner.refuse()
            return eager(*inputs, seed=seed)

        def build():
            prog = program(fn, dev, owner, generator=self.generator) if graphs else eager
            prog.keep = keep
            return prog

        # on the card: the call's eager run and the capture
        with owner.metered() if graphs else contextlib.nullcontext():
            return self.cache.get(key, build)(*inputs, seed=seed)

    def programs(self):
        """The cached programs, oldest first."""
        with self.cache._lock:
            return [cell._value for cell in self.cache._programs.values() if cell._done]


class StepProgram(_Programs):
    """A train step ``step(model, step_no, *args, **kw)`` behind an
    unbounded `ProgramCache` of programs, one for each model and set of
    input shapes and dtypes (which keyword inputs are given included). A
    set of shapes runs eagerly until its ``capture_at``-th call, which
    builds its program (on the card: captures its graph, within the owner's
    budget). ``body(model, step_no, *args, generator, **kw)`` is the step;
    it updates the model and ``optimizer`` in place and returns its metrics.
    ``step_no`` reaches it as an int64 device scalar and every Python number
    of ``args``/``kw`` as a device scalar (`to_device_scalars`); its
    generator is reseeded from `step_seed` (seed, step_no) on each call.
    ``owner``: a callable giving the `GraphOwner` of a device, shared by
    the steps of one trainer. ``eager(...)``: the same step run eagerly,
    with the same inputs and seeding."""

    def __init__(self, body, optimizer, seed: int, owner):
        super().__init__(owner)
        self.body = body
        self.optimizer = optimizer
        self.seed = seed

    def _inputs(self, model, step_no, args, kw):
        dev = next(model.parameters()).device
        self._generator(dev)
        inputs = to_device_scalars((step_no, args, kw), dev)
        return dev, inputs, step_seed(self.seed, step_no)

    def _fn(self, model):
        def run(step_no, args, kw):
            return self.body(model, step_no, *args, generator=self.generator, **kw)
        return run

    def __call__(self, model, step_no, *args, **kw):
        dev, inputs, seed = self._inputs(model, step_no, args, kw)
        return self._call((id(model), signature(inputs[1:])[2]), dev, self._fn(model), inputs,
                          seed, keep=model)

    def eager(self, model, step_no, *args, **kw):
        _, inputs, seed = self._inputs(model, step_no, args, kw)
        return Eager(self._fn(model), self.generator)(*inputs, seed=seed)


class NoGradProgram(_Programs):
    """``body(*args, generator, **static)`` run without autograd behind the
    cache policy of `StepProgram`, keyed by ``args``' shapes and dtypes
    (a module among them by its identity) and ``static``'s values. Python
    numbers of ``args`` reach ``body`` as device scalars, ``static`` as it
    is. ``prog(*args, seed=None, **static)``: ``seed`` reseeds the
    generator; without one the draws go on from where the last call left
    it. ``eager(...)``: the same call without a graph."""

    def __init__(self, body, owner=None):
        super().__init__(owner)
        self.body = body

    def _fn(self, static):
        @torch.no_grad()
        def run(*args):
            return self.body(*args, generator=self.generator, **static)
        return run

    def _inputs(self, args):
        dev = next(t.device for t in pytree.tree_leaves(args) if isinstance(t, torch.Tensor))
        self._generator(dev)
        return dev, to_device_scalars(args, dev)

    def __call__(self, *args, seed=None, **static):
        dev, inputs = self._inputs(args)
        key = (signature(inputs)[2], tuple(sorted(static.items())))
        return self._call(key, dev, self._fn(static), inputs, seed)

    def eager(self, *args, seed=None, **static):
        _, inputs = self._inputs(args)
        return Eager(self._fn(static), self.generator)(*inputs, seed=seed)
