"""What every cell of the benchmark shares: the manifest and the files it
names, the card's checks and record, weights and inputs made from the seed
on the device, the benchmark's own spans, the recorder of the hand-written
kernels' calls, the profiler's trace and its reduction, the FLOP count of
the plain reference, and the check that no JAX module was loaded.

Everything here reads only files under this folder and ``BENCHMARK.json``;
of the program it imports only ``semi_tts_tpu_torch``, and only where a
traffic module asks for it."""

from __future__ import annotations

import contextlib
import glob
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "semi_tts_tpu")
FP32_FLOP_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # H100 SXM
CACHE = os.path.join(ROOT, ".port_bench_cache")
WINDOW = "port_bench.window"  # the profiler range of a traced window


# ---------------- the manifest and its files ----------------

def read_json(path):
    with open(path) as f:
        return json.load(f)


def manifest():
    return read_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_of(name, bench=None):
    """The manifest's entry of cell ``name`` merged with its parameter file
    ``workloads/<name>.json``."""
    bench = bench or manifest()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"port_bench: no cell {name!r} in BENCHMARK.json")
    return {**read_json(os.path.join(HERE, "workloads", name + ".json")), **entry}


def config_of(name, bench=None):
    bench = bench or manifest()
    entry = next(c for c in (bench or manifest())["configs"] if c["name"] == name)
    return read_json(os.path.join(ROOT, entry["file"]))


def metrics_of(cell_name, bench, section):
    """The metrics of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those that list it, and those with no list whose moved
    end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_module(kind):
    return load_module(os.path.join(HERE, "traffic", kind + ".py"), "port_bench_traffic_" + kind)


def reader(metric):
    path = os.path.join(HERE, "metrics", metric + ".py")
    return load_module(path, "port_bench_metric_" + metric.replace(".", "_")) if os.path.exists(path) else None


def cost_modules():
    """{wrapper name: module} of ``costs/<wrapper>.py``: ``KERNELS`` (a
    pattern of the trace's kernel names) and ``cost(args) -> (flops,
    bytes)`` of one call's arguments."""
    return {os.path.basename(p)[:-3]: load_module(p, "port_bench_cost_" + os.path.basename(p)[:-3])
            for p in sorted(glob.glob(os.path.join(HERE, "costs", "*.py")))}


# ---------------- the card ----------------

def set_cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(CACHE, sub))
    os.environ["USE_FLAX"] = "0"


def card_check(chips):
    """Exit without a result unless the machine holds ``chips`` cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: this cell needs {chips} CUDA card(s); found {n}", file=sys.stderr)
        raise SystemExit(3)


def card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def device_record(device, chips):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def forbidden_modules():
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------- seeds, weights and inputs ----------------

def mix(seed, stream):
    """A 63-bit seed of (run seed, stream name)."""
    h = 1469598103934665603
    for ch in f"{int(seed)}/{stream}":
        h = ((h ^ ord(ch)) * 1099511628211) % (1 << 64)
    return h % (1 << 63)


def generator(seed, stream, device):
    return torch.Generator(device=device).manual_seed(mix(seed, stream))


UNIT_TABLES = ("spkr_embed", "codebook.learnable_table", "codebook.embedding")


def make_weights(shapes, buffers, seed, device):
    """Weights of every parameter ``shapes`` {name: shape} (in the model's
    order) and BatchNorm running statistics ``buffers`` {name: shape}, from
    one uniform draw on the device: tables of unit variance; BatchNorm
    scales in [0.8, 1.2] and shifts in [-0.1, 0.1]; any other matrix
    U(+-1/sqrt(fan_in)), and a vector as the matrix before it; running
    means in [-0.1, 0.1] and variances in [0.5, 1.5]."""
    names = list(shapes) + list(buffers)
    sizes = [math.prod(s) for s in list(shapes.values()) + list(buffers.values())]
    if device.type == "meta":  # shapes only, for a FLOP count
        u = torch.empty(sum(sizes), device=device)
    else:
        u = torch.rand(sum(sizes), generator=generator(seed, "weights", device), device=device) * 2 - 1
    P, S, bound, at = {}, {}, 1.0, 0
    for name, size in zip(names, sizes):
        x = u[at:at + size]
        at += size
        if name in shapes:
            shape = tuple(shapes[name])
            if name in UNIT_TABLES:
                v = x * math.sqrt(3.0)
            elif re.search(r"\bbn\.\d+\.scale$|\.bn\.scale$", name):
                v = 1.0 + 0.2 * x
            elif re.search(r"\bbn\.\d+\.bias$|\.bn\.bias$", name):
                v = 0.1 * x
            else:
                if len(shape) >= 2:
                    bound = 1.0 / math.sqrt(math.prod(shape[1:]))
                v = bound * x
            P[name] = v.reshape(shape)
        else:
            v = 0.1 * x if name.endswith(".mean") else 1.0 + 0.5 * x
            S[name] = v.reshape(tuple(buffers[name]))
    return P, S


def model_shapes(model):
    """{name: shape} of a module's parameters and of its running means and
    variances."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    bufs = {n: tuple(b.shape) for n, b in model.named_buffers() if n.endswith((".mean", ".var"))}
    return shapes, bufs


@torch.no_grad()
def load_weights(model, P, S):
    for n, p in model.named_parameters():
        p.copy_(P[n])
    for n, b in model.named_buffers():
        if n in S:
            b.copy_(S[n])


def waves(lengths, S, g, sr, device):
    """Speech-like rows (B, S) on the device: three amplitude-modulated
    partials of a random pitch and a little noise, zero past each row's
    length."""
    B = len(lengths)
    r = torch.rand((B, 6), generator=g, device=device)
    f0 = 90 + 160 * r[:, :1]
    am = 2 + 4 * r[:, 1:2]
    t = torch.arange(S, device=device, dtype=torch.float32)[None, :] / sr
    env = 0.5 + 0.5 * torch.sin(2 * math.pi * am * t)
    sig = sum(torch.sin(2 * math.pi * f0 * k * t + 6 * r[:, 2 + k:3 + k]) / k for k in (1, 2, 3))
    sig = 0.3 * env * sig + 0.02 * torch.randn((B, S), generator=g, device=device)
    lens = torch.as_tensor(lengths, device=device)
    return torch.where(torch.arange(S, device=device)[None, :] < lens[:, None], sig, 0.0)


def tokens_of(duration_s, sr, hop, ratio=6.0):
    """Tokens of a text spoken in ``duration_s``: ``ratio`` mel frames a
    token (the decode budget's rate)."""
    return int(math.ceil(duration_s * sr / hop / ratio))


def texts(n_tokens, pad, vocab, g, device, first=3):
    """Random phoneme ids in [first, vocab), each row ``n_tokens[i]`` long,
    zero-padded to ``pad``."""
    B = len(n_tokens)
    ids = first + (torch.rand((B, pad), generator=g, device=device) * (vocab - first)).long()
    ids = ids.clamp(max=vocab - 1)
    n = torch.as_tensor(n_tokens, device=device)
    return torch.where(torch.arange(pad, device=device)[None, :] < n[:, None], ids, 0).to(torch.int32)


# ---------------- the benchmark's spans ----------------

class Spans:
    """Host spans (name, start, end) in seconds of ``time.perf_counter``;
    under a profiler each is also a ``record_function`` range."""

    def __init__(self):
        self.items = []
        self.traced = False

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        rf = torch.profiler.record_function(name) if self.traced else contextlib.nullcontext()
        with rf:
            yield
        self.items.append((name, t0, time.perf_counter()))


# ---------------- the hand-written kernels' calls ----------------

class CallRecorder:
    """Records the calls of the program's kernel wrappers named by the cost
    files (the outermost of nested ones, none made while a CUDA graph is
    being captured) with the costs of their arguments: ``calls`` is a list
    of (wrapper, flops, bytes)."""

    def __init__(self, costs):
        self.costs = costs
        self.calls = []
        self._depth = 0
        self._frames = set()

    def _hook(self, frame, event, arg):
        code = frame.f_code
        if code.co_name not in self.costs or "semi_tts_tpu_torch" not in code.co_filename \
                or os.sep + "kernels" + os.sep not in code.co_filename:
            return
        if event == "call":
            if self._depth == 0 and not (torch.cuda.is_available()
                                         and torch.cuda.is_current_stream_capturing()):
                flops, nbytes = self.costs[code.co_name].cost(dict(frame.f_locals))
                self.calls.append((code.co_name, float(flops), float(nbytes)))
            self._depth += 1
            self._frames.add(id(frame))
        elif event == "return" and id(frame) in self._frames:
            self._frames.discard(id(frame))
            self._depth -= 1

    @contextlib.contextmanager
    def recording(self):
        self.calls = []
        sys.setprofile(self._hook)
        try:
            yield self
        finally:
            sys.setprofile(None)


def least_s(flops, nbytes):
    return max(flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


# ---------------- the trace ----------------

class Trace:
    """The reduction of one profiler window: device operations (kernels,
    copies, sets) as (name, start_s, dur_s, correlation), the CUDA runtime
    calls and the benchmark's spans as (name, start_s, end_s, correlation),
    all on the host's clock in seconds from the window's start."""

    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        win = next(e for e in events if e.name() == WINDOW)
        t0_ns = win.start_ns()
        self.window_s = win.duration_ns() / 1e9
        self.device, self.runtime, self.cpu = [], [], []
        for e in events:
            start = (e.start_ns() - t0_ns) / 1e9
            dur = e.duration_ns() / 1e9
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if _annotation(e):  # a host range mirrored on the device's timeline
                    continue
                corr = e.linked_correlation_id() or e.correlation_id()
                self.device.append((name, start, dur, corr))
            elif name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
                self.runtime.append((name, start, start + dur, e.correlation_id()))
            else:
                self.cpu.append((name, start, start + dur))
        self.device.sort(key=lambda x: x[1])
        self.cpu.sort(key=lambda x: x[1])

    def busy_s(self):
        """The union of the device operations' intervals inside the window."""
        busy, end = 0.0, -1e30
        for _, s, d, _ in self.device:
            s, e = max(s, 0.0), min(s + d, self.window_s)
            if e <= s:
                continue
            if s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def spans(self, prefix):
        return [x for x in self.cpu if x[0].startswith(prefix)]

    def graph_device_s(self, span):
        """Device seconds of the operations that the CUDA graph launches made
        inside a host span issued, by correlation id: a list, one entry a
        launch, in order (empty where the trace links none)."""
        _, s, e = span[:3]
        launches = [r for r in self.runtime if r[0].startswith("cudaGraphLaunch") and s <= r[1] <= e]
        if not hasattr(self, "_by_corr"):
            self._by_corr = {}
            for _, _, d, c in self.device:
                self._by_corr[c] = self._by_corr.get(c, 0.0) + d
        return [self._by_corr[r[3]] for r in launches if r[3] in self._by_corr]

    def breakdown(self, top=10):
        """The device operations that took most time, and the longest idle
        gaps by the innermost host range open at their middle."""
        by_name = {}
        for n, _, d, _ in self.device:
            by_name[n] = by_name.get(n, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], 0.0
        for _, s, d, _ in self.device:
            if s > end:
                gaps.append((s - end, end, s))
            end = max(end, s + d)
        if self.window_s > end:
            gaps.append((self.window_s - end, end, self.window_s))
        gaps = sorted(gaps, reverse=True)[:top]
        named = []
        for length, a, b in gaps:
            mid = (a + b) / 2
            host = [c for c in self.cpu if c[1] <= mid <= c[2]] + \
                   [r[:3] for r in self.runtime if r[1] <= mid <= r[2]]
            label = max(host, key=lambda c: c[1])[0] if host else "host: no range open"
            named.append([label, length])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


def _annotation(e):
    kind = str(getattr(e, "activity_type", lambda: "")())
    return (e.name().startswith("port_bench.") or "annotation" in kind.lower()
            or bool(getattr(e, "is_user_annotation", lambda: False)()))


@contextlib.contextmanager
def profiled(device):
    """A profiler over a window that starts and ends with the device idle;
    yields a dict that holds the `Trace` once the window closes."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    sync(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out["host_t0"] = time.perf_counter()
            yield out
            sync(device)
    out["trace"] = Trace(prof)


def program_kernels():
    """The names of the program's own CUDA kernels, from its sources."""
    names = set()
    for path in glob.glob(os.path.join(ROOT, "semi_tts_tpu_torch", "csrc", "*.cu")):
        with open(path) as f:
            src = f.read()
        for m in re.finditer(r"__global__\s+void\s+", src):
            i = m.end()
            if src.startswith("__launch_bounds__", i):  # skip its balanced parentheses
                depth, i = 0, src.index("(", i)
                while True:
                    depth += {"(": 1, ")": -1}.get(src[i], 0)
                    i += 1
                    if depth == 0:
                        break
            name = re.match(r"\s*(\w+)", src[i:])
            if name:
                names.add(name.group(1))
    return names


def kernel_time(trace, costs):
    """(seconds of the hand-written kernels that some cost file names, the
    program's kernels the trace shows that none names)."""
    pats = [re.compile(m.KERNELS) for m in costs.values()]
    own = program_kernels()
    total, unnamed = 0.0, set()
    for n, _, d, _ in trace.device:
        if any(p.search(n) for p in pats):
            total += d
        else:
            base = re.split(r"[<(]", n.replace("void ", "", 1).strip(), 1)[0].split("::")[-1]
            if base in own:
                unnamed.add(n)
    return total, sorted(unnamed)


# ---------------- the FLOP count ----------------

def count_flops(fn):
    """The FLOPs of the products and convolutions ``fn()`` runs (on the
    ``meta`` device), as ``torch.utils.flop_counter`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def percentile(values, p):
    """The ``p``-th percentile by the nearest rank."""
    v = sorted(values)
    k = max(1, int(math.ceil(p / 100 * len(v))))
    return v[k - 1]


# ---------------- what the per-layer readers share ----------------

def named_spans(trace, prefix):
    """[(suffix, start, end)] of the benchmark's spans named ``prefix`` +
    suffix in the traced window."""
    return [(n[len(prefix):], s, e) for n, s, e in trace.spans(prefix)]


def median_launch_ms(trace, prefix, index=None):
    """The median over the spans named ``prefix``... of the device ms of
    their CUDA graph launches: launch ``index`` of each span, or all of a
    span's launches together. None where the trace links no launch."""
    vals = []
    for span in named_spans(trace, prefix):
        got = trace.graph_device_s((prefix + span[0],) + span[1:])
        if index is None and got:
            vals.append(sum(got))
        elif index is not None and len(got) > index:
            vals.append(got[index])
    return statistics.median(vals) * 1e3 if vals else None


def mfu(ctx, prefix):
    """The FLOPs of the window's spans (``ctx.data["flops"]`` by span
    suffix) over the window at the fp32 peak, in %."""
    tr, flops = ctx.data["trace"], ctx.data["flops"]
    total = sum(flops[s] for s, _, _ in named_spans(tr, prefix))
    return 100.0 * total / tr.window_s / FP32_FLOP_PER_S if total else None


def kernel_roofline(ctx, prefix):
    """The least time of the hand-written kernels' calls of the window's
    spans over those kernels' device time, in %."""
    tr, calls = ctx.data["trace"], ctx.data["calls"]
    spans = named_spans(tr, prefix)
    if not spans or any(s not in calls for s, _, _ in spans):
        return None
    least = sum(least_s(f, b) for s, _, _ in spans for _, f, b in calls[s])
    busy, unnamed = kernel_time(tr, ctx.costs)
    if unnamed:
        print(f"port_bench: kernels of the program with no cost file: {unnamed}", flush=True)
    return 100.0 * least / busy if busy > 0 else None


def idle_share(ctx):
    tr = ctx.data["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
