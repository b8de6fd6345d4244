#!/usr/bin/env python3
"""Where the time of K3 `attention_step`, K9 `attention_step_bwd`, K4
`gl_ola_frame`, K7 `bilstm_rec_bwd` and K8 `bigru_rec_bwd` goes, on one
NVIDIA card; and the paired or speech-first train step's time in a given
tree.

    python3 chip_ablate.py [--src TREE]
    python3 chip_ablate.py --paired-busy TREE
    python3 chip_ablate.py --speech-first-busy TREE
    python3 chip_ablate.py --kernel-mem TREE

The first builds copies of ``semi_tts_tpu_torch/csrc/attention.cu``,
``griffin_lim.cu`` and ``rnn.cu`` that stop after a phase (into the
kernels' build directory, under ``ablate/``), and times each copy at
`chip_smoke.py`'s shapes for that kernel (K9 at every shape a train step
gives it, `K9_SHAPES`), beside the whole kernel, as device time per call
from a replayed CUDA graph. A cut copy computes nothing useful: only its
time means anything, and the time of a phase is the difference between two
cuts. A one-shot kernel (K3, K4, K9) returns after the phase; a recurrence
(K7, K8) ends every step there, and its cuts also drop the waits on the
phases cut away, so that no step waits for data that never comes. Each
kernel has a cut list per design, and the copy takes the list whose every
marker is a line of the source: an edit that moves a marker fails loudly.
``--src TREE`` times the checkout at TREE the same way, with that tree's
sources, wrappers and `chip_smoke.py`, which times an earlier design beside
this one. Prints the card's name and power limit, then one JSON line
``{"ablation": ...}``.

The other two run the flagship paired step, or the speech-first step with
the flagship's unpaired weights (`chip_smoke.py`'s B=8 x 3.0 s batches;
K9 at L=133), of the checkout at TREE, with that tree's `chip_smoke.py`
and package: six steps (the median wall of the last five) and three
profiled steps, numbers 10 to 12 (device busy time and kernel launches),
and the peak device memory of the six.
To compare two trees, run it for each in one call, in the order parent,
change, change, parent. Prints one JSON line ``{"paired_busy": ...}`` or
``{"speech_first_busy": ...}``.

``--kernel-mem TREE`` reports the device memory that the checkout's
`chip_smoke.py` phases before serving leave allocated (`kernel_mem`).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch


def after(marker, text):
    """An edit that puts ``text`` after the line(s) ``marker``."""
    return marker, marker + text


def ret(marker):
    return after(marker, "  return;\n")


# K7: a cut that drops the wait on the slots drops their re-arming too, as
# no bytes complete the phase it armed
WAIT = ("    if (s > 0 && owned > 0 && tid < (RU + 31) / 32 * 32)\n"
        "      mbar_wait(bar0 + 8 * ((s - 1) & 1), ((s - 1) >> 1) & 1);\n")
REARM = "        if (tid == 0 && s + 1 <= T - 2) mbar_expect_tx(bar0 + 8 * buf, step_bytes);\n"
# K9 (PR 6): the end of a tile's wait for its processed memory, and of the tile loop
K9_PM_WAIT = ('    asm volatile("cp.async.wait_group 1;\\n" ::: "memory");  '
              "// this tile's processed memory\n    __syncthreads();\n")
K9_LOOP_END = ("      __syncthreads();  // the tile's buffers are free for the next\n    }\n  }\n"
               "  __syncthreads();\n")

# K9 (PR 8): the dispatch of the per-span kernel with loc_lin staged, made
# to read it from L2
K9_DISPATCH = tuple("".join(f"      case {P}: launch = launch_bwd<{P}, {stage}>; break;\n"
                            for P in range(4, 33, 4)) for stage in ("true", "false"))

# source -> [(kernel case in chip_smoke.py, {design: [(cut name, [(old, new), ...])]})]
CUTS = {
    "attention": [("attention_step", {"cluster per batch row (PR 3)": [
        ("launch", [ret("                      int vec) {\n"
                        "  cg::cluster_group cluster = cg::this_cluster();\n")]),
        ("prologue", [ret("  cluster_wait();\n")]),
        ("location features", [ret("    if (l0 == 0) asm volatile(\"cp.async.wait_group 0;\\n\" ::: "
                                   "\"memory\");  // pm and memory\n    __syncthreads();\n")]),
        ("energies and exchange",
         [ret("  cluster.sync();  // every partial has landed; no remote access after this\n")]),
    ]}), ("attention_step_bwd", {"a CTA a span of positions, fixed-order sums (PR 8)": [
        # each cut ends the per-span kernel after a phase; the sums kernel runs whole
        ("launch", [("  // prologue: what the whole CTA holds in one cp.async group, the span's\n",
                     "  return;\n  // prologue: what the whole CTA holds in one cp.async group, "
                     "the span's\n")]),
        ("prologue, s and dw", [ret('  asm volatile("cp.async.wait_group 1;\\n" ::: "memory");  '
                                    "// the held operands have landed\n  __syncthreads();\n")]),
        ("location features", [ret('  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");  '
                                   "// processed memory\n  __syncthreads();\n")]),
        ("tanh, dpre, d_pm, d_v, d_pq, d_loc_lin", [("  if (F == 0) return;\n", "  return;\n")]),
        ("d_loc", [("  // d_loc_w over the span,", "  return;\n  // d_loc_w over the span,")]),
        ("d_loc_w and the halo's products", [("  // the span's d_attn_hist over the window",
                                              "  return;\n  // the span's d_attn_hist over the window")]),
        # not cuts: the whole per-span kernel, the sums kernel returning at
        # once; and the whole kernel with the sums kernel launched plainly
        ("whole kernel, no sums", [after("  __shared__ float4 sums[kThreads];\n", "  return;\n")]),
        ("whole kernel, no programmatic launch",
         [("  attr[0].val.programmaticStreamSerializationAllowed = 1;\n",
           "  attr[0].val.programmaticStreamSerializationAllowed = 0;\n")]),
        # loc_lin read from L2 at every span, as at the widths where it does
        # not fit in shared memory
        ("whole kernel, loc_lin from L2", [K9_DISPATCH]),
        # and with float4 loads of loc_lin's rows (F a multiple of 4 here)
        ("whole kernel, loc_lin from L2 as float4s", [K9_DISPATCH, (
            "#pragma unroll\n        for (int j = 0; j < 4; ++j) lv[j] = f + j < F ? "
            "__ldg(loc_lin + (size_t)a * F + f + j) : 0.0f;\n",
            "        const float4 x = __ldg(reinterpret_cast<const float4*>(loc_lin + (size_t)a * F + f));\n"
            "        lv[0] = x.x, lv[1] = x.y, lv[2] = x.z, lv[3] = x.w;\n")]),
        # d_loc_lin's loop over filters unrolled by 4, which spills at spans
        # 20 and 24 (by 2 in the source, not at all at span 24)
        ("whole kernel, d_loc_lin unrolled by 4",
         [("#pragma unroll (P == 24 ? 1 : 2)\n", "#pragma unroll 4\n")]),
    ], "tiles in one cluster a row (PR 6)": [
        ("launch", [ret("                           int D, int C, int F, int K, int tile) {\n"
                        "  cg::cluster_group cluster = cg::this_cluster();\n")]),
        ("prologue", [ret("  cluster.sync();  // every CTA of the cluster has started: peers' "
                          "shared memory is live\n")]),
        ("dw pass", [ret("  for (int l = tid; l < L; l += blockDim.x) dw[l] = w[l] * (dw[l] - wdw);\n"
                         "  const float* de = dw;\n")]),
        # the tile loop ends after a phase; the kernel after the loop
        ("location features", [after(K9_PM_WAIT, "    continue;\n"), ret(K9_LOOP_END)]),
        ("tanh, dpre and d_pm", [after("      red[i] = dv;\n      red[GA + i] = dq;\n    }\n"
                                       "    __syncthreads();\n", "    continue;\n"),
                                 ret(K9_LOOP_END)]),
        ("d_loc_lin", [after("        *out = acc;\n      }\n", "      continue;\n"), ret(K9_LOOP_END)]),
        ("d_loc exchange", [ret(K9_LOOP_END)]),
        ("d_v, d_pq and d_loc_w", [("  // d_attn_hist a tile of positions at a time",
                                    "  return;\n  // d_attn_hist a tile of positions at a time")]),
    ]})],
    "griffin_lim": [("gl_ola_frame", {"tiled overlap-add (PR 3)": [
        ("overlap-add into shared memory",
         [ret("  ola_segment(fb, env, lo, hi - lo + 1, g, [&](int i, float v) { seg[i] = v; });\n"
              "  __syncthreads();\n")]),
    ]})],
    "rnn": [
        ("bilstm_rec_bwd", {
            "W_hh in registers, an mbarrier hand-off (PR 7)": [
                # the cp.async ring and the products formed before the wait
                ("inputs", [after(
                    "    fetch(s + kRing);  // into the slot just read\n",
                    "    if (tid < RU) dg_s[tid] = ca + cb + cc + cd + ce + f + gy;  // kept live\n"
                    "    continue;\n")]),
                ("phase A", [
                    (WAIT, ""),
                    (REARM, ""),
                    after("      for (int q = 0; q < 4; ++q) dgs[q * U] = dg[q];\n    }\n",
                          "    continue;\n")]),
                # the block barrier, the lanes' chains and the shuffle tree; every
                # lane stores its sums into the CTA's own slots
                ("partial sums", [
                    (WAIT, ""),
                    (REARM, ""),
                    ("            mbar_arrive(bar0 + 8 * buf);\n", ""),
                    ("            st_async<NV>(map_rank(smem_addr(dst), owner), acc, "
                     "map_rank(bar0 + 8 * buf, owner));\n",
                     "            dst[0] = acc[0] + acc[NV - 1];\n")]),
                # not a cut: the whole kernel with only the unit lanes waiting,
                # inside phase A's branch (it hangs at one row and 8 or 12
                # units a CTA; timed here at 2 rows and 32 units)
                ("whole kernel, unit lanes wait", [
                    (WAIT, ""),
                    ("        const int buf = (s - 1) & 1;\n        const float* sl",
                     "        const int buf = (s - 1) & 1;\n"
                     "        mbar_wait(bar0 + 8 * buf, ((s - 1) >> 1) & 1);\n        const float* sl")]),
            ],
            "cluster barrier a step (PR 4)": [
                # phase A alone: the gate gradients from the slots as they are
                ("inputs and phase A", [after(
                    "      for (int q = 0; q < 4; ++q) dg_s[r * U4 + q * U + u] = active ? dg[q] : 0.0f;\n"
                    "    }\n", "    cur = nxt;\n    continue;\n")]),
                # the partial sums stored into the CTA's own slots, a block barrier a step
                ("partial sums, no exchange", [
                    ("*cluster.map_shared_rank(dst + (size_t)rr * U, owner) = acc[rr];",
                     "dst[(size_t)rr * U] = acc[rr];"),
                    ("    cluster.sync();\n    cur = nxt;\n", "    __syncthreads();\n    cur = nxt;\n")]),
            ],
        }),
        ("bigru_rec_bwd", {
            "16-lane groups of 4 units (PR 7)": [
                ("dh2 and the products", [after(
                    "    if (active && role < 3) vs[role * KP + k] = cur.cf * dh2;\n",
                    "    cur = nx1;\n    nx1 = nx2;\n    continue;\n")]),
                ("and the hand-off", [after(
                    "    __syncthreads();  // vs is double-buffered: one barrier a step is race-free\n",
                    "    cur = nx1;\n    nx1 = nx2;\n    continue;\n")]),
                ("and the FMAs", [(
                    "    // reduce-scatter over lane offsets 8 and 4, then a butterfly over 2 and 1\n",
                    "    dh_rec = acc[0] + acc[1] + acc[2] + acc[3];\n"
                    "    cur = nx1;\n    nx1 = nx2;\n    continue;\n")]),
                # not cuts: the whole kernel with an mbarrier that each warp
                # arrives on in place of the barrier, and with its step loop
                # not unrolled
                ("whole kernel, mbarrier hand-off", [
                    after("  const int k4 = 4 * (threadIdx.x / kGruLanes);  // the group's first unit\n",
                          "  __shared__ unsigned long long bar;\n"
                          "  const unsigned bar_a = (unsigned)__cvta_generic_to_shared(&bar);\n"
                          "  if (threadIdx.x == 0) mbar_init(bar_a, blockDim.x / 32);\n"),
                    ("    __syncthreads();  // vs is double-buffered: one barrier a step is race-free\n",
                     "    __syncwarp();\n    if ((threadIdx.x & 31) == 0) mbar_arrive(bar_a);\n"
                     "    mbar_wait(bar_a, s & 1);\n")]),
                ("whole kernel, not unrolled", [("#pragma unroll 2\n  for (int s = 0; s < T; ++s) {",
                                                 "  for (int s = 0; s < T; ++s) {")]),
            ],
            "one leader lane a unit (PR 5)": [
                ("dh2 and the products", [(
                    "    __syncthreads();  // dhp is double-buffered: one barrier a step is race-free\n",
                    "    cur = nxt;\n    continue;\n")]),
                ("and the block barrier", [after(
                    "    __syncthreads();  // dhp is double-buffered: one barrier a step is race-free\n",
                    "    cur = nxt;\n    continue;\n")]),
            ],
        }),
    ],
}


def pick_design(text, src, name, designs):
    """The (design, cuts) of ``designs`` whose every edit finds its marker
    once in ``text``."""
    for design, cuts in designs.items():
        if all(text.count(old) == 1 for _, edits in cuts for old, _ in edits):
            return design, cuts
    raise SystemExit(f"chip_ablate: no cut list of {name} matches csrc/{src}.cu "
                     f"(designs: {list(designs)})")


# (B, L) of every K9 call in the train steps: the paired step (8, 32), the
# text-first step (16, 32), the speech-first step (16, 133), the 15.28 s
# speech-first step (2, 679; timed at 700) and the longest K3 takes (2, 1187)
K9_SHAPES = ((8, 32), (16, 32), (16, 133), (2, 700), (2, 1187))


def k9_calls(k9, dev):
    """{"B=.. L=..": one K9 call} at `K9_SHAPES` and flagship widths, from
    seeded inputs and K3's forward on them; works with a tree whose
    `attention_step_bwd` does not take the forward's context."""
    import inspect

    A, D, C, F_, K = 256, 512, 2, 32, 31
    g = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    lw, ll, v = randn(F_, C, K, scale=0.15), randn(A, F_, scale=0.15), randn(A, scale=0.05)
    takes_context = "context" in inspect.signature(k9.attention_step_bwd).parameters
    calls = {}
    for B_, L in K9_SHAPES:
        pq, pm, mem = randn(B_, A), randn(B_, L, A, scale=0.5), randn(B_, L, D)
        w = torch.softmax(randn(B_, L), -1)
        hist = torch.stack([w, w + torch.softmax(randn(B_, L), -1)], 1).contiguous()
        context, weights = k9.attention_step(pq, pm, mem, hist, lw, ll, v)
        args = (pq, pm, mem, hist, lw, ll, v, weights) + ((context,) if takes_context else ()) \
            + (randn(B_, D), randn(B_, L))
        calls[f"B={B_} L={L}"] = lambda a=args: k9.attention_step_bwd(*a)
    return calls


def k9_span_times(k9, calls, chip_smoke):
    """K9 at each of ``calls``' shapes with every span of `SPANS` in place of
    the plan's: {span: {shape: ms}}."""
    out = {}
    for P in k9.SPANS:
        with chip_smoke.k9_span(k9, P):
            out[P] = {n: chip_smoke.device_ms(f, 50) for n, f in calls.items()}
    return out


def enter_tree(tree):
    """Import `chip_smoke` and the package from the checkout at ``tree``."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    return tree


def main(src_tree=None):
    if src_tree is not None:
        src_tree = enter_tree(src_tree)
    import chip_smoke
    from semi_tts_tpu_torch import kernels, use_fp32
    from semi_tts_tpu_torch.kernels import attention as k9, build

    chip_smoke.phase_device()
    use_fp32()
    kernels.build_all()
    csrc = build.CSRC
    out_dir = build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, plans = {}, []
    for src, kernel_cuts in CUTS.items():
        text = open(os.path.join(csrc, f"{src}.cu")).read()
        copies = {f"{src}_whole": text}
        for name, designs in kernel_cuts:
            design, cuts = pick_design(text, src, name, designs)
            names = []
            for i, (cut, edits) in enumerate(cuts):
                cut_text = text
                for old, new in edits:
                    cut_text = cut_text.replace(old, new)
                copies[f"{src}_{name}_{i}"] = cut_text
                names.append((cut, f"{src}_{name}_{i}"))
            plans.append((src, name, design, names))
        for stem, cut_text in copies.items():
            cu = out_dir / f"{stem}.cu"
            cu.write_text(cut_text)
            procs[stem] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # K9's whole-kernel copies, whose registers and spills by span are reported
    k9_copies = {stem: cut for _, name, _, names in plans if name == "attention_step_bwd"
                 for cut, stem in names if cut.startswith("whole")}
    k9_copies["attention_whole"] = "whole"
    ptxas = {}
    for stem, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"chip_ablate: nvcc failed for {stem}:\n{log}")
        if stem in k9_copies:
            ptxas[k9_copies[stem]] = {k: [v.get("registers"), v.get("spill_bytes")]
                                      for k, v in chip_smoke.ptxas_report(log).items()
                                      if k.startswith("attention_bwd_kernel<")}
    dev = torch.device("cuda")
    cases = {c["name"]: c for c in chip_smoke.kernel_cases(dev)}
    cases["attention_step_bwd"]["by_shape"] = k9_calls(k9, dev)

    def timed(src, stem, case):
        build._libs[src] = ctypes.CDLL(str(out_dir / f"{stem}.so"))
        build.bind.cache_clear()
        if "by_shape" in case:
            return {n: chip_smoke.device_ms(f, 50) for n, f in case["by_shape"].items()}
        return chip_smoke.device_ms(case["kernel"], case["iters"])

    result = {}
    with torch.no_grad():
        if hasattr(k9, "SPANS"):
            result["attention_step_bwd by span"] = k9_span_times(
                k9, cases["attention_step_bwd"]["by_shape"], chip_smoke)
        for src, name, design, names in plans:
            case, mine = cases[name], build.load(src)
            times = {"whole": timed(src, f"{src}_whole", case)}
            for cut, stem in names:
                times[cut if cut.startswith("whole") else "to " + cut] = timed(src, stem, case)
            times["whole again"] = timed(src, f"{src}_whole", case)
            build._libs[src] = mine
            build.bind.cache_clear()
            result[name] = {"design": design, "shapes": case["shapes"], "steps": case.get("steps"),
                            "ms": times}
    print(json.dumps({"ablation": result, "src": str(csrc), "ptxas": ptxas}))


def step_busy(tree, kind):
    """The flagship ``kind`` step ("paired" or "speech_first") of the
    checkout at ``tree``: six steps, then steps 10 to 12 profiled."""
    import time

    tree = enter_tree(tree)
    import chip_smoke as cs
    import numpy as np
    from semi_tts_tpu_torch import kernels, use_fp32
    from semi_tts_tpu_torch.models import vqvae as V
    from semi_tts_tpu_torch.ops.features import AudioFeaturizer
    from semi_tts_tpu_torch.train.optim import Optimizer
    from semi_tts_tpu_torch.train.steps import StepBuilder, Weights
    from semi_tts_tpu_torch.utils.metrics import read_phn_attr

    cs.phase_device()
    use_fp32()
    kernels.build_all()
    dev = torch.device("cuda")
    config = cs.flagship_config()
    cfg = cs.flagship_vqvae_config(config)
    phn_attr = torch.from_numpy(read_phn_attr(config["model"]["codebook"]["phn_attr_pth"])).to(dev)
    model = V.VQVAE(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    opt = Optimizer(model.parameters(), lr=1e-3, lr_scheduler="decay")
    batch = cs.training_batch(0, dev)
    if kind == "paired":
        builder = StepBuilder(cfg, AudioFeaturizer(cs.audio_config(), dev), phn_attr,
                              freq_loss_kwargs=cs.FLAGSHIP_FREQ_LOSS)
        step, rest = builder.make_paired_step(opt), ()
    else:
        builder = StepBuilder(cfg, AudioFeaturizer(cs.audio_config(), dev), phn_attr,
                              weights=Weights(**cs.CYCLE_WEIGHTS),
                              freq_loss_kwargs=cs.FLAGSHIP_FREQ_LOSS)
        step, rest = builder.make_speech_first_step(opt), cs.training_batch(2, dev)
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, i, 1.0, *batch, *rest)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls[1:]))
    prof = [cs.profiled_step(lambda k=k: step(model, 10 + k, 1.0, *batch, *rest), wall,
                             picked=("attention_bwd",)) for k in range(3)]
    print(json.dumps({f"{kind}_busy": {
        "tree": tree, "cudnn_deterministic": torch.backends.cudnn.deterministic, "wall_s": wall,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "walls_s": walls, "busy_s": [p["device_busy_s"] for p in prof],
        "launches": [p["kernel_launches"] for p in prof],
        "k9_ms": [p["picked_ms"]["attention_bwd"] for p in prof]}}))


def kernel_mem(tree):
    """The device memory that `chip_smoke.py`'s phases before serving (the
    kernels line, the ASR shape and featurizer lines) leave allocated, in the
    checkout at ``tree``: after each timed call of the kernels line, after
    each phase, after a garbage collection and after cuBLAS's per-stream
    workspaces are freed."""
    import gc

    tree = enter_tree(tree)
    import chip_smoke as cs
    from semi_tts_tpu_torch import kernels, use_fp32

    cs.phase_device()
    use_fp32()
    kernels.build_all()
    dev = torch.device("cuda")
    mem = torch.cuda.memory_allocated
    timed, device_ms = [], cs.device_ms

    def recorded(fn, *args, **kwargs):
        out = device_ms(fn, *args, **kwargs)
        timed.append(mem())
        return out

    cs.device_ms = recorded
    table = cs.phase_kernels(dev)
    after = {"start": 0, "kernels line": mem()}
    cs.asr_lstm_check(dev)
    after["asr_shape line"] = mem()
    cs.featurizer_line(dev)
    after["featurizer line"] = mem()
    gc.collect()
    after["gc"] = mem()
    torch._C._cuda_clearCublasWorkspaces()
    after["cuBLAS workspaces freed"] = mem()
    # the growth at each timed call of the kernels line, by the kernel timed
    names = [r["name"] for r in table]
    print(json.dumps({"kernel_mem": {"tree": tree, "allocated_after": after,
                                     "kernels": names, "after_each_timed_call": timed}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--kernel-mem"]:
        sys.exit(kernel_mem(sys.argv[2]))
    if sys.argv[1:2] == ["--paired-busy"]:
        sys.exit(step_busy(sys.argv[2], "paired"))
    if sys.argv[1:2] == ["--speech-first-busy"]:
        sys.exit(step_busy(sys.argv[2], "speech_first"))
    if sys.argv[1:2] == ["--src"]:
        sys.exit(main(sys.argv[2]))
    sys.exit(main())
