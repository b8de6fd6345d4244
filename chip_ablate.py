#!/usr/bin/env python3
"""Where the time of K3 `attention_step`, K4 `gl_ola_frame`, K7
`bilstm_rec_bwd` and K8 `bigru_rec_bwd` goes, on one NVIDIA card; and the
paired train step's time in a given tree.

    python3 chip_ablate.py [--src TREE]
    python3 chip_ablate.py --paired-busy TREE

The first builds copies of ``semi_tts_tpu_torch/csrc/attention.cu``,
``griffin_lim.cu`` and ``rnn.cu`` that stop after a phase (into the
kernels' build directory, under ``ablate/``), and times each copy at
`chip_smoke.py`'s shapes for that kernel, beside the whole kernel, as
device time per call from a replayed CUDA graph. A cut copy computes
nothing useful: only its time means anything, and the time of a phase is
the difference between two cuts. A one-shot kernel (K3, K4) returns after
the phase; a recurrence (K7, K8) ends every step there, and its cuts also
drop the waits on the phases cut away, so that no step waits for data that
never comes. Each kernel has a cut list per design, and the copy takes the
list whose every marker is a line of the source: an edit that moves a
marker fails loudly. ``--src TREE`` reads the sources of the checkout at
TREE (the wrappers' C interface must be the same), which times an earlier
design beside this one. Prints the card's name and power limit, then one
JSON line ``{"ablation": ...}``.

The second runs the flagship paired step (`chip_smoke.py`'s B=8 x 3.0 s
batch) of the checkout at TREE, with that tree's `chip_smoke.py` and
package: six steps (the median wall of the last five) and three profiled
steps, numbers 10 to 12 (device busy time and kernel launches). To compare
two trees, run it for each in one call, in the order parent, change,
change, parent. Prints one JSON line ``{"paired_busy": ...}``.
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


def main(src_tree=None):
    import chip_smoke
    from semi_tts_tpu_torch import kernels, use_fp32
    from semi_tts_tpu_torch.kernels import build

    chip_smoke.phase_device()
    use_fp32()
    kernels.build_all()
    csrc = build.CSRC if src_tree is None else \
        os.path.join(os.path.abspath(src_tree), "semi_tts_tpu_torch", "csrc")
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
    for stem, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"chip_ablate: nvcc failed for {stem}:\n{log}")
    cases = {c["name"]: c for c in chip_smoke.kernel_cases(torch.device("cuda"))}

    def timed(src, stem, case):
        build._libs[src] = ctypes.CDLL(str(out_dir / f"{stem}.so"))
        build.bind.cache_clear()
        return chip_smoke.device_ms(case["kernel"], case["iters"])

    result = {}
    with torch.no_grad():
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
    print(json.dumps({"ablation": result, "src": str(csrc)}))


def paired_busy(tree):
    import time

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import chip_smoke as cs
    import numpy as np
    from semi_tts_tpu_torch import kernels, use_fp32
    from semi_tts_tpu_torch.models import vqvae as V
    from semi_tts_tpu_torch.ops.features import AudioFeaturizer
    from semi_tts_tpu_torch.train.optim import Optimizer
    from semi_tts_tpu_torch.train.steps import StepBuilder
    from semi_tts_tpu_torch.utils.metrics import read_phn_attr

    cs.phase_device()
    use_fp32()
    kernels.build_all()
    dev = torch.device("cuda")
    config = cs.flagship_config()
    cfg = cs.flagship_vqvae_config(config)
    phn_attr = torch.from_numpy(read_phn_attr(config["model"]["codebook"]["phn_attr_pth"])).to(dev)
    model = V.VQVAE(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    builder = StepBuilder(cfg, AudioFeaturizer(cs.audio_config(), dev), phn_attr,
                          freq_loss_kwargs=cs.FLAGSHIP_FREQ_LOSS)
    step = builder.make_paired_step(Optimizer(model.parameters(), lr=1e-3, lr_scheduler="decay"))
    batch = cs.training_batch(0, dev)
    walls = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, i, 1.0, *batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls[1:]))
    prof = [cs.profiled_step(lambda k=k: step(model, 10 + k, 1.0, *batch), wall) for k in range(3)]
    print(json.dumps({"paired_busy": {"tree": tree, "cudnn_deterministic":
                                      torch.backends.cudnn.deterministic, "wall_s": wall,
                                      "walls_s": walls,
                                      "busy_s": [p["device_busy_s"] for p in prof],
                                      "launches": [p["kernel_launches"] for p in prof]}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--paired-busy"]:
        sys.exit(paired_busy(sys.argv[2]))
    if sys.argv[1:2] == ["--src"]:
        sys.exit(main(sys.argv[2]))
    sys.exit(main())
