#!/usr/bin/env python3
"""Where the time of K3 `attention_step` and K4 `gl_ola_frame` goes, on one
NVIDIA card; and the paired train step's time in a given tree.

    python3 chip_ablate.py
    python3 chip_ablate.py --paired-busy TREE

The first builds copies of ``semi_tts_tpu_torch/csrc/attention.cu`` and
``griffin_lim.cu`` that return after a phase (into the kernels' build
directory, under ``ablate/``), and times each copy at `chip_smoke.py`'s
serving shapes, beside the whole kernel, as device time per call from a
replayed CUDA graph. A cut copy computes nothing useful: only its time means
anything, and the time of a phase is the difference between two cuts. Prints
the card's name and power limit, then one JSON line ``{"ablation": ...}``.

The second runs the flagship paired step (`chip_smoke.py`'s B=8 x 3.0 s
batch) of the checkout at TREE, with that tree's `chip_smoke.py` and
package: six steps (the median wall of the last five) and three profiled
steps, numbers 10 to 12 (device busy time and kernel launches). To compare two trees, run it for each in one
call, in the order parent, change, change, parent. Prints one JSON line
``{"paired_busy": ...}``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

# (source, kernel case in chip_smoke.py, [(cut name, line after which the copy returns)])
CUTS = (
    ("attention", "attention_step", (
        ("launch", "  cg::cluster_group cluster = cg::this_cluster();\n"),
        ("prologue", "  cluster_wait();\n"),
        ("location features", "    if (l0 == 0) asm volatile(\"cp.async.wait_group 0;\\n\" ::: "
                              "\"memory\");  // pm and memory\n    __syncthreads();\n"),
        ("energies and exchange",
         "  cluster.sync();  // every partial has landed; no remote access after this\n"),
    )),
    ("griffin_lim", "gl_ola_frame", (
        ("overlap-add into shared memory",
         "  ola_segment(fb, env, lo, hi - lo + 1, g, [&](int i, float v) { seg[i] = v; });\n"
         "  __syncthreads();\n"),
    )),
)


def main():
    import chip_smoke
    from semi_tts_tpu_torch import kernels, use_fp32
    from semi_tts_tpu_torch.kernels import build

    chip_smoke.phase_device()
    use_fp32()
    kernels.build_all()
    out_dir = build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src, _, cuts in CUTS:
        text = (build.CSRC / f"{src}.cu").read_text()
        for i, (_, marker) in enumerate(cuts):
            if text.count(marker) != 1:
                raise SystemExit(f"chip_ablate: the cut after {marker!r} is not in csrc/{src}.cu")
            cu = out_dir / f"{src}_{i}.cu"
            cu.write_text(text.replace(marker, marker + "  return;\n"))
            procs[src, i] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"chip_ablate: nvcc failed for {key}:\n{log}")
    cases = {c["name"]: c for c in chip_smoke.kernel_cases(torch.device("cuda"))}
    result = {}
    with torch.no_grad():
        for src, name, cuts in CUTS:
            case, whole = cases[name], build.load(src)
            times = {"whole": chip_smoke.device_ms(case["kernel"], case["iters"])}
            for i, (cut, _) in enumerate(cuts):
                build._libs[src] = ctypes.CDLL(str(out_dir / f"{src}_{i}.so"))
                build.bind.cache_clear()
                times["to " + cut] = chip_smoke.device_ms(case["kernel"], case["iters"])
            build._libs[src] = whole
            build.bind.cache_clear()
            times["whole again"] = chip_smoke.device_ms(case["kernel"], case["iters"])
            result[name] = {"shapes": case["shapes"], "ms": times}
    print(json.dumps({"ablation": result}))


def paired_busy(tree):
    import os
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
    sys.exit(main())
