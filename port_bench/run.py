"""Runs one cell of the benchmark of the PyTorch and CUDA port once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration
(``port_bench/configs/<config>.json``); its parameter file
``port_bench/workloads/<cell>.json`` names the traffic generator
(``port_bench/traffic/<kind>.py``) and holds everything that generator
reads, with the limits of the numbers that decide ``correct``. With
``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, each read by
``port_bench/metrics/<metric>.py`` from the traced window.

The last line of standard output is the result, one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key. ``--device cpu`` runs the plain path for
the tests, never a measurement."""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import types

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import harness as H  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def checks_of(numbers, limits):
    """{name: {"value", "limit"}} and whether every number is within its
    limit (a number that is not finite never is)."""
    out = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return out, ok


def main(argv=None, *, cell_override=None, conf_override=None):
    H.set_cache_dirs()
    a = parse(argv)
    import torch

    bench = H.manifest()
    cell = cell_override or H.cell_of(a.workload, bench)
    conf = conf_override or H.config_of(cell["config"], bench)
    chips = int(cell["chips"])
    device = torch.device(a.device)
    if device.type == "cuda":
        H.card_check(chips)
        print(f"port_bench: {H.card_line()}", file=sys.stderr, flush=True)
    ctx = types.SimpleNamespace(conf=conf, cell=cell, seed=a.seed, seconds=a.seconds,
                                trace=bool(a.trace), device=device, chips=chips, t0=T0)
    res = H.traffic_module(cell["kind"]).run(ctx)
    bad = H.forbidden_modules()
    if bad:
        print(f"port_bench: modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr, flush=True)
        raise SystemExit(4)
    data = res["data"]
    metrics, extra = {}, {}
    if a.trace:
        rctx = types.SimpleNamespace(data=data, cell=cell, costs=H.cost_modules())
        for m in H.metrics_of(a.workload, bench, "per_layer"):
            mod = H.reader(m["name"])
            value = None if mod is None else mod.read(rctx)
            if value is None:
                print(f"port_bench: {m['name']}: nothing to read", file=sys.stderr, flush=True)
                continue
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        tr = data["trace"]
        extra["breakdown"] = tr.breakdown()
        res["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
    else:
        for m in H.metrics_of(a.workload, bench, "end_to_end"):
            metrics[m["name"]] = {"value": float(data[m["name"]]), "unit": m["unit"]}
    checks, correct = checks_of(res["numbers"], cell["limits"])
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": res["device"], **extra, "checks": checks}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
