"""The online cell's rate sweep: its latency at each offered rate, from one
set-up, to find the highest rate the server sustains (the cell's file
offers four fifths of it). Not run by the benchmark's own runs.

    python3 port_bench/rate_sweep.py --workload semi.online --config semi-multi-spkr \
        --seed 1 --rates 20,30,40 --seconds 10

One line a rate: the requests sent, p50 and p95 of the latency, and the
mean latency of the first and of the last quarter of the requests (a queue
that grows through the run reads the second far above the first)."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from port_bench import harness as H  # noqa: E402
from port_bench import serving as SV  # noqa: E402


def sweep(conf, cell, seed, dev, rates, seconds):
    from port_bench.traffic import online

    server = SV.build_server(conf, cell, seed, dev)
    _, all_reqs = online.requests_of(dict(cell, rate_per_s=max(rates)), conf, seed, dev, seconds)
    SV.warm(server, all_reqs + all_reqs)
    for rate in rates:
        due, reqs = online.requests_of(dict(cell, rate_per_s=rate), conf, seed, dev, seconds)
        lat = []
        t0 = time.perf_counter()
        for i, (t, s, k) in enumerate(reqs):
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            server.synthesize(t, s, key=k)
            lat.append(time.perf_counter() - t0 - due[i])
        q = max(1, len(lat) // 4)
        print(json.dumps(dict(rate=rate, requests=len(lat), p50_ms=statistics.median(lat) * 1e3,
                              p95_ms=H.percentile(lat, 95) * 1e3,
                              first_quarter_mean_ms=statistics.mean(lat[:q]) * 1e3,
                              last_quarter_mean_ms=statistics.mean(lat[-q:]) * 1e3,
                              end_s=time.perf_counter() - t0)), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="semi.online")
    p.add_argument("--config", default="semi-multi-spkr")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    a = p.parse_args(argv)
    H.set_cache_dirs()
    cell = H.read_json(os.path.join(H.HERE, "workloads", a.workload + ".json"))
    conf = H.config_of(a.config)
    H.card_check(1)
    print(json.dumps({"card": H.card_line(), "workload": a.workload}), flush=True)
    sweep(conf, cell, a.seed, torch.device("cuda"), [float(r) for r in a.rates.split(",")],
          a.seconds)


if __name__ == "__main__":
    main()
