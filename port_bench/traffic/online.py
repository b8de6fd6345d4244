"""Online serving: one-utterance requests from independent users, an open
loop of Poisson arrivals at the cell's fixed rate through
``TTSServer.synthesize``; each request is timed from its due time to its
waveform's return, so a stall counts against the requests behind it.

A cell file gives the rate, the durations texts are drawn from and its own
size seed: a run of ``seconds`` sends ``rate * seconds`` requests whose
sizes and gaps (the gaps scaled to fill the window exactly) are the same
for every run seed, which only orders them and draws texts, speakers and
keys. Correctness: the longest request and a sample drawn by the seed are
made again by the reference once the window has closed."""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from port_bench import harness as H
from port_bench import serving as SV

SAMPLE = 8  # requests checked: the longest and seven drawn by the seed


def schedule(cell, conf, seed, seconds):
    """(due times, token counts) of the window's requests."""
    n = max(1, int(round(cell["rate_per_s"] * seconds)))
    rng = np.random.RandomState(cell["size_seed"])
    gaps = rng.exponential(1.0, size=n)
    gaps *= seconds / gaps.sum()
    d = rng.choice(np.asarray(cell["durations"]), size=n, replace=True)
    a = conf["audio"]
    hop = int(a["frame_shift_ms"] / 1000 * a["sample_rate"])
    tokens = np.array([H.tokens_of(x, a["sample_rate"], hop) for x in d])
    perm = np.random.RandomState(H.mix(seed, "order") % (1 << 32))
    gaps, tokens = gaps[perm.permutation(n)], tokens[perm.permutation(n)]
    return np.cumsum(gaps) - gaps, tokens.tolist()


def requests_of(cell, conf, seed, device, seconds):
    """(due times, requests (text, sid, key)) of a window of ``seconds``."""
    due, tokens = schedule(cell, conf, seed, seconds)
    g = H.generator(seed, "requests", device)
    return due, [SV.make_request([t], conf, g) + (H.mix(seed, f"key{i}") % (1 << 62),)
                 for i, t in enumerate(tokens)]


def sample_of(seed, tokens):
    """The indices of the checked requests: the longest and ``SAMPLE - 1``
    more drawn by the seed."""
    longest = int(np.argmax(tokens))
    rng = np.random.RandomState(H.mix(seed, "sample") % (1 << 32))
    others = [i for i in range(len(tokens)) if i != longest]
    return {longest} | set(rng.choice(others, min(SAMPLE - 1, len(others)), replace=False).tolist())


def run(ctx):
    conf, cell, seed, device = ctx.conf, ctx.cell, ctx.seed, ctx.device
    server = SV.build_server(conf, cell, seed, device)
    r = server.cfg.n_frames_per_step
    seconds = min(ctx.seconds, cell["trace_seconds"]) if ctx.trace else ctx.seconds
    due, requests = requests_of(cell, conf, seed, device, seconds)
    tokens = [int((t != 0).sum()) for t, _, _ in requests]
    calls = {}
    recorder = H.CallRecorder(H.cost_modules()) if ctx.trace else None
    gw = H.generator(seed, "warm-up", device)
    warm = [SV.make_request([t], conf, gw) + (i,) for i, t in enumerate(sorted(set(tokens)))]
    shapes = SV.warm(server, warm + warm, recorder=recorder, calls=calls)
    H.sync(device)
    data = {"setup_s": time.perf_counter() - ctx.t0}
    print(f"port_bench: {len(shapes)} request shapes (decode steps, batch, text) warmed", flush=True)
    sample = sample_of(seed, tokens)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    spans = H.Spans()

    def window():
        lat, service, late, served, failed = [], [], [], [], 0
        t0 = time.perf_counter()
        prev_end = t0
        for i, (text, sid, key) in enumerate(requests):
            at = t0 + due[i]
            wait = at - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            start = time.perf_counter()
            if prev_end <= at:  # the server was free: how late the generator sent it
                late.append(start - at)
            with spans.span("port_bench.request.%dx%dx%d" % SV.shape_of(text, r)):
                try:
                    wav = server.synthesize(text, sid, key=key)
                except Exception as e:  # a failed request misses every limit
                    print(f"port_bench: request failed: {e!r}", flush=True)
                    wav, failed = None, failed + 1
            end = time.perf_counter()
            lat.append(end - at if wav is not None else float("inf"))
            service.append(end - max(at, prev_end))
            prev_end = end
            if wav is not None and i in sample:
                served.append((text, sid, key, wav))
        H.sync(device)
        return lat, service, late, served, failed, time.perf_counter() - t0

    if ctx.trace:
        spans.traced = True
        with H.profiled(device) as out:
            lat, service, late, served, failed, elapsed = window()
        data["trace"] = out["trace"]
        data["calls"] = {"%dx%dx%d" % s: c for s, c in calls.items()}
        data["flops"] = {"%dx%dx%d" % s: SV.request_flops(conf, s) for s in shapes}
    else:
        lat, service, late, served, failed, elapsed = window()
        data["serve_p95_ms"] = H.percentile(lat, 95) * 1e3
    data["service_s"] = service
    print(f"port_bench: {len(requests)} requests at {cell['rate_per_s']}/s over {seconds} s "
          f"(the last returned {elapsed:.3f} s after the first was due); p50 "
          f"{statistics.median(lat) * 1e3:.3f} ms, p95 {H.percentile(lat, 95) * 1e3:.3f} ms; "
          f"median service {statistics.median(service) * 1e3:.3f} ms", flush=True)
    if late:
        print(f"port_bench: the generator sent requests to an idle server late by a median "
              f"{statistics.median(late) * 1e3:.3f} ms, at most {max(late) * 1e3:.3f} ms "
              f"({len(late)} requests)", flush=True)
    device_rec = H.device_record(device, ctx.chips)
    del server
    SV.free(device)
    numbers = {"wave_gap": SV.reference_check(conf, seed, device, served)}
    return dict(data=data, numbers=numbers, attempted=len(requests), failed=failed,
                device=device_rec)
