"""Bulk synthesis: one client in a closed loop through
``TTSServer.synthesize``, each request a batch of utterances taken longest
first as the offline solver orders its test loader, padded to the text
quantum, with the server's decode budget.

A cell file gives the durations utterances are drawn from, how many make a
pass, the cell's own size seed (every run seed sends the same sizes; it
draws the texts, speakers and keys), the batch and the server's program
cache. Set-up warms every shape of a pass; the window runs passes until its
time is up. Correctness: a sample of the requests the window served, the
first (the longest batch) and `SAMPLE` - 1 more drawn by the seed among the
rest as they are served (a reservoir), whose waveforms the reference makes
again once the window has closed."""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import harness as H
from port_bench import serving as SV

SAMPLE = 4  # requests checked: the longest batch and three drawn by the seed


def pass_requests(cell, conf, seed, p, device, tokens):
    """Pass ``p``'s requests: (text, sid, key), batches longest first."""
    g = H.generator(seed, f"pass{p}", device)
    order = sorted(tokens, reverse=True)
    B = cell["batch"]
    return [SV.make_request(order[i:i + B], conf, g) + (H.mix(seed, f"key{p}.{i}") % (1 << 62),)
            for i in range(0, len(order), B)]


class Sample:
    """The served requests checked: the first, and ``SAMPLE - 1`` of the
    rest drawn by the seed as they come, each served one equally likely."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(H.mix(seed, "sample") % (1 << 32))
        self.first, self.rest, self.seen = [], [], 0

    def offer(self, item):
        if not self.first:
            self.first.append(item)
            return
        self.seen += 1
        if len(self.rest) < SAMPLE - 1:
            self.rest.append(item)
        else:
            j = self.rng.randint(self.seen)
            if j < SAMPLE - 1:
                self.rest[j] = item

    def items(self):
        return self.first + self.rest


def run(ctx):
    conf, cell, seed, device = ctx.conf, ctx.cell, ctx.seed, ctx.device
    server = SV.build_server(conf, cell, seed, device)
    r = server.cfg.n_frames_per_step
    tokens = SV.token_counts(cell, conf)
    calls = {}
    recorder = H.CallRecorder(H.cost_modules()) if ctx.trace else None
    shapes = SV.warm(server, pass_requests(cell, conf, seed, -1, device, tokens),
                     recorder=recorder, calls=calls)
    H.sync(device)
    data = {"setup_s": time.perf_counter() - ctx.t0}
    print(f"port_bench: {len(shapes)} request shapes (decode steps, batch, text) warmed: {shapes}",
          flush=True)
    n_pass = -(-len(tokens) // cell["batch"])
    sample = Sample(seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    spans = H.Spans()
    seconds = min(ctx.seconds, cell["trace_seconds"]) if ctx.trace else ctx.seconds

    def window():
        n_utt, attempted, failed, i = 0, 0, 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for text, sid, key in pass_requests(cell, conf, seed, i // n_pass, device, tokens):
                attempted += 1
                with spans.span("port_bench.request.%dx%dx%d" % SV.shape_of(text, r)):
                    try:
                        wav = server.synthesize(text, sid, key=key)
                    except Exception as e:  # a request that fails counts as failed
                        print(f"port_bench: request failed: {e!r}", flush=True)
                        failed += 1
                        wav = None
                if wav is not None:
                    n_utt += text.shape[0]
                    sample.offer((text, sid, key, wav))
                i += 1
                if time.perf_counter() - t0 >= seconds:
                    break
        H.sync(device)
        return n_utt, attempted, failed, time.perf_counter() - t0

    if ctx.trace:
        spans.traced = True
        with H.profiled(device) as out:
            n_utt, attempted, failed, elapsed = window()
        data["trace"] = out["trace"]
        data["calls"] = {"%dx%dx%d" % s: c for s, c in calls.items()}
        data["flops"] = {"%dx%dx%d" % s: SV.request_flops(conf, s) for s in shapes}
    else:
        n_utt, attempted, failed, elapsed = window()
        data["synth_utt_per_s"] = n_utt / elapsed
        print(f"port_bench: {attempted} requests, {n_utt} utterances in {elapsed:.3f} s", flush=True)
    device_rec = H.device_record(device, ctx.chips)
    del server
    SV.free(device)
    t_ref = time.perf_counter()
    numbers = {"wave_gap": SV.reference_check(conf, seed, device, sample.items())}
    print(f"port_bench: the reference's {len(sample.items())} requests took "
          f"{time.perf_counter() - t_ref:.3f} s", flush=True)
    return dict(data=data, numbers=numbers, attempted=attempted, failed=failed, device=device_rec)
