"""How many distinct train-step shapes a corpus gives, and what a program
cache makes of them.

A train step is captured as one CUDA graph per set of input shapes
(`graphs.StepProgram`). The loader pads each batch's waves to the bucket
of its longest wave and its texts to a multiple of ``TEXT_QUANTUM``, so a
batch's shape is (wave bucket, text bucket); a cycle step's shape is its
paired batch's and its unpaired batch's together. This replays the
loader's seeded shuffle over a partition table's durations for a run of
``--steps`` steps of the flagship schedule (paired on odd steps and step 0,
speech-first on the other even steps; text-first on odd steps with
``--text-first``) and counts, for each step kind: the distinct shapes, the
first calls (run eagerly), the captures and the replays under the
capture-on-repeat policy with an unbounded cache, and the captures that a
bounded LRU of ``--lru`` graphs capturing at first sight would make. It
counts the same for the LM pretraining steps over the same number of
steps (the audio LM keyed by its wave bucket, the text LM by its text
bucket, both on the unpaired split, or the paired one when that is empty)
and the shapes of one pass over the dev split (unshuffled, longest first,
the last batch short), which the eval step and the LMs' dev losses see at
every validation (``programs``: the distinct shapes of each kind, the
graphs a run would hold without a budget), and the share of the train
steps that replay a graph when a budget admits only so many
(``replayed_share_by_graphs``).

The tables hold durations, not transcripts, so a text's length is modelled
from its duration at the decode budget's rate (``FRAME_PHN_RATIO`` mel
frames a phoneme); ``--no-text`` keys on the waves alone (a lower bound).

    python3 -m semi_tts_tpu_torch.data.step_shapes \\
        data/partition_tables/semi-multi-spkr-sd0.csv --steps 100000
"""

from __future__ import annotations

import argparse
import json
from collections import Counter, OrderedDict

import numpy as np

from .corpus import _descending, read_partition
from .loader import DEFAULT_BUCKETS_SEC, TEXT_QUANTUM, _round_up

FRAME_PHN_RATIO = 6.0  # mel frames a phoneme (models/vqvae.py)
GRAPH_COUNTS = (8, 16, 32, 64, 128, 256)  # graph budgets to give the replayed share under


def _key_of(durations, *, sample_rate=22050, hop=275, text=True):
    """The (wave bucket, text bucket) of a batch of rows, a function of
    their indices."""
    d = np.asarray(durations, np.float64)
    samples = np.round(d * sample_rate).astype(np.int64)
    tokens = np.ceil(d * sample_rate / hop / FRAME_PHN_RATIO).astype(np.int64)
    buckets = sorted(int(b * sample_rate) for b in DEFAULT_BUCKETS_SEC)

    def key(idx):
        n = int(samples[idx].max())
        wave = next((b for b in buckets if n <= b), _round_up(n, buckets[-1]))
        return wave, _round_up(int(tokens[idx].max()), TEXT_QUANTUM) if text else 0
    return key


def batch_keys(durations, n_batches, *, batch_size=8, seed=0, text=True, **kw):
    """The (wave bucket, text bucket) of ``n_batches`` batches that
    `loader.TTSLoader` (shuffled, ``drop_last``) draws from rows of these
    durations, over as many epochs as it takes."""
    key = _key_of(durations, text=text, **kw)
    rng = np.random.RandomState(seed)
    keys = []
    while len(keys) < n_batches:
        order = np.arange(len(durations))
        rng.shuffle(order)
        for s in range(0, len(durations) - batch_size + 1, batch_size):
            keys.append(key(order[s: s + batch_size]))
            if len(keys) == n_batches:
                break
    return keys


def dev_keys(durations, *, batch_size=8, text=True, **kw):
    """The (wave bucket, text bucket) of one pass of an evaluation loader
    over rows of these durations: longest first, unshuffled, the last batch
    short."""
    key = _key_of(durations, text=text, **kw)
    order = _descending(durations)
    return [key(order[s: s + batch_size]) for s in range(0, len(order), batch_size)]


def lm_keys(table, steps, *, seed=0, text=True):
    """{"audio_lm": [(wave bucket,)], "text_lm": [(text bucket,)]} of
    ``steps`` LM pretraining steps on ``table``'s unpaired split (the
    paired one when that is empty)."""
    durs = [r["duration"] for r in read_partition(table, "unpaired")]
    durs = durs or [r["duration"] for r in read_partition(table, "paired")]
    keys = batch_keys(durs, steps, seed=seed, text=text)
    return {"audio_lm": [(w,) for w, _ in keys], "text_lm": [(t,) for _, t in keys]}


def step_keys(table, steps, *, text_first=False, seed=0, text=True):
    """[(kind, shape key)] of ``steps`` train steps on ``table``'s paired
    and unpaired splits."""
    durs = {s: [r["duration"] for r in read_partition(table, s)] for s in ("paired", "unpaired")}
    paired = iter(batch_keys(durs["paired"], steps, seed=seed, text=text))
    unpaired = iter(batch_keys(durs["unpaired"], steps, seed=seed, text=text))
    out = []
    for step in range(steps):
        p = next(paired)
        if step % 2 == 0 and step > 0:
            out.append(("speech_first", (p, next(unpaired))))
        elif step % 2 == 1 and text_first:
            out.append(("text_first", (p, next(unpaired))))
        else:
            out.append(("paired", p))
    return out


def cache_counts(keys, lru):
    """For one step kind's keys, in order: distinct shapes, first calls,
    captures and replays under capture-on-repeat (unbounded), and the
    captures of an ``lru``-graph LRU that captures at first sight."""
    seen = Counter()
    first = captures = replays = 0
    for k in keys:
        seen[k] += 1
        if seen[k] == 1:
            first += 1
        elif seen[k] == 2:
            captures += 1
        else:
            replays += 1
    cache, lru_captures = OrderedDict(), 0
    for k in keys:
        if k in cache:
            cache.move_to_end(k)
        else:
            lru_captures += 1
            cache[k] = True
            if len(cache) > lru:
                cache.popitem(last=False)
    top = [n for _, n in seen.most_common()]
    cover = {f"{p}%": next(i + 1 for i, c in enumerate(np.cumsum(top)) if c >= p / 100 * len(keys))
             for p in (50, 90, 99)}
    return dict(steps=len(keys), shapes=len(seen), shapes_for_share_of_steps=cover,
                first_calls=first, captures=captures, replays=replays,
                **{f"lru{lru}_captures": lru_captures})


def budgeted_replays(keys, graphs):
    """The share of ``keys`` (one trainer's steps of every kind, in order)
    that replay a graph when at most ``graphs`` are captured, each at its
    shape's second call, and past that a new shape runs eagerly, as under
    `graphs.GraphOwner`'s budget (nothing is evicted)."""
    seen, captured, replays = Counter(), set(), 0
    for k in keys:
        seen[k] += 1
        if k in captured:
            replays += 1
        elif seen[k] >= 2 and len(captured) < graphs:
            captured.add(k)
    return replays / len(keys)


def mean_step_s(keys, eager, capture, replay):
    """{steps: mean seconds a step over the first ``steps``} for one step
    kind's keys under capture-on-repeat: a first call is eager, a second
    captures and replays, a later one replays."""
    seen, total, out = Counter(), 0.0, {}
    for i, k in enumerate(keys, 1):
        seen[k] += 1
        total += eager if seen[k] == 1 else capture + replay if seen[k] == 2 else replay
        if i in (1_000, 10_000) or i == len(keys):
            out[i] = total / i
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("table")
    p.add_argument("--steps", type=int, default=100_000)
    p.add_argument("--lru", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--text-first", action="store_true")
    p.add_argument("--no-text", action="store_true")
    p.add_argument("--times", help="EAGER,CAPTURE,REPLAY seconds (for mean_step_s)")
    a = p.parse_args(argv)
    keys = step_keys(a.table, a.steps, text_first=a.text_first, seed=a.seed, text=not a.no_text)
    by_kind = {kind: [key for k, key in keys if k == kind]
               for kind in dict.fromkeys(k for k, _ in keys)}
    by_kind.update(lm_keys(a.table, a.steps, seed=a.seed, text=not a.no_text))
    out = {}
    for kind, ks in by_kind.items():
        out[kind] = cache_counts(ks, a.lru)
        out[kind]["shapes_by_step"] = {n: len(set(ks[:n])) for n in (100, 1_000, 10_000)
                                       if n <= len(ks)}
        if a.times:
            out[kind]["mean_step_s"] = mean_step_s(ks, *map(float, a.times.split(",")))
    dev = dev_keys([r["duration"] for r in read_partition(a.table, "dev")], text=not a.no_text)
    out["dev"] = {"batches": len(dev), "eval_shapes": len(set(dev)),
                  "audio_lm_shapes": len({w for w, _ in dev}),
                  "text_lm_shapes": len({t for _, t in dev})}
    out["replayed_share_by_graphs"] = {n: budgeted_replays(keys, n) for n in GRAPH_COUNTS}
    out["programs"] = dict({k: out[k]["shapes"] for k in by_kind}, eval=out["dev"]["eval_shapes"],
                           audio_lm_dev=out["dev"]["audio_lm_shapes"],
                           text_lm_dev=out["dev"]["text_lm_shapes"])
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
