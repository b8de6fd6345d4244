"""The traffic generators: the same seed gives the same traffic, every seed
sends the same sizes, and the shapes set-up warms are the shapes sent."""

import numpy as np
import torch

import tiny
from port_bench import harness as H
from port_bench import serving as SV
from port_bench.traffic import bulk, online, train

CPU = torch.device("cpu")
SEED = 3000000017


def test_same_seed_same_train_batches():
    cell, conf = tiny.train_cell(), tiny.conf()
    a = train.batch_pool(cell, conf, SEED, CPU, "paired")
    b = train.batch_pool(cell, conf, SEED, CPU, "paired")
    c = train.batch_pool(cell, conf, SEED + 1, CPU, "paired")
    for x, y in zip(a, b):
        assert all(torch.equal(u, v) for u, v in zip(x, y))
    assert not torch.equal(a[0][0], c[0][0])


def test_train_batches_fit_their_pads_and_all_rows_differ():
    cell, conf = tiny.train_cell(), tiny.conf()
    for kind in ("paired", "unpaired"):
        spec = cell[kind]
        pool = train.batch_pool(cell, conf, SEED, CPU, kind)
        rows = torch.cat([w for w, _, _, _ in pool])
        assert rows.shape == (spec["pool"] * spec["batch"], spec["pad_samples"])
        assert len({tuple(r[:64].tolist()) for r in rows}) == rows.shape[0]
        for w, wl, text, sid in pool:
            assert int(wl.max()) <= spec["pad_samples"] and text.shape[1] == spec["pad_tokens"]
            assert bool(((text != 0).sum(1) > 0).all()) and int(sid.max()) < conf["n_spkr"]
            assert bool((w[torch.arange(w.shape[1])[None, :] >= wl[:, None].long()] == 0).all())


def test_step_schedule_is_the_trainers():
    hp = tiny.conf()["hparas"]
    assert [train.step_kind(s, hp) for s in range(6)] == [
        "paired", "paired", "speech_first", "paired", "speech_first", "paired"]
    hp = dict(hp, unpair_speech_weight=0.0)
    assert {train.step_kind(s, hp) for s in range(6)} == {"paired"}


def test_bulk_passes_same_sizes_for_every_seed_and_shapes_warmed_are_sent():
    cell, conf = tiny.serve_cell(), tiny.conf()
    tokens = SV.token_counts(cell, conf)
    r = conf["model"]["decoder"]["decoder"]["n_frames_per_step"]
    shapes = lambda reqs: [SV.shape_of(t, r) for t, _, _ in reqs]
    warm = bulk.pass_requests(cell, conf, SEED, -1, CPU, tokens)
    for seed in (SEED, SEED + 7):
        for p in range(3):
            reqs = bulk.pass_requests(cell, conf, seed, p, CPU, tokens)
            assert shapes(reqs) == shapes(warm)
            assert sorted((t != 0).sum(1).tolist() for t, _, _ in reqs) == \
                sorted((t != 0).sum(1).tolist() for t, _, _ in warm)
    a = bulk.pass_requests(cell, conf, SEED, 0, CPU, tokens)
    b = bulk.pass_requests(cell, conf, SEED, 0, CPU, tokens)
    assert all(np.array_equal(x[0], y[0]) and x[2] == y[2] for x, y in zip(a, b))


def test_online_schedule_same_sizes_and_gaps_for_every_seed():
    cell, conf = tiny.serve_cell("semi.online"), tiny.conf()
    cell["rate_per_s"] = 40.0
    d1, t1 = online.schedule(cell, conf, SEED, 20.0)
    d2, t2 = online.schedule(cell, conf, SEED + 1, 20.0)
    assert len(t1) == 800 and sorted(t1) == sorted(t2) and t1 != t2
    gaps = lambda d: sorted(np.append(np.diff(d), 20.0 - d[-1]))
    assert np.allclose(gaps(d1), gaps(d2))
    assert d1[0] == 0.0 and d1[-1] < 20.0
    d3, t3 = online.schedule(cell, conf, SEED, 20.0)
    assert np.array_equal(d1, d3) and t1 == t3


def test_decode_budget_is_the_servers():
    from semi_tts_tpu_torch.serve import TTSServer

    text = np.zeros((2, 32), np.int32)
    text[0, :17] = 5
    text[1, :30] = 5
    server = TTSServer.__new__(TTSServer)
    server.cfg = SV.vqvae_config(tiny.conf())
    server.step_bucket = SV.STEP_BUCKET
    assert SV.decode_steps(text, 3) == server.decode_steps_for(text)


def test_weights_same_seed_same_and_scaled():
    shapes = {"a.w": (64, 32), "a.b": (64,), "asr.bn.0.scale": (8,), "spkr_embed": (5, 4)}
    P, S = H.make_weights(shapes, {"asr.bn.0.var": (8,)}, SEED, CPU)
    Q, _ = H.make_weights(shapes, {"asr.bn.0.var": (8,)}, SEED, CPU)
    assert all(torch.equal(P[k], Q[k]) for k in P)
    assert float(P["a.w"].abs().max()) <= 32 ** -0.5 and float(P["a.b"].abs().max()) <= 32 ** -0.5
    assert 0.8 <= float(P["asr.bn.0.scale"].min()) and float(P["asr.bn.0.scale"].max()) <= 1.2
    assert 0.5 <= float(S["asr.bn.0.var"].min())


def test_bulk_sample_keeps_the_first_served_and_draws_the_rest_by_the_seed():
    def drawn(seed, n):
        s = bulk.Sample(seed)
        for i in range(n):
            s.offer(i)
        return s.items()

    a = drawn(SEED, 200)
    assert a == drawn(SEED, 200) and a != drawn(SEED + 1, 200)
    assert a[0] == 0 and len(a) == len(set(a)) == bulk.SAMPLE and max(a) < 200
    assert drawn(SEED, 2) == [0, 1]
    counts = np.zeros(40)
    for seed in range(2000):  # every served request but the first equally likely
        counts[drawn(seed, 40)[1:]] += 1
    early, late = counts[1:20].sum(), counts[20:].sum()
    assert counts[0] == 0 and abs(early - late) / (early + late) < 0.05
