"""The port's data layer (`semi_tts_tpu_torch/data`: `wavio`, `corpus`,
`loader`, `load_dataset`) against the JAX package's: WAV files read and
written bit for bit, the partition tables' split order, and the same
batches in the same order from the same seed (file ids, waves bit for
bit, lengths, text and speaker ids)."""

from __future__ import annotations

import json
import struct
from os.path import join

import numpy as np
import pytest

from helpers import REPO, make_synthetic_corpus, tiny_config
from semi_tts_tpu.data import corpus as JC
from semi_tts_tpu.data import load_dataset as j_load_dataset
from semi_tts_tpu.data import wavio as jwavio
from semi_tts_tpu.data.loader import TTSLoader as JLoader
from semi_tts_tpu_torch.data import corpus as PC
from semi_tts_tpu_torch.data import load_dataset as p_load_dataset
from semi_tts_tpu_torch.data import wavio as pwavio
from semi_tts_tpu_torch.data.loader import TTSLoader as PLoader
from semi_tts_tpu_torch.data.loader import infinite
from semi_tts_tpu_torch.data.text import load_text_encoder

SPLITS = ("unpair_set", "pair_set", "dev_set", "test_set")


@pytest.mark.parametrize("subtype", ["PCM_16", "FLOAT"])
@pytest.mark.parametrize("channels", [1, 2])
def test_wavio_round_trip_matches_jax(tmp_path, subtype, channels):
    """Both packages write the same bytes and read them back to the same
    arrays, bit for bit."""
    wav = np.random.RandomState(channels).uniform(-1.2, 1.2, (channels, 1001)).astype(np.float32)
    if channels == 1:
        wav = wav[0]
    pwavio.write(tmp_path / "p.wav", wav, 22050, subtype=subtype)
    jwavio.write(tmp_path / "j.wav", wav, 22050, subtype=subtype)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    (pw, psr), (jw, jsr) = pwavio.read(tmp_path / "p.wav"), jwavio.read(tmp_path / "p.wav")
    assert psr == jsr == 22050 and pw.dtype == np.float32
    np.testing.assert_array_equal(pw, jw)
    assert pwavio.duration(tmp_path / "p.wav") == jwavio.duration(tmp_path / "p.wav")


@pytest.mark.parametrize("bits", [24, 32])
def test_wavio_reads_wide_pcm_as_jax(tmp_path, bits):
    """24- and 32-bit PCM, with an odd-sized chunk before the data (word
    alignment), decode as the JAX reader decodes them."""
    rng = np.random.RandomState(bits)
    raw = rng.randint(0, 256, size=3 * bits // 8 * 40, dtype=np.uint8).tobytes()
    fmt = struct.pack("<IHHIIHH", 16, 1, 1, 16000, 16000 * bits // 8, bits // 8, bits)
    body = b"WAVE" + b"fmt " + fmt + b"LIST" + struct.pack("<I", 3) + b"abc\x00"
    body += b"data" + struct.pack("<I", len(raw)) + raw
    path = tmp_path / "w.wav"
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    (pw, psr), (jw, jsr) = pwavio.read(path), jwavio.read(path)
    assert psr == jsr == 16000 and pw.shape == (1, 120)
    np.testing.assert_array_equal(pw, jw)


@pytest.mark.parametrize("table", ["semi-multi-spkr-sd0", "semi-single-spkr-sd0"])
@pytest.mark.parametrize("split", ["paired", "dev", "test"])
def test_corpus_rows_match_jax(table, split):
    """The repo's partition tables (up to 2,000 rows a split, many tied
    durations): the same file paths and speaker ids in the same order as
    the JAX dataset's pandas sort, the 'lj' speaker dropped from test."""
    kw = dict(path="/corpus", partition_table=join(REPO, f"data/partition_tables/{table}.csv"),
              split=split, bucketing=False, batch_size=8,
              spkr_map=join(REPO, "corpus_meta/spkr/lj_vctk.json"))
    jds, pds = JC.VCTKDataset(**kw), PC.VCTKDataset(**kw)
    assert len(pds) == len(jds) > 100
    assert [pds[i] for i in range(len(pds))] == [
        (f, int(s)) for f, s in zip(jds.table.file_path, jds.table.speaker)]
    assert pds.get_statics() == jds.get_statics()


def test_ljspeech_paths_and_empty_split(tmp_path):
    """LJSpeech's flat wavs folder; an empty split keeps one placeholder
    row, as the JAX table does."""
    table = tmp_path / "t.csv"
    table.write_text(",speaker,split,duration\nLJ001-0001,lj,paired,1.5\nLJ001-0002,lj,paired,2.5\n")
    spkr = tmp_path / "s.json"
    spkr.write_text(json.dumps({"lj": 0}))
    kw = dict(path="/lj", partition_table=str(table), bucketing=False, batch_size=2,
              spkr_map=str(spkr))
    pds = PC.LJSpeechDataset(split="paired", **kw)
    jds = JC.LJSpeechDataset(split="paired", **kw)
    assert [pds[i] for i in range(2)] == [("/lj/wavs/LJ001-0002.wav", 0),
                                          ("/lj/wavs/LJ001-0001.wav", 0)]
    assert list(jds.table.file_path) == [p for p, _ in (pds[0], pds[1])]
    assert len(PC.VCTKDataset(split="dev", **kw)) == len(JC.VCTKDataset(split="dev", **kw)) == 1


def _same_batch(p, j):
    assert p.fids == j.fids
    for k in ("waves", "wave_len", "sid", "text", "text_len"):
        assert p[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)


@pytest.mark.parametrize("inference_stage", [False, True])
def test_load_dataset_batches_match_jax(tmp_path, inference_stage):
    """Two epochs of every split from one seed: the same batches, in the
    same order (the train splits shuffled and with a short last batch
    dropped; dev and test in table order)."""
    cfg = tiny_config(str(tmp_path))["data"]
    cfg["corpus"] = make_synthetic_corpus(str(tmp_path), n_per_split=(7, 5, 3, 3), seed=3)
    kw = dict(inference_stage=inference_stage, seed=5, **cfg)
    pouts = p_load_dataset(0, False, False, device="cpu", **kw)
    jouts = j_load_dataset(0, False, False, shard_id=0, num_shards=1, **kw)
    assert pouts[5].vocab_size == jouts[5].vocab_size and pouts[6] == jouts[6]
    for name, p, j in zip(SPLITS, pouts[:4], jouts[:4]):
        if j is None:
            assert p is None, name
            continue
        assert len(p) == len(j), name
        for _ in range(2):
            pb, jb = list(p), list(j)
            assert len(pb) == len(jb) > 0, name
            for a, b in zip(pb, jb):
                _same_batch(a, b)


def test_bucketing_loader_matches_jax(tmp_path):
    """A bucketing dataset (an item is a batch of similar durations)."""
    corpus = make_synthetic_corpus(str(tmp_path), n_per_split=(9, 2, 2, 2), seed=4)
    kw = dict(path=corpus["path"], partition_table=corpus["partition_table"], split="paired",
              bucketing=True, batch_size=3, spkr_map=corpus["spkr_map"])
    tok = load_text_encoder("phoneme", corpus["vocab_file"], corpus["map_table"])
    pl = PLoader(PC.VCTKDataset(**kw), tok, seed=2)
    jl = JLoader(JC.VCTKDataset(**kw), tok, seed=2)
    assert len(pl) == len(jl) == 9
    for a, b in zip(list(pl), list(jl)):
        _same_batch(a, b)


def test_infinite_raises_on_an_empty_loader(tmp_path):
    corpus = make_synthetic_corpus(str(tmp_path), n_per_split=(2, 2, 2, 2))
    ds = PC.VCTKDataset(corpus["path"], corpus["partition_table"], "paired", False, 4,
                        corpus["spkr_map"])
    tok = load_text_encoder("phoneme", corpus["vocab_file"], corpus["map_table"])
    loader = PLoader(ds, tok, prefetch=0)
    assert len(loader) == 0
    with pytest.raises(RuntimeError, match="no batches"):
        next(infinite(loader))
    # without drop_last the short batch comes, and the loader cycles
    loader = PLoader(ds, tok, drop_last=False, shuffle=False)
    it = infinite(loader)
    assert [next(it).fids for _ in range(2)] == [list(loader)[0].fids] * 2


def test_loader_raises_the_decoders_errors(tmp_path):
    """A file that is not a WAV surfaces from the prefetch thread."""
    corpus = make_synthetic_corpus(str(tmp_path), n_per_split=(2, 2, 2, 2))
    ds = PC.VCTKDataset(corpus["path"], corpus["partition_table"], "paired", False, 2,
                        corpus["spkr_map"])
    with open(ds[0][0], "wb") as f:
        f.write(b"not a wav")
    tok = load_text_encoder("phoneme", corpus["vocab_file"], corpus["map_table"])
    with pytest.raises(ValueError, match="RIFF"):
        list(PLoader(ds, tok))


def test_step_shapes_follow_the_loader():
    """`data/step_shapes.py` pads as the loader does (each wave bucket is
    `TTSLoader._bucket_len` of the batch's longest wave, each text a
    multiple of the quantum), and its cache counts add up: every step is a
    first call, a capture or a replay, one capture a shape seen twice."""
    from semi_tts_tpu_torch.data import step_shapes as S

    table = join(REPO, "data/partition_tables/semi-multi-spkr-sd0.csv")
    durs = [r["duration"] for r in PC.read_partition(table, "paired")]
    loader = PLoader.__new__(PLoader)
    loader.bucket_samples = sorted(int(b * 22050) for b in S.DEFAULT_BUCKETS_SEC)
    rng = np.random.RandomState(0)
    order = np.arange(len(durs))
    rng.shuffle(order)
    keys = S.batch_keys(durs, 40)
    for i, (wave, text) in enumerate(keys):
        longest = max(durs[j] for j in order[8 * i: 8 * i + 8])
        assert wave == loader._bucket_len(int(round(longest * 22050)))
        assert text % S.TEXT_QUANTUM == 0 and text > 0
    steps = S.step_keys(table, 300)
    assert [k for k, _ in steps[:3]] == ["paired", "paired", "speech_first"]
    for kind in ("paired", "speech_first"):
        ks = [key for k, key in steps if k == kind]
        c = S.cache_counts(ks, lru=8)
        assert c["first_calls"] + c["captures"] + c["replays"] == c["steps"] == len(ks)
        assert c["first_calls"] == c["shapes"] == len(set(ks))
        assert c["captures"] == sum(ks.count(k) >= 2 for k in set(ks))
        assert c["shapes"] <= c["lru8_captures"] <= c["steps"]
