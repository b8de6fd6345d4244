"""The port's host tools against the JAX package's: the native WAV decoder
and edit distance (`semi_tts_tpu_torch/native`), the loader's use of them,
the import of an upstream checkpoint (`train/torch_import.py` and
``python -m semi_tts_tpu_torch.util_cli.import_reference_ckpt``) and the
offline vocoder (``util_cli.gen_wav_from_specgram``), each end to end on
the CPU."""

from __future__ import annotations

import os
import sys
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from helpers import REPO, make_synthetic_corpus, tiny_config
from semi_tts_tpu import native as jnative
from semi_tts_tpu.models import vqvae as JV
from semi_tts_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
from semi_tts_tpu.train.torch_import import convert_state_dict as j_convert
from semi_tts_tpu.utils.metrics import edit_distance as j_edit_distance
from semi_tts_tpu_torch import native
from semi_tts_tpu_torch.bridge import _flatten, to_jax_params
from semi_tts_tpu_torch.data import corpus as PC
from semi_tts_tpu_torch.data import wavio
from semi_tts_tpu_torch.data.loader import TTSLoader
from semi_tts_tpu_torch.data.text import load_text_encoder
from semi_tts_tpu_torch.models import vqvae as V
from semi_tts_tpu_torch.ops import griffin_lim as PGL
from semi_tts_tpu_torch.train import torch_import as TI
from semi_tts_tpu_torch.train.checkpoint import load_checkpoint
from semi_tts_tpu_torch.util_cli import gen_wav_from_specgram as PGW
from semi_tts_tpu_torch.util_cli import import_reference_ckpt as PIR
from semi_tts_tpu_torch.utils.metrics import edit_distance

sys.path.insert(0, join(REPO, "util_cli"))
import gen_wav_from_specgram as JGW  # noqa: E402
import import_reference_ckpt as JIR  # noqa: E402

FORMATS = (("PCM_16", 1, 12345), ("FLOAT", 1, 4001), ("PCM_16", 2, 30011), ("FLOAT", 2, 777))


def _wav_files(tmp_path):
    rng = np.random.RandomState(0)
    paths = []
    for i, (subtype, ch, n) in enumerate(FORMATS):
        w = (rng.randn(ch, n) * 0.4).clip(-1, 1).astype(np.float32)
        p = str(tmp_path / f"t{i}.wav")
        wavio.write(p, w if ch > 1 else w[0], 22050, subtype=subtype)
        paths.append(p)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF not a wav file at all")
    return paths + [str(bad), str(tmp_path / "missing.wav")]


@pytest.mark.parametrize("channel", [0, 1])
def test_native_decode_matches_jax_and_wavio(tmp_path, channel):
    """The port's decoder equals the JAX package's and `wavio` bit for bit
    (cut at the capacity); an unreadable row, and a channel a file lacks,
    have length -1."""
    paths = _wav_files(tmp_path)
    cap = 20000
    got, lens, srs = native.wav_read_batch(paths, cap, channel=channel, n_threads=3)
    want, j_lens, j_srs = jnative.wav_read_batch(paths, cap, channel=channel, n_threads=3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lens, j_lens)
    np.testing.assert_array_equal(srs, j_srs)
    for i, (_, ch, n) in enumerate(FORMATS):
        if channel >= ch:
            assert lens[i] == -1
            continue
        ref = wavio.read(paths[i])[0][channel][:cap]
        assert lens[i] == len(ref) == min(n, cap) and srs[i] == 22050
        np.testing.assert_array_equal(got[i, :lens[i]], ref)
        assert not got[i, lens[i]:].any()
    assert list(lens[-2:]) == [-1, -1]


def test_native_build_lands_in_the_build_dir_and_a_failed_build_raises(tmp_path, monkeypatch):
    assert native.target().parent == native.BUILD_DIR and native.target().exists()
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not any((tmp_path / "_build").iterdir())  # no half-written library left


def test_edit_distance_matches_jax():
    rng = np.random.RandomState(1)
    for _ in range(40):
        a = rng.randint(0, 8, rng.randint(0, 20)).tolist()
        b = rng.randint(0, 8, rng.randint(0, 20)).tolist()
        assert edit_distance(a, b) == j_edit_distance(a, b) == native.edit_distance(a, b)


def test_loader_reads_an_undecodable_row_with_wavio(tmp_path, monkeypatch):
    """A row the native decoder returns as -1 is read with `wavio`, and the
    batch equals the one decoded natively."""
    corpus = make_synthetic_corpus(str(tmp_path), n_per_split=(4, 2, 2, 2))
    ds = PC.VCTKDataset(corpus["path"], corpus["partition_table"], "paired", False, 4,
                        corpus["spkr_map"])
    tok = load_text_encoder("phoneme", corpus["vocab_file"], corpus["map_table"])
    want = next(iter(TTSLoader(ds, tok, shuffle=False, prefetch=0)))
    read = native.wav_read_batch

    def one_fails(paths, capacity, **kw):
        arr, lens, srs = read(paths, capacity, **kw)
        lens[1] = -1
        return arr, lens, srs

    monkeypatch.setattr(native, "wav_read_batch", one_fails)
    got = next(iter(TTSLoader(ds, tok, shuffle=False, prefetch=0)))
    np.testing.assert_array_equal(got.waves, want.waves)
    np.testing.assert_array_equal(got.wave_len, want.wave_len)


def _model(root, bone="seperate", postnet=0.0):
    """(config, port and JAX model configs, a seeded port model, the
    attribute table) of `tiny_config` over a small synthetic corpus."""
    config = tiny_config(root, bone=bone)
    config["model"]["asr_postnet_weight"] = postnet
    cfg, attr = PIR.model_config(config)
    model_cfg = dict(config["model"])
    jcfg = JV.config_from_yaml(model_cfg, n_mels=cfg.n_mels, linear_dim=cfg.linear_dim,
                               vocab_size=cfg.vocab_size, n_spkr=cfg.n_spkr,
                               attr_dim=attr.shape[1])
    model = V.VQVAE(cfg, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():  # BatchNorm statistics away from their initial values
        for name, b in model.named_buffers():
            if name.endswith(".mean") or name.endswith(".var"):
                b.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(len(name)))
    return config, cfg, jcfg, model, attr


@pytest.mark.parametrize("bone,postnet", [("seperate", 0.0), ("l2", 0.0), ("l2", 0.3)])
def test_convert_state_dict_holds_against_jax(tmp_path, bone, postnet):
    """The inverse table writes the model as an upstream state_dict; JAX's
    strict `convert_state_dict` consumes every key, each of its leaves
    equals the port's `to_jax_params` leaf bit for bit, and the port's
    conversion gives back the model's own tensors."""
    _, cfg, jcfg, model, attr = _model(str(tmp_path), bone, postnet)
    sd = TI.inverse_state_dict(model.state_dict(), cfg, attr)
    jp, js = j_convert(sd, jcfg, attr, strict=True)
    want_p, want_s = to_jax_params(model)
    for got, want in ((jp, want_p), (js, want_s)):
        got, want = _flatten(jax.tree_util.tree_map(np.asarray, got)), _flatten(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    named = TI.convert_state_dict(sd, cfg, attr)
    own = model.state_dict()
    assert sorted(named) == sorted(own)
    for k, t in own.items():
        assert torch.equal(named[k], t), k


def test_import_reference_checkpoint_forms_and_mismatches(tmp_path):
    """The solver triple keeps its step and drops the optimizer, a bare
    state_dict starts at 0; an extra key, a missing key and a frozen buffer
    that disagrees raise `StateDictMismatch` (an extra key passes with
    ``strict=False``)."""
    _, cfg, _, model, attr = _model(str(tmp_path))
    sd = TI.inverse_state_dict(model.state_dict(), cfg, attr)
    torch.save({"model": sd, "optimizer": {"state": {}}, "global_step": 1234}, tmp_path / "t.pth")
    torch.save(sd, tmp_path / "sd.pth")
    triple = TI.import_reference_checkpoint(tmp_path / "t.pth", cfg, attr)
    bare = TI.import_reference_checkpoint(tmp_path / "sd.pth", cfg, attr)
    assert (triple["global_step"], triple["optimizer"], bare["global_step"]) == (1234, None, 0)
    want = _flatten(to_jax_params(model)[0])
    got = _flatten(triple["model"])
    assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)
    with pytest.raises(TI.StateDictMismatch, match="unconsumed.*extra.weight"):
        TI.convert_state_dict({**sd, "extra.weight": torch.zeros(2)}, cfg)
    assert len(TI.convert_state_dict({**sd, "extra.weight": torch.zeros(2)}, cfg,
                                     strict=False)) == len(model.state_dict())
    missing = {k: v for k, v in sd.items() if k != "tts.decoder.gate_layer.linear.bias"}
    with pytest.raises(TI.StateDictMismatch, match="missing 'tts.decoder.gate_layer.linear.bias'"):
        TI.convert_state_dict(missing, cfg)
    with pytest.raises(TI.StateDictMismatch, match="phn_attr"):
        TI.convert_state_dict(sd, cfg, attr + 1.0)
    with pytest.raises(TI.StateDictMismatch, match="temp"):
        TI.convert_state_dict({**sd, "codebook.temp": torch.tensor([2.0])}, cfg)


def test_import_tool_matches_the_jax_tool(tmp_path):
    """``python -m semi_tts_tpu_torch.util_cli.import_reference_ckpt`` and
    the JAX package's tool write the same checkpoint from one upstream
    file, which the port's loader reads back to the model's weights."""
    config, cfg, _, model, attr = _model(str(tmp_path))
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    sd = TI.inverse_state_dict(model.state_dict(), cfg, attr)
    torch.save({"model": sd, "global_step": 77}, tmp_path / "up.pth")
    args = ["--config", str(cfg_path), "--torch-ckpt", str(tmp_path / "up.pth")]
    PIR.main(args + ["--output", str(tmp_path / "p" / "ckpt.pth")])
    JIR.main(args + ["--output", str(tmp_path / "j" / "ckpt.pth")])
    got = load_checkpoint(str(tmp_path / "p" / "ckpt.pth"))
    want = j_load_checkpoint(str(tmp_path / "j" / "ckpt.pth"))
    assert got["global_step"] == want["global_step"] == 77 and got["optimizer"] is None
    for part in ("model", "state"):
        g, w = _flatten(got[part]), _flatten(want[part])
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    own = _flatten(to_jax_params(model)[0])
    assert all(np.array_equal(_flatten(got["model"])[k], v) for k, v in own.items())


def _jax_phase_chain(shapes):
    """The phases the JAX tool draws for batches of ``shapes``, in order."""
    rng, out = jax.random.PRNGKey(0), []
    for shape in shapes:
        rng, k = jax.random.split(rng)
        out.append(np.array(jax.random.uniform(k, shape, minval=-jnp.pi, maxval=jnp.pi)))
    return out


def test_gen_wav_tool_matches_the_jax_tool(tmp_path, monkeypatch):
    """Both vocoders group the same files into the same batches and, given
    the JAX tool's phases, write the same waves (16-bit, within 1e-4 plus
    two steps of the quantizer: Griffin-Lim's fp32 differences, ~4e-6,
    through the inverse pre-emphasis)."""
    config = tiny_config(str(tmp_path / "corpus"))
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    spec_dir = tmp_path / "specs"
    spec_dir.mkdir()
    rng = np.random.RandomState(0)
    for name, T in [("LJ010-0057", 30), ("b", 30), ("c", 41), ("LJ009-0213", 30)]:
        np.save(spec_dir / f"{name}-spec.npy",
                rng.rand(T, config["data"]["audio"]["num_freq"]).astype(np.float32))
    assert [[os.path.basename(p) for p in paths] for paths, _ in PGW.batches(str(spec_dir), 2)] \
        == [["LJ009-0213-spec.npy", "LJ010-0057-spec.npy"], ["b-spec.npy"], ["c-spec.npy"]]
    assert [len(p) for p, _ in PGW.batches(str(spec_dir), 2, sample=True)] == [2]
    (spec_dir / "c-spec.npy").unlink()  # one batch shape (2, 30): one JAX compile
    np.save(spec_dir / "d-spec.npy", np.load(spec_dir / "b-spec.npy")[::-1])
    todo = PGW.batches(str(spec_dir), 2)
    chain = iter(_jax_phase_chain([s.shape for _, s in todo]))
    monkeypatch.setattr(PGL, "random_phases", lambda *a: torch.from_numpy(next(chain)))
    flags = ["--config", str(cfg_path), "--specgram-dir", str(spec_dir), "--batch", "2", "--cpu"]
    assert PGW.main(flags + ["--output-dir", str(tmp_path / "p")]) == 4
    JGW.run(JGW_parser().parse_args(flags + ["--output-dir", str(tmp_path / "j")]))
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == names and len(names) == 4
    for n in names:
        (got, sr), (want, j_sr) = wavio.read(tmp_path / "p" / n), wavio.read(tmp_path / "j" / n)
        assert sr == j_sr == 22050 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 + 2 / 32768)


def JGW_parser():
    """The JAX tool's flags (its parser is built under ``__main__``)."""
    import argparse

    p = argparse.ArgumentParser()
    for flag in ("--config", "--specgram-dir", "--output-dir"):
        p.add_argument(flag, type=str, required=True)
    p.add_argument("--sample", action="store_true")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--cpu", action="store_true")
    return p
