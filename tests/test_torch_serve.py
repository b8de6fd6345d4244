"""The port's serving path (`semi_tts_tpu_torch/serve.py`) against
`semi_tts_tpu.serve` on one checkpoint written by the JAX package, plus the
weight bridge, the device policy and the port's import boundary."""

from __future__ import annotations

import ast
import copy
import importlib.util
import json
import os
import threading
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from helpers import REPO
from semi_tts_tpu import serve as JS
from semi_tts_tpu.models import asr as JA
from semi_tts_tpu.models import embed as JB
from semi_tts_tpu.models import tts as JT
from semi_tts_tpu.models import vqvae as JV
from semi_tts_tpu.train.checkpoint import save_checkpoint
from semi_tts_tpu.utils.metrics import read_phn_attr
from semi_tts_tpu_torch import bridge
from semi_tts_tpu_torch import serve as PS
from semi_tts_tpu_torch.models import vqvae as PV
from semi_tts_tpu_torch.models.common import Linear, prenet
from test_torch_models import MODEL

AUDIO = {"num_freq": 257, "num_mels": 20, "frame_length_ms": 20, "frame_shift_ms": 10,
         "preemphasis_coeff": 0.97, "sample_rate": 22050, "use_linear": True,
         "snr_range": [10, 100], "time_stretch_range": [0.9, 1.1]}


def jax_tts_tree(cfg, phn_attr, seed=0):
    """A JAX ``vqvae_init`` tree from the JAX init functions (jitted: eager
    init compiles every draw separately): the text->speech part, plus the
    ``asr`` subtree every checkpoint carries."""

    def init(key):
        k_cb, k_spk, k_tts = jax.random.split(key, 3)
        tts_p, tts_s = JT.tts_init(k_tts, cfg.tts)
        asr_p, asr_s = JA.asr_init(jax.random.fold_in(key, 1), cfg.encoder)
        params = {"asr": asr_p,
                  "codebook": JB.codebook_init(k_cb, cfg.codebook, jnp.asarray(phn_attr)),
                  "spkr_embed": jax.random.normal(k_spk, (cfg.n_spkr, cfg.spkr_latent_dim)),
                  "tts": tts_p}
        return params, {"asr": asr_s, "tts": tts_s}

    return jax.tree_util.tree_map(np.asarray, jax.jit(init)(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A checkpoint written by the JAX package, loaded by both servers."""
    root = str(tmp_path_factory.mktemp("torch_serve"))
    spkr_map = join(root, "spkr.json")
    with open(spkr_map, "w") as f:
        json.dump({"p001": 0, "p002": 1, "lj": 2}, f)
    config = {"data": {"corpus": {"vocab_file": join(REPO, "data/cmu_phn.vocab"),
                                  "spkr_map": spkr_map},
                       "audio": dict(AUDIO)},
              "model": copy.deepcopy(MODEL)}
    phn_attr = read_phn_attr(MODEL["codebook"]["phn_attr_pth"])
    cfg = JV.config_from_yaml(MODEL, n_mels=20, linear_dim=257, vocab_size=43, n_spkr=3,
                              attr_dim=phn_attr.shape[1])
    params, state = jax_tts_tree(cfg, phn_attr)
    ckpt = join(root, "best_tts_loss.pth")
    save_checkpoint(ckpt, params=params, state=state, opt_state={"empty": np.zeros(1)}, step=7)
    jserver = JS.TTSServer.from_checkpoint(config, ckpt)
    pserver = PS.TTSServer.from_checkpoint(config, ckpt, device="cpu")
    return config, ckpt, params, state, jserver, pserver


def _requests(B=2, U=9, seed=0):
    rng = np.random.RandomState(seed)
    text = np.zeros((B, U), np.int32)
    for b in range(B):
        n = rng.randint(4, U - 1)
        text[b, :n] = rng.randint(3, 43, size=n)
    return text, rng.randint(0, 3, size=B).astype(np.int32)


def test_serving_stages_match_jax(served):
    """Same checkpoint, prenet dropout 0: the synthesis amplitude agrees at
    1e-4; the vocoder waveform, given JAX's phase draw, at 1e-3 (30 rounds
    that divide by |z|, then the 33x-gain inverse pre-emphasis)."""
    _, _, _, _, jserver, pserver = served
    text, sid = _requests()
    steps = jserver.decode_steps_for(text)
    jsynth, jvocode = jserver.stages(steps)
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    amp_j = jsynth(jserver.params, jserver.state, jnp.asarray(text), jnp.asarray(sid), k1)
    wav_j = np.asarray(jvocode(amp_j, k2))
    psynth, _ = pserver.stages(steps, *text.shape)
    t, s = pserver._place(text, sid)
    amp_p = psynth(t, s, seed=0)
    assert tuple(amp_p.shape) == (2, steps * 3, 257)
    np.testing.assert_allclose(amp_p.numpy(), np.asarray(amp_j), rtol=0, atol=1e-4)
    phases = np.array(jax.random.uniform(k2, amp_j.shape, minval=-jnp.pi, maxval=jnp.pi))
    _, pvocode = PS.serving_stages(pserver.cfg, pserver.audio, pserver.phn_attr, steps)
    wav_p = pvocode(amp_p, phases=torch.from_numpy(phases)).numpy()
    assert wav_p.shape == wav_j.shape == (2, 220 * (steps * 3 - 1))
    np.testing.assert_allclose(wav_p, wav_j, rtol=0, atol=1e-3)


def test_decode_steps_for_matches_jax(served):
    *_, jserver, pserver = served
    for U in (1, 5, 9, 31, 64):
        for seed in range(3):
            text, _ = _requests(B=3, U=max(U, 6), seed=seed)
            text = text[:, :U]
            assert pserver.decode_steps_for(text) == jserver.decode_steps_for(text)
    assert pserver.decode_steps_for(np.zeros((2, 9), np.int32)) == \
        jserver.decode_steps_for(np.zeros((2, 9), np.int32))


def test_synthesize_full_matches_jax(served):
    *_, jserver, pserver = served
    text, sid = _requests(seed=1)
    want = jserver.synthesize_full(text, sid, jax.random.PRNGKey(2))
    got = pserver.synthesize_full(text, sid, key=2)
    for name in ("wav", "mel", "linear"):
        assert got[name].shape == want[name].shape, name
    np.testing.assert_allclose(got["mel"], want["mel"], rtol=0, atol=1e-4)
    for a, b in zip(got["align"], want["align"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    assert np.isfinite(got["wav"]).all() and np.abs(got["wav"]).max() <= 1.0
    again = pserver.synthesize(text, sid, key=2)
    np.testing.assert_array_equal(again, got["wav"])  # same key, same request result


def test_serving_adversarial_inputs(served):
    """The twin of the JAX package's `tests/test_serve.py`
    `test_serving_adversarial_inputs` (its mesh case left out: the port
    runs on one device): all-pad text, U=1 and B=1 give finite audio of
    JAX's shape; the decode budget lands on a step-bucket multiple, at least
    the raw need, and equals JAX's for U = 1..63; decode_steps 0 and -1
    raise ValueError on both servers."""
    *_, jserver, pserver = served
    pad_text, sid = np.zeros((2, 9), np.int32), np.zeros(2, np.int32)
    steps = pserver.decode_steps_for(pad_text)
    assert steps >= 1 and steps % pserver.step_bucket == 0
    assert steps == jserver.decode_steps_for(pad_text)
    one = np.full((1, 1), 5, np.int32)
    for text, s in ((pad_text, sid), (one, sid[:1])):
        want = jserver.synthesize(text, s, jax.random.PRNGKey(0), decode_steps=4)
        got = pserver.synthesize(text, s, key=0, decode_steps=4)
        assert got.shape == want.shape and got.shape[0] == text.shape[0]
        assert np.isfinite(got).all() and np.abs(got).max() <= 1.0

    r, b = pserver.cfg.n_frames_per_step, pserver.step_bucket
    for U in range(1, 64):
        need = (int((U + 1) * PV.FRAME_PHN_RATIO) + 40 + r - 1) // r
        t = np.full((1, U), 5, np.int32)
        got = pserver.decode_steps_for(t)
        assert got % b == 0 and got >= need and got == jserver.decode_steps_for(t)

    text, s = _requests()
    for bad in (0, -1):
        with pytest.raises(ValueError, match="decode_steps"):
            pserver.synthesize(text, s, decode_steps=bad)
        with pytest.raises(ValueError, match="decode_steps"):
            jserver.synthesize(text, s, decode_steps=bad)


def test_bridge_round_trip_is_exact(served):
    _, _, params, state, _, pserver = served
    model = PV.VQVAE(pserver.cfg, generator=torch.Generator())  # the serving model
    p2, s2 = bridge.to_jax_params(bridge.load_jax_params(model, params, state))
    assert jax.tree_util.tree_structure(p2) == jax.tree_util.tree_structure(params)
    assert jax.tree_util.tree_structure(s2) == jax.tree_util.tree_structure(state)
    for got, want in zip(jax.tree_util.tree_leaves((p2, s2)), jax.tree_util.tree_leaves((params, state))):
        assert got.dtype == np.float32 and got.shape == np.shape(want)
        np.testing.assert_array_equal(got, want)


def test_bridge_rejects_missing_and_misshaped_leaves(served):
    _, _, params, state, _, pserver = served
    model = PV.VQVAE(pserver.cfg, generator=torch.Generator())
    bad = copy.deepcopy(params)
    del bad["tts"]["decoder"]["gate"]["b"]
    with pytest.raises(KeyError, match="gate/b"):
        bridge.load_jax_params(model, bad, state)
    bad = copy.deepcopy(params)
    bad["spkr_embed"] = bad["spkr_embed"][:2]
    with pytest.raises(ValueError, match="spkr_embed"):
        bridge.load_jax_params(model, bad, state)
    bad = copy.deepcopy(params)
    bad["tts"]["extra"] = np.zeros(2, np.float32)
    with pytest.raises(KeyError, match="no port counterpart"):
        bridge.load_jax_params(model, bad, state)


def test_text_encoder_and_phn_attr_copies_match_jax(tmp_path):
    """The port's pandas-free copies read the same files as the JAX package."""
    from semi_tts_tpu.data.text import load_text_encoder as j_load
    from semi_tts_tpu_torch.data.text import load_text_encoder as p_load
    from semi_tts_tpu_torch.utils.metrics import read_phn_attr as p_read

    table = tmp_path / "map.csv"
    table.write_text("\tphn_seq\tspkr\np001_000\taa b ch\tp001\nlj_001\tiy  k\tlj\n")
    vocab = join(REPO, "data/cmu_phn.vocab")
    j, p = j_load("phoneme", vocab, str(table)), p_load("phoneme", vocab, str(table))
    assert p.vocab_size == j.vocab_size == 43
    for fid in ("p001_000.wav", "lj_001"):
        assert p.file_to_seq(fid) == j.file_to_seq(fid)
        assert p.file_to_spkr(fid) == j.file_to_spkr(fid)
    assert p.encode("aa  iy ") == j.encode("aa  iy ")
    path = join(REPO, "data/phn_attr.csv")
    np.testing.assert_array_equal(p_read(path), read_phn_attr(path))
    np.testing.assert_array_equal(p_read(path, neg_val=-1), read_phn_attr(path, neg_val=-1))


def test_prenet_dropout_stays_on_at_half():
    """Prenet dropout is always on: at rate 0.5 about half of the units are
    kept, each scaled by 2. Statistical, since the RNG streams differ from
    JAX's."""
    layer = Linear(8, 64, bias=False, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.w.abs_()
        x = torch.rand(256, 8, generator=torch.Generator().manual_seed(1)) + 0.1
        y = x @ layer.w.T
        out = prenet(torch.nn.ModuleList([layer]), x, 0.5,
                     generator=torch.Generator().manual_seed(2))
    kept = out != 0
    assert 0.47 < kept.float().mean().item() < 0.53
    torch.testing.assert_close(out[kept], 2.0 * y[kept], rtol=0, atol=0)


def test_server_without_device_raises_on_cpu_host(served):
    config, ckpt, *_, pserver = served
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.TTSServer(pserver.cfg, pserver.audio, None, pserver.model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.TTSServer.from_checkpoint(config, ckpt)


def test_key_counter_thread_safety(served):
    """Concurrent key-less requests never share a generator seed."""
    *_, pserver = served
    seeds, lock = [], threading.Lock()
    barrier = threading.Barrier(8)

    def worker():
        barrier.wait()
        got = [pserver._key() for _ in range(50)]
        with lock:
            seeds.extend(got)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(set(seeds)) == len(seeds) == 400


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_flagship_config_equals_yaml():
    with open(join(REPO, "config/semi-multi-spkr-paired-data.yaml")) as f:
        ycfg = yaml.safe_load(f)
    smoke = _load_chip_smoke()
    assert smoke.FLAGSHIP_MODEL == ycfg["model"]
    assert smoke.FLAGSHIP_AUDIO == ycfg["data"]["audio"]


FORBIDDEN = {"jax", "jaxlib", "semi_tts_tpu", "pandas"}


def _port_files():
    pkg = join(REPO, "semi_tts_tpu_torch")
    for dirpath, _, names in os.walk(pkg):
        for n in names:
            if n.endswith(".py"):
                yield join(dirpath, n)
    yield join(REPO, "chip_smoke.py")


def _imports(tree):
    """(top-level module name, enclosing function names) of every absolute import."""
    out = []

    def visit(node, funcs):
        for child in ast.iter_child_nodes(node):
            inner = funcs + [child.name] if isinstance(child, (ast.FunctionDef,
                                                               ast.AsyncFunctionDef)) else funcs
            if isinstance(child, ast.Import):
                out.extend((a.name.split(".")[0], funcs) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.module.split(".")[0], funcs))
            visit(child, inner)

    visit(tree, [])
    return out


def test_port_imports_no_jax_pandas_or_module_level_yaml():
    files = list(_port_files())
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for name, funcs in _imports(tree):
            assert name not in FORBIDDEN, f"{path} imports {name}"
            if name == "yaml":
                # read where a YAML config is: the server's checkpoint loader, the CLI's main
                where = ["main"] if path.endswith("__main__.py") else ["from_checkpoint"]
                assert funcs == where, f"{path} imports yaml outside {where[0]}"
