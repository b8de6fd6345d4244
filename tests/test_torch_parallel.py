"""The port's meshes (`semi_tts_tpu_torch/parallel`, the steps, trainers and
server on a mesh) in gloo worlds of spawned CPU processes
(`torch_mesh_jobs.run_world`, each world joined with a deadline that kills
its ranks and fails): mesh shapes and wrong sizes, the spec tree against
JAX's `vqvae_param_specs`, `shard_batch`, BatchNorm synced over two ranks,
the speech-first step on 2x1 against the JAX package's single-device step
and on 2x2 against the port's single process, the paired step on 2x1,
loader sharding, the CLI with ``--mesh 2x1`` and `TTSServer(mesh=)` on 2x1
and 1x2 against the single server. Twins of `tests/test_parallel.py` and
the mesh cases of `tests/test_serve.py`."""

from __future__ import annotations

import copy
import itertools
import os
from os.path import basename, join

import jax
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import PartitionSpec as P

import torch_mesh_jobs as J
from helpers import make_paras, make_synthetic_corpus, tiny_config
from semi_tts_tpu.parallel.sharding import vqvae_param_specs as jax_specs
from semi_tts_tpu_torch import bridge
from semi_tts_tpu_torch.data import load_dataset
from semi_tts_tpu_torch.data.loader import Batch
from semi_tts_tpu_torch.models import vqvae as PV
from semi_tts_tpu_torch.models.common import BatchNorm, batchnorm
from semi_tts_tpu_torch.parallel import sharding as PSH
from semi_tts_tpu_torch.parallel.mesh import Mesh, shard_batch
from semi_tts_tpu_torch.serve import TTSServer
from semi_tts_tpu_torch.ops.features import AudioConfig
from semi_tts_tpu_torch.train.checkpoint import load_checkpoint
from semi_tts_tpu_torch.train.train_vqvae import VqvaeSolver
from semi_tts_tpu_torch.utils.metrics import read_phn_attr
from test_torch_features import CFG
from test_torch_models import MODEL
from test_torch_train_cycles import (LOSSES, W, _augment, _batches, _check_step, _run_pair,
                                     setup)  # noqa: F401 (the JAX steps' fixture)
from test_torch_train_paired import (ATOL, FLOSS, GNORM_RTOL, GRAD_RTOL, LOSS_RTOL,
                                     UPDATE_RTOL, ZERO_GRAD_TOL, _flat, _zero_grad)

SPEECH_STEPS, PAIRED_STEPS = (2, 4), (1, 3)
# each rank's batch shapes, step by step: a shape is captured at its second
# call, so rank 0 captures at steps 2 and 4, rank 1 at steps 3 and 4
CAPTURE_SHAPES = ("AABBA", "BABAA")
B1, B2, CLIP = 0.9, 0.999, 5.0  # Adam's moment decays, the clip norm


# ---------------- cases and worlds ----------------

def _step_case(setup, kind, steps):
    """The weights, configs and per-step inputs of `_run_pair`'s steps: the
    batches of `_batches` and the augmentation JAX draws from its keys."""
    out = []
    for i, step_no in enumerate(steps):
        pair, unpair = _batches(i)
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(5), step_no),
                                4 if kind == "speech" else 3)
        host = lambda a: tuple(v.numpy() if isinstance(v, torch.Tensor) else v for v in a)
        out.append(dict(step_no=step_no, pair=pair, unpair=unpair,
                        augment=host(_augment(keys[0], pair[0])),
                        u_augment=host(_augment(keys[1], unpair[0]))))
    return dict(pcfg=setup["pcfg"], params=setup["params"], state=setup["state"],
                phn_attr=setup["phn_attr"], audio=CFG, floss=FLOSS, weights=W, steps=out)


def _serve_case():
    """The tiny VQVAE with prenet dropout on (its masks are drawn rows
    first), requests of 4 rows (split), 1 and 3 (whole on every rank)."""
    model = copy.deepcopy(MODEL)
    model["decoder"]["decoder"]["prenet_dropout"] = 0.5
    phn_attr = read_phn_attr(MODEL["codebook"]["phn_attr_pth"])
    pcfg = PV.config_from_yaml(model, n_mels=20, linear_dim=257, vocab_size=43, n_spkr=3,
                               attr_dim=phn_attr.shape[1])
    rng = np.random.RandomState(0)
    requests = {}
    for B in (4, 1, 3):
        text = np.zeros((B, 9), np.int32)
        for b in range(B):
            n = rng.randint(4, 8)
            text[b, :n] = rng.randint(3, 43, size=n)
        requests[f"B{B}"] = (text, rng.randint(0, 3, size=B).astype(np.int32))
    return dict(pcfg=pcfg, phn_attr=phn_attr, audio=CFG, seed=3, requests=requests,
                decode_steps=6)


def _cli_case(root):
    """A corpus of 8 paired and 8 unpaired utterances (4 batches each a
    pass), the tiny config with the speech cycle on, ``--store-best-per``
    (one checkpoint file), and the argument lists of a run and of a mesh
    larger than the world."""
    cfg = tiny_config(root, unpair_speech=10.0, max_step=3, valid_step=3)
    cfg["data"]["corpus"] = make_synthetic_corpus(root, n_per_split=(8, 8, 2, 2))
    path = join(root, "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    args = ["--cpu", "--no-msg", "--config", path, "--logdir", join(root, "log"),
            "--ckpdir", join(root, "ckpt")]
    return dict(config=cfg, path=path, root=root,
                argv=args + ["--mesh", "2x1", "--store-best-per"],
                bad=args + ["--mesh", "4x2"])


@pytest.fixture(scope="module")
def world2(setup, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh2"))
    c = dict(speech=_step_case(setup, "speech", SPEECH_STEPS),
             paired=_step_case(setup, "paired", PAIRED_STEPS),
             x=np.random.RandomState(0).randn(4, 7, 5).astype(np.float32) * 2 + 1,
             serve=_serve_case(), cli=_cli_case(root))
    jobs = [("speech", "job_step", (c["speech"], "speech", 1)),
            ("paired", "job_step", (c["paired"], "paired", 1)),
            ("bn", "job_batchnorm", (c["x"],)), ("serve", "job_servers", (c["serve"],)),
            ("capture", "job_capture", (c["paired"], CAPTURE_SHAPES)),
            ("cli", "job_cli", (c["cli"]["argv"], c["cli"]["bad"]))]
    c["ranks"] = J.run_world(2, J.job_world2, join(root, "world"), jobs)
    return c


@pytest.fixture(scope="module")
def world4(setup, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh4"))
    case = _step_case(setup, "speech", SPEECH_STEPS)
    return case, J.run_world(4, J.job_world4, root, case)


# ---------------- mesh shapes ----------------

def test_make_mesh_shapes(world4):
    """4 ranks as 2x2 and 4x1: rank ``d * M + m``, its data group the ranks
    of its model coordinate, its model group those of its data one."""
    _, ranks = world4
    for r, res in enumerate(ranks):
        shape, d, m, data, model = res["shapes"][2]
        assert shape == {"data": 2, "model": 2} and (d, m) == divmod(r, 2)
        assert data == [m, m + 2] and model == [2 * d, 2 * d + 1]
        shape, d, m, data, model = res["shapes"][1]
        assert shape == {"data": 4, "model": 1} and (d, m) == (r, 0)
        assert data == [0, 1, 2, 3] and model == [r]


def test_make_mesh_of_the_wrong_size_raises(world4):
    for res in world4[1]:
        errors = res["errors"]
        assert "a mesh of 8 ranks in a world of 4" in errors[0]
        assert "model_parallel=3 does not divide 4" in errors[1]
        assert "--mesh 4x2 needs 8 devices, only 4 visible" in errors[2]


# ---------------- specs and placement ----------------

def _tiny_model(setup):
    return bridge.load_jax_params(PV.VQVAE(setup["pcfg"], generator=torch.Generator()),
                                  setup["params"], setup["state"])


def test_spec_tree_covers_every_parameter_and_equals_jax(setup):
    """Every parameter has a spec, and each equals JAX's `vqvae_param_specs`
    leaf at the bridge's name (``P("model", None)`` as ``("model", None)``)."""
    port = _tiny_model(setup)
    specs = PSH.vqvae_param_specs(port)
    assert set(specs) == {n for n, _ in port.named_parameters()}
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        jax_specs(setup["params"]), is_leaf=lambda x: isinstance(x, P))
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(spec)
            for path, spec in leaves}
    assert want == specs
    assert specs["tts.decoder.query_rnn.w_hh"] == ("model", None)
    assert specs["tts.decoder.proj.b"] == ("model",)
    assert specs["tts.decoder.attn.v.w"] == () and specs["codebook.learnable_table"] == ()


def test_place_params_falls_back_to_whole(setup):
    port = _tiny_model(setup)
    placed = PSH.place_params(port, Mesh(4, 2))
    assert placed["tts.decoder.query_rnn.w_ih"] == ("model", None)
    assert placed["asr.rnn.0.fwd.b_hh"] == ("model",)
    assert placed["tts.postnet.linear.w"] == ()  # 257 rows: odd
    assert placed["spkr_embed"] == ()
    assert all(s == () for s in PSH.place_params(port, Mesh(1, 7)).values())  # 7 divides none
    with pytest.raises(KeyError):
        PSH.place_params(port, Mesh(2, 2), {"spkr_embed": ()})


def test_shard_batch_ragged_tail_replicates():
    """Rows ``[d*b:(d+1)*b]`` of a batch the data axis divides; a ragged one
    whole (JAX replicates it); the loader's Batch type and its other leaves
    kept."""
    even = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    ragged = np.zeros((6, 3), np.float32)
    for rank in range(8):
        mesh = Mesh(4, 2, rank=rank)
        out = shard_batch(Batch(x=even, y=torch.from_numpy(ragged), fids=["a", "b"]), mesh)
        d = rank // 2
        assert type(out) is Batch and out.fids == ["a", "b"]
        np.testing.assert_array_equal(out.x, even[2 * d:2 * d + 2])
        assert tuple(out.y.shape) == (6, 3)
    np.testing.assert_array_equal(shard_batch((even,), Mesh(1, 2, rank=1))[0], even)


# ---------------- BatchNorm ----------------

def test_batchnorm_synced_over_two_ranks_equals_whole_batch(world2):
    """Train-mode BatchNorm on each rank's 2 of 4 rows, synced over the data
    group: the output rows, the gradient of a weighted sum and the running
    statistics equal BatchNorm on the whole batch."""
    x = world2["x"]
    bn = BatchNorm(x.shape[-1])
    xt = torch.from_numpy(x).requires_grad_(True)
    y = batchnorm(bn, xt, train=True)
    (y * torch.linspace(-1.0, 1.0, x.size).reshape(x.shape)).sum().backward()
    for d, ranks in enumerate(world2["ranks"]):
        got = ranks["bn"]
        np.testing.assert_allclose(got["y"], y.detach().numpy()[2 * d:2 * d + 2], atol=1e-5)
        np.testing.assert_allclose(got["grad"], xt.grad.numpy()[2 * d:2 * d + 2], atol=1e-6)
        np.testing.assert_allclose(got["mean"], bn.mean.numpy(), atol=1e-6)
        np.testing.assert_allclose(got["var"], bn.var.numpy(), rtol=1e-6, atol=1e-6)


# ---------------- train steps ----------------

def _same_step(got, want, n_done, what):
    """One step of a mesh against the single process: the losses and the
    norm, every reduced gradient, parameter, BN statistic and Adam moment."""
    for k in LOSSES:
        rtol = GNORM_RTOL if k == "grad_norm" else LOSS_RTOL
        np.testing.assert_allclose(got["mets"][k], want["mets"][k], rtol=rtol,
                                   err_msg=f"{what} {k}")
    paths = [n.replace(".", "/") for n in want["placement"]]
    gmax = max(np.abs(g).max() for g in want["grads"])
    for path, g, w in zip(paths, got["grads"], want["grads"]):
        if _zero_grad(path):
            assert max(np.abs(g).max(), np.abs(w).max()) <= ZERO_GRAD_TOL * gmax, path
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * np.abs(w).max(),
                                       err_msg=f"{what} grad {path}")
    lr = 1e-6 * n_done
    got_p, want_p = _flat(got["params"]), _flat(want["params"])
    for path, p in got_p.items():
        tol = ATOL if _zero_grad(path) else (UPDATE_RTOL * lr
                                             + n_done * np.spacing(np.abs(want_p[path]).max()))
        np.testing.assert_allclose(p, want_p[path], rtol=0, atol=tol,
                                   err_msg=f"{what} param {path}")
    got_s, want_s = _flat(got["state"]), _flat(want["state"])
    for path, s in got_s.items():
        np.testing.assert_allclose(s, want_s[path], rtol=0, atol=ATOL,
                                   err_msg=f"{what} state {path}")
    for name, m in want["moments"].items():
        np.testing.assert_allclose(got["moments"][name], m, rtol=0,
                                   atol=GRAD_RTOL * np.abs(m).max(), err_msg=f"{what} {name}")


def test_speech_first_step_on_2x1_matches_jax(setup, world2):
    """Two speech-first steps on 2x1 (a paired and an unpaired row a rank,
    every dropout 0, ``augment=``/``u_augment=`` each rank's rows of JAX's
    draws) against the JAX package's single-device step on the whole batch:
    the losses, every merged gradient (reduced over the data group), every
    parameter and BN statistic after the step, within
    `test_torch_train_cycles`' tolerances; Adam's moments against the ones
    JAX's clipped gradients give; both ranks alike."""
    ranks = [r["speech"] for r in world2["ranks"]]
    mu = nu = 0.0
    for n, (step_no, want, want_g, _, _, _, want_p, want_s) in enumerate(
            _run_pair(setup, "speech", SPEECH_STEPS), 1):
        got = ranks[0][n - 1]
        port = bridge.load_jax_params(PV.VQVAE(setup["pcfg"], generator=torch.Generator()),
                                      got["params"], got["state"])
        assert got["mets"]["unpair_ok"] == 1.0
        _check_step(setup, step_no, want, want_g, got["mets"],
                    [torch.from_numpy(g) for g in got["grads"]], port, want_p, want_s, n,
                    LOSSES + ("unpair_speech_loss",))
        g = np.concatenate([want_g[name.replace(".", "/")].reshape(-1)
                            for name in got["placement"]])
        g = g * min(1.0, CLIP / float(want["grad_norm"]))
        mu, nu = B1 * mu + (1 - B1) * g, B2 * nu + (1 - B2) * g * g
        for name, m in (("mu", mu), ("nu", nu)):
            np.testing.assert_allclose(got["moments"][name], m, rtol=0,
                                       atol=GRAD_RTOL * np.abs(m).max(),
                                       err_msg=f"step {step_no} {name}")
        for other in ranks[1:]:
            for path, p in _flat(other[n - 1]["params"]).items():
                np.testing.assert_array_equal(p, _flat(got["params"])[path], err_msg=path)


def test_speech_first_step_on_2x2_matches_single_process(world4):
    """The speech-first steps on 2x2: the data group splits the rows, the
    model group splits the moments of the wide leaves (each rank keeps
    fewer moments than a whole set) and gathers them whole; against the
    port's single process on the whole batch."""
    case, ranks = world4
    want = J.job_step(case, "speech", 1)  # a world of one process: no collective
    total = sum(int(np.prod(np.shape(g))) for g in want[0]["grads"])
    for r, res in enumerate(ranks):
        for n, (got, w) in enumerate(zip(res["step"], want), 1):
            assert got["own"] < total == w["own"]
            _same_step(got, w, n, f"rank {r} step {n}")


def test_paired_step_on_2x1_matches_single_process(world2):
    want = J.job_step(world2["paired"], "paired", 1)
    for r, ranks in enumerate(world2["ranks"]):
        for n, (got, w) in enumerate(zip(ranks["paired"], want), 1):
            _same_step(got, w, n, f"rank {r} step {n}")


def test_ranks_capturing_at_different_steps_pair_their_collectives(world2):
    """Each rank captures its own shapes when it sees them the second time;
    a capturing call runs the step once, as an eager call or a replay
    does, so every rank issues the same all-reduces at every step and the
    ranks' weights stay equal."""
    r0, r1 = (ranks["capture"] for ranks in world2["ranks"])
    assert [c for _, c in r0["steps"]] == [0, 1, 0, 1, 0]
    assert [c for _, c in r1["steps"]] == [0, 0, 1, 1, 0]
    issued = [n for n, _ in r0["steps"]]
    assert issued == [n for n, _ in r1["steps"]]
    assert len(set(issued)) == 1 and issued[0] > 0
    for a, b in zip(r0["params"], r1["params"]):
        np.testing.assert_array_equal(a, b)


# ---------------- loaders and the CLI ----------------

def _stream(loader, n):
    """The first ``n`` item batches (file ids) of ``loader``'s passes."""
    def passes():
        while True:
            for items in loader._sharded_batches():
                yield [basename(str(p)).split(".")[0] for p, _ in items]
    return list(itertools.islice(passes(), n))


def test_loader_shards_train_batches_and_not_dev(tmp_path):
    """Two shards of the train loaders take every other batch of the
    identically seeded stream: disjoint, together the unsharded stream;
    dev stays whole on every shard, and one process defaults to one shard."""
    root = str(tmp_path)
    cfg = tiny_config(root)
    corpus = make_synthetic_corpus(root, n_per_split=(8, 8, 2, 2))

    def sets(**kw):
        return load_dataset(0, False, False, corpus, cfg["data"]["audio"], seed=3,
                            device="cpu", **kw)

    whole = sets(shard_id=0, num_shards=1)
    shards = [sets(shard_id=s, num_shards=2) for s in (0, 1)]
    assert (whole[1].shard_id, whole[1].num_shards) == (0, 1)
    assert sets()[1].num_shards == 1  # no process group: one shard
    for k in (0, 1):  # unpaired, paired
        full = _stream(whole[k], 8)
        got = [_stream(s[k], 4) for s in shards]
        for p in (0, 2):  # each pass: 2 batches a shard, no utterance in both
            assert set(sum(got[0][p:p + 2], [])).isdisjoint(sum(got[1][p:p + 2], []))
        assert [b for pair in zip(*got) for b in pair] == full
    for s in shards:
        assert s[2].num_shards == 1 and _stream(s[2], 1) == _stream(whole[2], 1)


def test_cli_mesh_2x1_trains_with_sharded_loaders_and_rank0_checkpoints(world2):
    """``--mesh 2x1`` through `__main__.main` on both ranks: 3 steps (the
    last a speech-first cycle), the ranks' train batches disjoint and
    together the unsharded loader's, dev unsharded, one checkpoint, written
    by rank 0 alone, which a single-process `VqvaeSolver` loads."""
    cli = world2["cli"]
    ranks = [r["cli"] for r in world2["ranks"]]
    assert [r["code"] for r in ranks] == [0, 0]
    assert ranks[0]["saved"] and set(ranks[0]["saved"]) == {"best_per.pth"}
    assert ranks[1]["saved"] == []
    ckdir = join(cli["root"], "ckpt", "cfg-sd0")
    assert os.listdir(ckdir) == ["best_per.pth"]
    corpus, audio = cli["config"]["data"]["corpus"], cli["config"]["data"]["audio"]
    whole = load_dataset(0, False, False, corpus, audio, seed=0, device="cpu", shard_id=0,
                         num_shards=1)
    split_of = {}
    for line in open(corpus["partition_table"]).read().splitlines()[1:]:
        fid, _, split, _ = line.split(",")
        split_of[fid] = split
    for k, split in ((0, "unpaired"), (1, "paired")):
        got = [[b for n, s, b in r["batches"] if n == 2 and split_of[b[0]] == split]
               for r in ranks]
        assert all(got) and all(s == r for r, rank in enumerate(ranks)
                                for n, s, b in rank["batches"] if n == 2)
        m = min(map(len, got))
        full = _stream(whole[k], 2 * m)
        assert [b for pair in zip(got[0][:m], got[1][:m]) for b in pair] == full
    dev = [[b for n, _, b in r["batches"] if n == 1] for r in ranks]
    assert dev[0] and dev[0] == dev[1] and all(split_of[b[0]] == "dev" for b in dev[0])
    paras = make_paras(cli["root"], config=cli["path"], load=join(ckdir, "best_per.pth"))
    solver = VqvaeSolver(cli["config"], paras, "train")
    solver.load_data()
    solver.set_model()
    assert solver.step == load_checkpoint(paras.load)["global_step"] >= 1
    assert solver.mesh is None


def test_cli_mesh_larger_than_the_world_exits(world2):
    for r in world2["ranks"]:
        assert r["cli"]["bad_code"] not in (0, None)
        assert "--mesh 4x2 needs 8 devices, only 2 visible" in r["cli"]["bad_err"]


# ---------------- the server ----------------

@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_server_mesh_equals_single_server(world2, shape):
    """`TTSServer(mesh=)` against the single server on the same model and
    keys: a 4-row request (split on 2x1: each rank decodes 2 rows, its
    prenet and Griffin-Lim draws its rows of the whole batch's), and 1 and
    3 rows (whole on every rank); ``synthesize`` and ``synthesize_full``,
    every rank returning the whole batch."""
    case = world2["serve"]
    model = PV.VQVAE(case["pcfg"], generator=torch.Generator().manual_seed(case["seed"]))
    single = TTSServer(case["pcfg"], AudioConfig(**case["audio"]), case["phn_attr"], model,
                       device="cpu")
    for name, (text, sid) in case["requests"].items():
        wav = single.synthesize(text, sid, key=11, decode_steps=case["decode_steps"])
        full = single.synthesize_full(text, sid, key=12, decode_steps=case["decode_steps"])
        for ranks in world2["ranks"]:
            got = ranks["serve"][f"{shape}/{name}"]
            assert got["wav"].shape == wav.shape and wav.shape[0] == text.shape[0]
            for k, want in (("wav", wav), ("full_wav", full["wav"]), ("mel", full["mel"])):
                np.testing.assert_allclose(got[k], want, rtol=0,
                                           atol=1e-5 * max(np.abs(want).max(), 1.0),
                                           err_msg=f"{shape} {name} {k}")
            for a, b in zip(got["align"], full["align"]):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
