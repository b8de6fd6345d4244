"""Base solver (counterpart of `semi_tts_tpu/train/solver.py` `BaseSolver`):
the experiment name and directories, ``[INFO]`` and progress lines,
TensorBoard logging and checkpoints, for the ``load_data -> set_model ->
exec`` lifecycle that `semi_tts_tpu_torch.__main__` drives.

The solver runs on one device: the card, or the CPU with ``paras.cpu``
(`resolve_device`). Loaders yield numpy batches on the host; `to_device`
moves one to the solver's device as the trainers take it.

``--mesh DxM`` (counterpart of the JAX solver's ``_make_mesh``): the
solver runs as one rank of a world of ``D*M`` processes that
`parallel.mesh.init_distributed` joined before (`mesh_from_spec` raises
SystemExit with the JAX solver's message when the world has another size);
its train loaders are sharded over the data axis (`load_kwargs`), so a
batch they give is this rank's rows, and only rank 0 prints, writes
TensorBoard logs and writes checkpoints, which hold the whole state
(`save_checkpoint_triple` gathers what the model axis splits).
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np
import torch

from ..bridge import to_jax_params
from ..device import resolve_device
from ..models import vqvae as V
from ..parallel.mesh import mesh_from_spec, replicate, world
from ..utils.metrics import human_format, read_phn_attr
from ..utils.timer import Timer
from .checkpoint import optimizer_tree, save_checkpoint

TB_FLUSH_FREQ = 180
PRETRAINED = ("pretrained_asr", "pretrained_emb", "pretrained_tts")


def to_device(batch, device):
    """A loader's Batch -> (waves, wave_len, text, sid) tensors on ``device``."""
    return tuple(torch.from_numpy(batch[k]).to(device)
                 for k in ("waves", "wave_len", "text", "sid"))


class DeviceBatches:
    """A loader whose every pass yields its batches moved to ``device``."""

    def __init__(self, loader, device):
        self.loader, self.device = loader, device

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        return (to_device(b, self.device) for b in self.loader)


class BaseSolver:
    def __init__(self, config, paras, mode):
        self._PROGRESS_STEP = 20
        self.config = config
        self.paras = paras
        self.mode = mode
        self.device = resolve_device("cpu" if paras.cpu else None)
        self.mesh = mesh_from_spec(getattr(paras, "mesh", "") or "")
        n_world = world()[1]
        if self.mesh is None and n_world > 1:
            raise SystemExit(f"a world of {n_world} processes needs --mesh DxM (D*M = {n_world})")
        self.is_first = self.mesh is None or self.mesh.is_first

        self.exp_name = paras.name
        if self.exp_name is None:
            self.exp_name = "-".join(
                [os.path.basename(paras.config).replace(".yaml", ""), "sd" + str(paras.seed)])
        os.makedirs(paras.ckpdir, exist_ok=True)
        self.ckpdir = os.path.join(paras.ckpdir, self.exp_name)
        os.makedirs(self.ckpdir, exist_ok=True)
        self.logdir = os.path.join(paras.logdir, self.exp_name)

        self.log = None
        self.step = 0
        if mode == "train":
            try:
                from tensorboardX import SummaryWriter
            except ImportError:  # no TensorBoard logs without tensorboardX
                SummaryWriter = None
            if SummaryWriter is not None and self.is_first:
                self.log = SummaryWriter(self.logdir, flush_secs=TB_FLUSH_FREQ)
            self.timer = Timer()
            self.valid_step = config["hparas"]["valid_step"]
            self.max_step = config["hparas"]["max_step"]

    # ------------- lifecycle (implemented by subclasses) -------------
    def load_data(self):
        raise NotImplementedError

    def set_model(self):
        raise NotImplementedError

    def exec(self):
        raise NotImplementedError

    # ------------- the mesh -------------
    def load_kwargs(self):
        """`load_dataset`'s sharding of the train loaders: this rank's data
        coordinate of the mesh's data axis (ranks of one model group read
        the same batches); unsharded without a mesh."""
        if self.mesh is None:
            return dict(shard_id=0, num_shards=1)
        return dict(shard_id=self.mesh.data_rank, num_shards=self.mesh.shape["data"])

    def has_writer(self) -> bool:
        """Whether rank 0 has a TensorBoard writer (without a mesh, this
        process): on a mesh every rank makes the media logs or none does,
        since making them runs collectives."""
        flag = torch.tensor([float(self.log is not None)], device=self.device)
        return bool(replicate([flag], self.mesh)[0].item())

    # ------------- shared set-up -------------
    def data_dims(self):
        """n_mels, linear_dim, vocab_size and n_spkr of the config and the
        tokenizer (after `load_data`)."""
        audio = self.config["data"]["audio"]
        self.n_mels = audio["num_mels"]
        self.linear_dim = audio["num_freq"] if audio["use_linear"] else None
        self.vocab_size = self.tokenizer.vocab_size
        with open(self.config["data"]["corpus"]["spkr_map"]) as f:
            self.n_spkr = len(json.load(f))

    def model_config(self):
        """The VQVAEConfig of the YAML ``model`` block and the phonological
        attribute table on the device (None without one). The block's
        ``pretrained_*`` paths are not part of it (`VqvaeSolver` grafts
        them)."""
        model_cfg = dict(self.config["model"])
        for k in PRETRAINED:
            model_cfg.pop(k, None)
        phn_attr_pth = model_cfg["codebook"].get("phn_attr_pth") or ""
        phn_attr = read_phn_attr(phn_attr_pth) if phn_attr_pth else None
        cfg = V.config_from_yaml(model_cfg, n_mels=self.n_mels, linear_dim=self.linear_dim,
                                 vocab_size=self.vocab_size, n_spkr=self.n_spkr,
                                 attr_dim=0 if phn_attr is None else phn_attr.shape[1])
        return cfg, None if phn_attr is None else torch.from_numpy(phn_attr).to(self.device)

    def freq_loss_kwargs(self):
        h = self.config["hparas"]
        return dict(sample_rate=self.config["data"]["audio"]["sample_rate"], n_mels=self.n_mels,
                    loss=h["freq_loss_type"], differential_loss=h["differential_loss"],
                    emphasize_linear_low=h["emphasize_linear_low"])

    # ------------- default methods -------------
    def verbose(self, msg):
        if self.paras.verbose and self.is_first:
            self._clean_line()
            for m in [msg] if isinstance(msg, str) else msg:
                print("[INFO]", m)

    def progress(self, msg):
        if self.paras.verbose and self.is_first:
            self._clean_line()
            print("[{}] {}".format(human_format(self.step), msg), end="\r")

    def _clean_line(self):
        sys.stdout.write("\033[K")

    def write_log(self, log_name, log_value):
        """TensorBoard, routed by the name as the JAX solver routes it:
        names holding align, spec or hist log an (image, data format) pair
        as an image; code an (embedding matrix, labels) pair to the
        projector; wave a (signal, sample rate) pair as audio (skipped
        without the ``soundfile`` package, which tensorboardX's audio
        needs); text or hyp a string; any other name a dict of scalars (NaN
        and None dropped). Nothing is written without a writer."""
        if isinstance(log_value, dict):
            log_value = {k: float(v) for k, v in log_value.items()
                         if v is not None and not math.isnan(float(v))}
        if self.log is None or log_value is None:
            return
        if hasattr(log_value, "__len__") and len(log_value) == 0:
            return
        if "align" in log_name or "spec" in log_name or "hist" in log_name:
            img, form = log_value
            self.log.add_image(log_name, np.asarray(img), global_step=self.step, dataformats=form)
        elif "code" in log_name:
            self.log.add_embedding(np.asarray(log_value[0]), metadata=log_value[1],
                                   tag=log_name, global_step=self.step)
        elif "wave" in log_name:
            try:
                import soundfile  # noqa: F401
            except ImportError:
                return
            signal, sr = log_value
            self.log.add_audio(log_name, np.asarray(signal, np.float32).reshape(-1, 1),
                               self.step, sr)
        elif "text" in log_name or "hyp" in log_name:
            self.log.add_text(log_name, log_value, self.step)
        else:
            self.log.add_scalars(log_name, log_value, self.step)

    def save_checkpoint_triple(self, f_name, score, *, model, optimizer, extra=None):
        """``model``'s params and state and ``optimizer``'s state in the JAX
        package's checkpoint layout, at ``ckpdir/f_name``. On a mesh every
        rank calls it (the optimizer's split moments are gathered) and rank
        0 writes."""
        path = os.path.join(self.ckpdir, f_name)
        params, state = to_jax_params(model)
        opt_state = None if optimizer is None else optimizer_tree(optimizer, model)
        if not self.is_first:
            return
        save_checkpoint(path, params=params, state=state, opt_state=opt_state, step=self.step,
                        extra=extra)
        self.verbose("Saved checkpoint (step = {}, score = {:.2f}) and status @ {}".format(
            human_format(self.step), score, path))


class TrainLog:
    """The trainers' ``log(step, name, value)`` into a solver. A number
    logged as "group/key" goes to ``write_log(group, {key: value})``, under
    another name to ``write_log(name, {name: value})``; any other value
    (a dict of scalars, a figure, a wave, a text, the projector's table) to
    ``write_log(name, value)``. After a progress step's last counter, one
    progress line with the step's logged numbers and the solver's
    ``timer.show()``."""

    def __init__(self, solver, last="counter/unp_txt"):
        self.solver, self.last = solver, last
        self.values = {}

    def __call__(self, step, name, value):
        s = self.solver
        s.step = step
        if not isinstance(value, (int, float, np.number)):
            s.write_log(name, value)
            return
        group, _, key = name.partition("/")
        s.write_log(group, {key or name: value})
        self.values[name] = value
        if name == self.last:
            shown = " | ".join(f"{k} {v:.4g}" for k, v in self.values.items())
            s.progress(f"Tr stat | {shown} | {s.timer.show()}")
            self.values = {}
