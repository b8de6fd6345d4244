"""Online TTS serving: phoneme ids -> waveform (counterpart of
`semi_tts_tpu/serve.py`).

The same math as the JAX server: codebook embed -> Tacotron2 AR decode at
tf_rate=0 -> CBHG mel->linear -> denormalize -> Griffin-Lim -> inverse
pre-emphasis, as two stages,

  synthesis: text ids -> linear-amplitude spectrogram
  vocoder:   linear-amplitude spectrogram -> waveform

plus the ``full`` stage of `synthesize_full`, which keeps the mel, linear
and alignment too. The decode budget follows the frames-per-phoneme rule
(``FRAME_PHN_RATIO`` mel frames per token plus a 40-frame margin), rounded
up to a step bucket. On the card each stage of each (decode bucket, batch,
text length) is one CUDA graph (`graphs.Graphed`), kept in a bounded LRU of
build-once cells as the JAX server keeps its jitted stage programs; on the
CPU the same LRU holds the eager stages.

Randomness: a request draws its prenet dropout masks and its Griffin-Lim
phases from the server's one `torch.Generator` on the serving device,
registered with every graph and reseeded before each request from the
request's ``key`` (an int) or, without one, from a counter under a lock.

On a mesh (``TTSServer(mesh=...)``, `parallel.mesh`) every rank calls
``synthesize`` with the same request, as the JAX server runs SPMD: a rank
decodes its rows of a batch that the data axis divides (within
`split_rows`, so its draws are its rows of the whole batch's), and the
outputs are all-gathered, so every rank returns the whole batch; a batch
the data axis does not divide runs whole on every rank. The program LRU and
its build cells stay per rank. The stages run no collective (the gather
is outside them), so they stay CUDA graphs under any process group.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import torch

from .bridge import load_jax_params
from .device import resolve_device, use_deterministic, use_fp32
from .graphs import GraphOwner, ProgramCache, program
from .models import vqvae as V
from .ops.features import AudioConfig, linear_to_amp
from .ops.griffin_lim import specgram_to_waveform
from .parallel.mesh import all_gather_rows, replicate, shard_batch, split_rows

INFERENCE_MARGIN_FRAMES = 40


def serving_stages(cfg: V.VQVAEConfig, audio: AudioConfig, phn_attr, decode_steps: int, *,
                   mask_text_padding=True):
    """The eager (synth, vocode) stages for one decode length.

    ``synth(model, text, sid, generator) -> linear amplitude (B, T, F)``
    ``vocode(amp, generator, phases=None) -> waveform (B, S)``

    ``mask_text_padding``: memory lengths of ``nonzero(text) + 1`` are
    passed to the decoder, which masks attention with them when the config
    sets ``mask_attention``.
    """

    @torch.inference_mode()
    def synth(model, text, sid, generator=None):
        lat = V.embed_text(model, cfg, phn_attr, text)
        lengths = (text != 0).sum(-1) + 1 if mask_text_padding else None
        _, lin, _, _ = V.text_to_speech(model, cfg, lat, sid, decode_steps=decode_steps,
                                        latent_lengths=lengths, generator=generator)
        return linear_to_amp(lin)

    @torch.inference_mode()
    def vocode(amp, generator=None, phases=None):
        return specgram_to_waveform(
            amp, generator, n_fft=audio.n_fft, hop=audio.hop_length,
            win_length=audio.win_length, preemphasis_coeff=audio.preemphasis_coeff,
            phases=phases)

    return synth, vocode


def full_stage(cfg: V.VQVAEConfig, phn_attr, decode_steps: int):
    """The eager ``full(model, text, sid, generator) -> (mel, linear,
    align, amp)`` of `synthesize_full`: `serving_stages`'s synthesis keeping
    the offline solver's artifacts."""

    @torch.inference_mode()
    def full(model, text, sid, generator=None):
        lat = V.embed_text(model, cfg, phn_attr, text)
        mel, lin, align, _ = V.text_to_speech(
            model, cfg, lat, sid, decode_steps=decode_steps,
            latent_lengths=(text != 0).sum(-1) + 1, generator=generator)
        return mel, lin, align, linear_to_amp(lin)

    return full


class TTSServer:
    """A loaded VQVAE (text->speech half) wrapped as a synthesis endpoint.

    >>> server = TTSServer.from_checkpoint("config/supervised.yaml",
    ...                                     "ckpt/best_tts_loss.pth")
    >>> wav = server.synthesize(text_ids, speaker_ids)   # (B, S) float32

    ``device`` defaults to the card and raises on a host without one; pass
    ``device="cpu"`` for the plain PyTorch path.

    Stage programs are built once per (kind, decode bucket, batch, text
    length) and kept in a bounded per-instance LRU of ``program_cache_size``
    entries (`graphs.ProgramCache`, the JAX server's policy: decode lengths
    are bucketed to multiples of ``step_bucket`` macro-steps, so a handful
    of entries covers real traffic, and an endpoint fed adversarial lengths
    evicts the least-recently-used program instead of keeping graphs
    without limit). On the card a program is a CUDA graph captured at its
    first request; the graphs of a server share one memory pool.

    Thread safety: ``synthesize``/``synthesize_full`` may be called from
    many threads. The LRU and the key counter are lock-protected and a cache
    miss builds under a per-key cell (`graphs._Once`); the requests
    themselves, a capture included, run one at a time under the server's
    run lock, since they reseed one generator and replay graphs that share
    one pool (and a capture must not run while another thread replays).
    Eviction is safe during use: a program already handed to a caller stays
    valid.

    ``mesh``: a `parallel.mesh.Mesh` to serve on (see the module's
    docstring; every rank's weights are made rank 0's). ``compile_cache``
    is taken, as the JAX server takes it, and ignored: a CUDA graph is
    captured in the process that replays it, so there is nothing to keep
    across processes.
    """

    def __init__(self, cfg: V.VQVAEConfig, audio: AudioConfig, phn_attr, model, *,
                 device=None, step_bucket=25, program_cache_size=8, mesh=None,
                 compile_cache=None):
        self.device = resolve_device(device)
        use_fp32()
        use_deterministic()
        self.cfg = cfg
        self.audio = audio
        self.phn_attr = (None if phn_attr is None else
                         torch.as_tensor(np.asarray(phn_attr, np.float32), device=self.device))
        self.model = model.to(self.device).eval()
        self.mesh = mesh
        if mesh is not None:
            replicate(list(self.model.parameters()) + list(self.model.buffers()), mesh)
        self.step_bucket = int(step_bucket)
        self.program_cache_size = max(1, int(program_cache_size))
        self._cache = ProgramCache(self.program_cache_size)
        self._owner = GraphOwner(self.device) if self.device.type == "cuda" else None
        self._gen = torch.Generator(device=self.device)
        self._counter = 0
        self._lock = threading.Lock()  # guards _counter
        self._run = threading.Lock()   # one request (capture or replay) at a time

    @classmethod
    def from_checkpoint(cls, config, ckpt_path, *, device=None, step_bucket=25,
                        program_cache_size=8, mesh=None, compile_cache=None):
        """Build from a training config (YAML path or loaded dict) and a
        checkpoint in the JAX package's format: audio settings from
        ``data.audio``, topology from ``model``, weights from the checkpoint.
        ``compile_cache`` is ignored, as in the constructor."""
        from .data.text import load_text_encoder
        from .train.checkpoint import load_checkpoint
        from .utils.metrics import read_phn_attr

        device = resolve_device(device)
        if isinstance(config, str):
            import yaml

            with open(config) as f:
                config = yaml.safe_load(f)
        a = config["data"]["audio"]
        audio = AudioConfig(
            num_freq=a["num_freq"], num_mels=a["num_mels"],
            frame_length_ms=a["frame_length_ms"], frame_shift_ms=a["frame_shift_ms"],
            preemphasis_coeff=a["preemphasis_coeff"], sample_rate=a["sample_rate"],
            use_linear=a["use_linear"], snr_range=tuple(a["snr_range"]),
            time_stretch_range=tuple(a["time_stretch_range"]))
        corpus = config["data"]["corpus"]
        tokenizer = load_text_encoder("phoneme", vocab_file=corpus["vocab_file"])
        with open(corpus["spkr_map"]) as f:
            n_spkr = len(json.load(f))
        model_cfg = dict(config["model"])
        for k in ("pretrained_asr", "pretrained_emb", "pretrained_tts"):
            model_cfg.pop(k, None)
        phn_attr_pth = model_cfg["codebook"].get("phn_attr_pth") or ""
        phn_attr = read_phn_attr(phn_attr_pth) if phn_attr_pth else None
        cfg = V.config_from_yaml(
            model_cfg, n_mels=audio.num_mels,
            linear_dim=audio.num_freq if audio.use_linear else None,
            vocab_size=tokenizer.vocab_size, n_spkr=n_spkr,
            attr_dim=0 if phn_attr is None else phn_attr.shape[1])
        ckpt = load_checkpoint(ckpt_path)
        model = load_jax_params(V.VQVAE(cfg, generator=torch.Generator()),
                                ckpt["model"], ckpt["state"])
        server = cls(cfg, audio, phn_attr, model, device=device, step_bucket=step_bucket,
                     program_cache_size=program_cache_size, mesh=mesh)
        server.tokenizer = tokenizer
        return server

    # ---- decode-length policy ----------------------------------------------

    def decode_steps_for(self, text) -> int:
        """Macro-step budget for a padded text batch: FRAME_PHN_RATIO frames
        per longest-text token + the 40-frame margin, bucketed up."""
        n_tok = int(np.max(np.sum(np.asarray(text) != 0, -1))) + 1
        r = self.cfg.n_frames_per_step
        steps = (int(n_tok * V.FRAME_PHN_RATIO) + INFERENCE_MARGIN_FRAMES + r - 1) // r
        b = self.step_bucket
        return ((steps + b - 1) // b) * b

    @staticmethod
    def _check_decode_steps(decode_steps):
        if decode_steps is not None and int(decode_steps) < 1:
            raise ValueError(
                "decode_steps must be >= 1 (got %r); omit it to use the "
                "frames-per-phoneme policy (decode_steps_for)" % (decode_steps,))

    def _cached_program(self, kind, decode_steps, batch, text_len, build):
        """The LRU's program of (kind, decode_steps, batch, text_len)."""
        return self._cache.get((kind, int(decode_steps), int(batch), int(text_len)), build)

    def _program(self, fn, rows=0):
        """``fn(*tensors)``, which draws from the server's generator, as a
        program ``(*tensors, seed=None)``: a graph on the card, under any
        process group (a stage runs no collective). ``rows``: the program's batch is
        this rank's ``rows`` of a split one (`split_rows`); 0: whole."""
        def run(*tensors):
            with split_rows(self.mesh if rows else None, rows):
                return fn(*tensors)

        return program(run, self.device, self._owner, generator=self._gen)

    def stages(self, decode_steps: int, batch: int, text_len: int, *, split=False):
        """The (synth, vocode) programs of one decode length and request
        shape (LRU-cached): ``synth(text, sid, seed=key) -> amp`` reseeds the
        generator, ``vocode(amp) -> wav`` goes on drawing from it. ``split``:
        ``batch`` is this rank's rows of a batch split over the mesh."""
        rows = batch if split else 0

        def build():
            synth, vocode = serving_stages(self.cfg, self.audio, self.phn_attr, decode_steps)
            return (self._program(lambda text, sid: synth(self.model, text, sid, self._gen), rows),
                    self._program(lambda amp: vocode(amp, self._gen), rows))

        kind = "stages/rows" if split else "stages"
        return self._cached_program(kind, decode_steps, batch, text_len, build)

    def _full_stage(self, decode_steps: int, batch: int, text_len: int, *, split=False):
        """The program of `full_stage` (LRU-cached): ``full(text, sid,
        seed=key) -> (mel, linear, align, amp)``; ``split`` as `stages`'."""
        def build():
            full = full_stage(self.cfg, self.phn_attr, decode_steps)
            return self._program(lambda text, sid: full(self.model, text, sid, self._gen),
                                 batch if split else 0)

        kind = "full/rows" if split else "full"
        return self._cached_program(kind, decode_steps, batch, text_len, build)

    # ---- request paths -----------------------------------------------------

    def _key(self, key=None) -> int:
        """The request's seed: ``key``, or the next value of the server's
        counter."""
        if key is None:
            with self._lock:
                key = self._counter
                self._counter += 1
        return int(key)

    def _place(self, text, sid):
        text = torch.as_tensor(np.asarray(text), dtype=torch.long, device=self.device)
        sid = torch.as_tensor(np.asarray(sid), dtype=torch.long, device=self.device)
        return text, sid

    def _place_rows(self, text, sid):
        """The request on the device -> (text, sid, split): on a mesh whose
        data axis divides the batch, this rank's rows and True."""
        text, sid = self._place(text, sid)
        mesh = self.mesh
        split = (mesh is not None and mesh.shape["data"] > 1
                 and text.shape[0] % mesh.shape["data"] == 0)
        if split:
            text, sid = shard_batch((text, sid), mesh)
        return text, sid, split

    def _whole(self, t, split):
        """A split request's output gathered over the data group."""
        return all_gather_rows(t, self.mesh.data_group) if split else t

    def synthesize(self, text, sid, key=None, *, decode_steps=None):
        """Text ids (B, U) + speaker ids (B,) -> waveforms (B, S) float32."""
        self._check_decode_steps(decode_steps)
        steps = decode_steps or self.decode_steps_for(text)
        text, sid, split = self._place_rows(text, sid)
        synth, vocode = self.stages(steps, *text.shape, split=split)
        seed = self._key(key)
        with self._run:
            wav = self._whole(vocode(synth(text, sid, seed=seed)), split)
        return wav.cpu().numpy()

    def synthesize_full(self, text, sid, key=None, *, decode_steps=None):
        """Like `synthesize` but also returns the offline-solver artifacts:
        dict(wav, mel, linear, align) with the alignment cropped per
        utterance as ``{id}-align.npy`` is."""
        self._check_decode_steps(decode_steps)
        steps = decode_steps or self.decode_steps_for(text)
        enc = np.sum(np.asarray(text) != 0, -1)
        text, sid, split = self._place_rows(text, sid)
        full = self._full_stage(steps, *text.shape, split=split)
        _, vocode = self.stages(steps, *text.shape, split=split)
        seed = self._key(key)
        with self._run:
            mel, lin, align, amp = full(text, sid, seed=seed)
            mel, lin, align, wav = (self._whole(t, split) for t in (mel, lin, align, vocode(amp)))
        r = self.cfg.n_frames_per_step
        align = align.cpu().numpy()
        out_align = [align[i][: int(enc[i] * V.FRAME_PHN_RATIO) // r, : enc[i]]
                     for i in range(align.shape[0])]
        return dict(wav=wav.cpu().numpy(), mel=mel.cpu().numpy(),
                    linear=lin.cpu().numpy(), align=out_align)
