"""Online TTS serving: phoneme ids -> waveform (counterpart of
`semi_tts_tpu/serve.py`).

The same math as the JAX server: codebook embed -> Tacotron2 AR decode at
tf_rate=0 -> CBHG mel->linear -> denormalize -> Griffin-Lim -> inverse
pre-emphasis, as two stages,

  synthesis: text ids -> linear-amplitude spectrogram
  vocoder:   linear-amplitude spectrogram -> waveform

run eagerly on the card. The decode budget follows the frames-per-phoneme
rule (``FRAME_PHN_RATIO`` mel frames per token plus a 40-frame margin),
rounded up to a step bucket.

Randomness: a request draws its prenet dropout masks and its Griffin-Lim
phases from one `torch.Generator` on the serving device, seeded from the
request's ``key`` (an int) or, without one, from a counter under a lock.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import torch

from .bridge import load_jax_params
from .device import resolve_device, use_fp32
from .models import vqvae as V
from .ops.features import AudioConfig, linear_to_amp
from .ops.griffin_lim import specgram_to_waveform

INFERENCE_MARGIN_FRAMES = 40


def serving_stages(cfg: V.VQVAEConfig, audio: AudioConfig, phn_attr, decode_steps: int, *,
                   mask_text_padding=True):
    """The (synth, vocode) stages for one decode length.

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


class TTSServer:
    """A loaded VQVAE (text->speech half) wrapped as a synthesis endpoint.

    >>> server = TTSServer.from_checkpoint("config/supervised.yaml",
    ...                                     "ckpt/best_tts_loss.pth")
    >>> wav = server.synthesize(text_ids, speaker_ids)   # (B, S) float32

    ``device`` defaults to the card and raises on a host without one; pass
    ``device="cpu"`` for the plain PyTorch path. ``synthesize`` may be called
    from several threads; the key counter is lock-protected and each request
    draws from its own generator.
    """

    def __init__(self, cfg: V.VQVAEConfig, audio: AudioConfig, phn_attr, model, *,
                 device=None, step_bucket=25):
        self.device = resolve_device(device)
        use_fp32()
        self.cfg = cfg
        self.audio = audio
        self.phn_attr = (None if phn_attr is None else
                         torch.as_tensor(np.asarray(phn_attr, np.float32), device=self.device))
        self.model = model.to(self.device).eval()
        self.step_bucket = int(step_bucket)
        self._counter = 0
        self._lock = threading.Lock()  # guards _counter

    @classmethod
    def from_checkpoint(cls, config, ckpt_path, *, device=None, step_bucket=25):
        """Build from a training config (YAML path or loaded dict) and a
        checkpoint in the JAX package's format: audio settings from
        ``data.audio``, topology from ``model``, weights from the checkpoint."""
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
        server = cls(cfg, audio, phn_attr, model, device=device, step_bucket=step_bucket)
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

    def stages(self, decode_steps: int):
        """(synth, vocode) for one decode length."""
        return serving_stages(self.cfg, self.audio, self.phn_attr, decode_steps)

    # ---- request paths -----------------------------------------------------

    def generator(self, key=None) -> torch.Generator:
        """The request's generator: seeded from ``key``, or from the next
        value of the server's counter."""
        if key is None:
            with self._lock:
                key = self._counter
                self._counter += 1
        g = torch.Generator(device=self.device)
        g.manual_seed(int(key))
        return g

    def _place(self, text, sid):
        text = torch.as_tensor(np.asarray(text), dtype=torch.long, device=self.device)
        sid = torch.as_tensor(np.asarray(sid), dtype=torch.long, device=self.device)
        return text, sid

    def synthesize(self, text, sid, key=None, *, decode_steps=None):
        """Text ids (B, U) + speaker ids (B,) -> waveforms (B, S) float32."""
        self._check_decode_steps(decode_steps)
        steps = decode_steps or self.decode_steps_for(text)
        text, sid = self._place(text, sid)
        synth, vocode = self.stages(steps)
        g = self.generator(key)
        wav = vocode(synth(self.model, text, sid, g), g)
        return wav.cpu().numpy()

    def synthesize_full(self, text, sid, key=None, *, decode_steps=None):
        """Like `synthesize` but also returns the offline-solver artifacts:
        dict(wav, mel, linear, align) with the alignment cropped per
        utterance as ``{id}-align.npy`` is."""
        self._check_decode_steps(decode_steps)
        steps = decode_steps or self.decode_steps_for(text)
        enc = np.sum(np.asarray(text) != 0, -1)
        text, sid = self._place(text, sid)
        g = self.generator(key)
        with torch.inference_mode():
            lat = V.embed_text(self.model, self.cfg, self.phn_attr, text)
            mel, lin, align, _ = V.text_to_speech(
                self.model, self.cfg, lat, sid, decode_steps=steps,
                latent_lengths=(text != 0).sum(-1) + 1, generator=g)
            amp = linear_to_amp(lin)
        _, vocode = self.stages(steps)
        wav = vocode(amp, g)
        r = self.cfg.n_frames_per_step
        align = align.cpu().numpy()
        out_align = [align[i][: int(enc[i] * V.FRAME_PHN_RATIO) // r, : enc[i]]
                     for i in range(align.shape[0])]
        return dict(wav=wav.cpu().numpy(), mel=mel.cpu().numpy(),
                    linear=lin.cpu().numpy(), align=out_align)
