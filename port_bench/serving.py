"""What the serving cells share: the server of a configuration with the
seed's weights, requests from a cell's durations, the decode budget, the
warm-up of every shape a cell sends, the reference's check of a sample of
served requests, and the FLOPs of a request's shape.

A request is (text (B, U) int32, speakers (B,) int32, key): its prenet masks
and Griffin-Lim phases come from the server's generator seeded with the
key, and the reference draws them from a generator seeded alike."""

from __future__ import annotations

import gc

import numpy as np
import torch

from port_bench import harness as H
from port_bench.reference import model as R

MARGIN_FRAMES = 40   # the decode budget: six frames a token and this margin,
STEP_BUCKET = 25     # rounded up to a multiple of this many decoder steps
TEXT_QUANTUM = 16    # texts are padded to a multiple of this many tokens


def decode_steps(text, r):
    n_tok = int(np.max(np.sum(np.asarray(text) != 0, -1))) + 1
    steps = (int(n_tok * R.FRAME_PHN_RATIO) + MARGIN_FRAMES + r - 1) // r
    return -(-steps // STEP_BUCKET) * STEP_BUCKET


def vqvae_config(conf):
    from semi_tts_tpu_torch.models import vqvae as V

    a = conf["audio"]
    return V.config_from_yaml(conf["model"], n_mels=a["num_mels"],
                              linear_dim=a["num_freq"] if a["use_linear"] else None,
                              vocab_size=conf["vocab_size"], n_spkr=conf["n_spkr"],
                              attr_dim=len(conf["phn_attr"][0]))


def build_server(conf, cell, seed, device):
    from semi_tts_tpu_torch.models import vqvae as V
    from semi_tts_tpu_torch.ops.features import AudioConfig
    from semi_tts_tpu_torch.serve import TTSServer

    a = conf["audio"]
    model = V.VQVAE(vqvae_config(conf), generator=torch.Generator().manual_seed(0)).to(device)
    P, S = H.make_weights(*H.model_shapes(model), seed, device)
    H.load_weights(model, P, S)
    del P, S
    audio = AudioConfig(num_freq=a["num_freq"], num_mels=a["num_mels"],
                        frame_length_ms=a["frame_length_ms"], frame_shift_ms=a["frame_shift_ms"],
                        preemphasis_coeff=a["preemphasis_coeff"], sample_rate=a["sample_rate"],
                        use_linear=a["use_linear"], snr_range=tuple(a["snr_range"]),
                        time_stretch_range=tuple(a["time_stretch_range"]))
    return TTSServer(vqvae_config(conf), audio, np.asarray(conf["phn_attr"], np.float32), model,
                     device=device, step_bucket=STEP_BUCKET,
                     program_cache_size=cell["program_cache_size"])


def token_counts(cell, conf):
    """The cell's utterances' token counts: ``cell["utterances"]`` durations
    drawn with replacement from ``cell["durations"]`` by the cell's own size
    seed, so that every run seed sends the same sizes."""
    a = conf["audio"]
    hop = int(a["frame_shift_ms"] / 1000 * a["sample_rate"])
    rng = np.random.RandomState(cell["size_seed"])
    d = rng.choice(np.asarray(cell["durations"]), size=cell["utterances"], replace=True)
    return [H.tokens_of(x, a["sample_rate"], hop) for x in d]


def make_request(tokens, conf, g):
    """Texts of ``tokens`` (a list, one a row) padded to the text quantum,
    speakers uniform over the configuration's."""
    U = -(-max(tokens) // TEXT_QUANTUM) * TEXT_QUANTUM
    text = H.texts(tokens, U, conf["vocab_size"], g, g.device).cpu().numpy()
    sid = torch.randint(conf["n_spkr"], (len(tokens),), generator=g, device=g.device)
    return text, sid.to(torch.int32).cpu().numpy()


def shape_of(text, r):
    return (decode_steps(text, r), text.shape[0], text.shape[1])


def warm(server, requests, recorder=None, calls=None):
    """Two requests of every shape among ``requests`` (a capture, then a
    first replay); with a recorder, the kernel calls of each shape's first."""
    r = server.cfg.n_frames_per_step
    seen = {}
    for text, sid, key in requests:
        shape = shape_of(text, r)
        n = seen.get(shape, 0)
        if n >= 2:
            continue
        seen[shape] = n + 1
        if recorder is not None and n == 0:
            with recorder.recording() as rec:
                server.synthesize(text, sid, key=key)
            calls[shape] = list(rec.calls)
        else:
            server.synthesize(text, sid, key=key)
    return sorted(seen)


def reference_waves(conf, seed, device, requests, tf32=False):
    """The reference's waveform (host, float64) of each request (text, sid,
    key); ``tf32``: its products in TF32 (the control)."""
    from port_bench.traffic.train import weights_of

    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        P, S = weights_of(conf, seed, device)
        m = R.Model(conf)
        phn_attr = torch.tensor(conf["phn_attr"], dtype=torch.float32, device=device)
        out = []
        with torch.no_grad():
            for text, sid, key in requests:
                net = R.Net(m, P, S, phn_attr, torch.Generator(device=device).manual_seed(int(key)))
                t = torch.as_tensor(text, dtype=torch.long, device=device)
                s = torch.as_tensor(sid, dtype=torch.long, device=device)
                out.append(net.vocode(net.synthesize(t, s, decode_steps(text, m.r))).numpy()
                           .astype(np.float64))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def wave_gap(got, ref):
    """The worst relative L2 gap of a request's waveform."""
    return max(float(np.linalg.norm(np.asarray(g, np.float64) - r) / max(np.linalg.norm(r), 1e-30))
               for g, r in zip(got, ref))


def reference_check(conf, seed, device, served):
    """The worst gap of the served requests (text, sid, key, waveform)
    against the reference's waveforms."""
    ref = reference_waves(conf, seed, device, [x[:3] for x in served])
    return wave_gap([x[3] for x in served], ref)


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def request_flops(conf, shape):
    """FLOPs of one request of ``shape`` (decode steps, B, U): the plain
    reference's synthesis and Griffin-Lim, counted on ``meta``."""
    from port_bench.traffic.train import weights_of

    steps, B, U = shape
    dev = torch.device("meta")
    P, S = weights_of(conf, 0, dev)
    net = R.Net(R.Model(conf), P, S,
                torch.zeros((conf["vocab_size"], len(conf["phn_attr"][0])), device=dev), None,
                count_only=True)
    text = torch.ones((B, U), dtype=torch.long, device=dev)
    sid = torch.zeros((B,), dtype=torch.long, device=dev)
    with torch.no_grad():
        return H.count_flops(lambda: net.vocode(net.synthesize(text, sid, steps)))
