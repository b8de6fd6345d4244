"""A configuration and cells at the CPU tests' sizes (the widths of the
repository's own tiny test configuration), in the files' schemas."""

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


def conf(bone="l2"):
    c = json.load(open(os.path.join(BENCH, "configs", "semi-multi-spkr.json")))
    c["audio"].update(num_freq=257, num_mels=20, frame_length_ms=20, frame_shift_ms=10)
    m = c["model"]
    m["spkr_latent_dim"] = 8
    m["encoder"].update(dim=16, kernel=[3, 4], stride=[1, 2], residual=[0, 0], rnn_layers=1, rnn_dim=8)
    m["codebook"].update(bone=bone, latent_dim=12, proj_attr=4)
    m["decoder"]["encoder"].update(enc_n_conv=2, enc_embed_dim=16)
    m["decoder"]["decoder"].update(prenet_dim=8, query_rnn_dim=16, dec_rnn_dim=16, attn_dim=8,
                                   n_location_filters=4, location_kernel_size=7)
    c["n_spkr"] = 5
    return c


def train_cell(name="semi.train"):
    c = json.load(open(os.path.join(BENCH, "workloads", name + ".json")))
    c = copy.deepcopy(c)
    for kind, S, U in (("paired", 4410, 8), ("unpaired", 6615, 12)):
        if kind in c:
            c[kind].update(batch=2, pad_samples=S, pad_tokens=U, pool=2,
                           durations=[0.12, 0.15, 0.2, S / 22050])
    c.update(warmup_steps=4 if "unpaired" in c else 3, trace_seconds=0.5, chips=1,
             config="semi-multi-spkr", name=name)
    return c


def serve_cell(name="semi.bulk"):
    c = copy.deepcopy(json.load(open(os.path.join(BENCH, "workloads", name + ".json"))))
    c.update(durations=[0.1, 0.12, 0.2], chips=1, config="semi-multi-spkr", name=name,
             trace_seconds=0.5)
    if c["kind"] == "bulk":
        c.update(batch=2, utterances=6)
    else:
        c.update(rate_per_s=4.0)
    return c
