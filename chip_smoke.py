#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`semi_tts_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: a CUDA card must be present; prints nvidia-smi's name and power limit;
2. build: compiles every kernel under ``semi_tts_tpu_torch/csrc`` with nvcc (sm_90a);
3. kernels: each kernel at its serving shapes against its plain PyTorch version
   (max abs error against a stated tolerance), plus ragged shapes; device time of
   the kernel, of the plain version and of one PyTorch library call where one
   computes the same function (CUDA events around a replayed CUDA graph of many
   calls), the kernel's eager time through its Python wrapper, and the least
   time the card could take (bytes over 3.35 TB/s or FLOPs over 67 TFLOP/s fp32,
   whichever is larger); for the recurrences also the time per step, for K1
   by batch rows per cluster (``ms_by_rows``) and at the ASR shape T=267; for
   K3 its cluster size (``cluster``), for K4 ``gl_ola_frame`` its time by
   output frames per CTA (``ms_by_tile``) and the default tile (``tile``);
   rows without a library yardstick say why in ``library``;
4. serving at the flagship width of ``config/semi-multi-spkr-paired-data.yaml``:
   a seeded random model written with the port's ``save_checkpoint``, loaded with
   ``TTSServer.from_checkpoint`` on the card, one warm-up request, then five timed
   requests of B=16 utterances of U=32 tokens (100 decode steps, 300 frames, 82225
   samples each; the median wall time is reported), with every kernel's launch
   counter reset before the first and read after it; the wall time of each stage;
   one request under torch.profiler for the device's busy time and idle share; and
   a small request against the same checkpoint served by the plain path on the CPU.

Prints a ``{"ptxas": ...}`` line (registers and spills of the recurrence
kernels), an ``{"asr_shape": ...}`` line, a ``{"kernels": [...]}`` line, a
``{"serving": ...}`` line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# the `model` and `data.audio` blocks of config/semi-multi-spkr-paired-data.yaml
FLAGSHIP_MODEL = {
    "stop_threshold": 0.5, "max_frames_per_phn": 3, "txt_update_codebook": False,
    "spkr_latent_dim": 128,
    "encoder": {"dim": 512, "kernel": [3, 4, 3, 3, 3, 1], "stride": [1, 2, 1, 1, 1, 1],
                "residual": [0, 0, 1, 1, 1, 1], "dropout": 0.5, "activation": "Tanh",
                "batch_norm": True, "rnn_bid": True, "rnn_layers": 2, "rnn_dim": 256,
                "layer_norm": False},
    "codebook": {"bone": "l2", "softmax": "normal", "latent_dim": 64, "commit_weight": 0,
                 "vq_weight": 0, "temp": 1, "skip_prob": 0, "stop_grad": True,
                 "phn_attr_pth": "data/phn_attr.csv", "proj_attr": 16},
    "decoder": {
        "separate_postnet": True,
        "encoder": {"enc_n_conv": 3, "enc_kernel_size": 5, "enc_rnn_layer": 1,
                    "enc_embed_dim": 512, "enc_dropout": 0.0},
        "decoder": {"n_frames_per_step": 3, "prenet_dim": 256, "prenet_dropout": 0.5,
                    "query_rnn_dim": 1024, "dec_rnn_dim": 1024, "query_dropout": 0.1,
                    "dec_dropout": 0.1, "attn_dim": 256, "n_location_filters": 32,
                    "location_kernel_size": 31, "loc_aware": True,
                    "use_summed_weights": True, "drop_dec_in": 0.0},
    },
}
FLAGSHIP_AUDIO = {"num_freq": 1025, "num_mels": 80, "frame_length_ms": 50,
                  "frame_shift_ms": 12.5, "preemphasis_coeff": 0.97, "sample_rate": 22050,
                  "use_linear": True, "snr_range": [10, 100], "time_stretch_range": [0.9, 1.1]}

B, U = 16, 32                   # serving batch and padded text length
REQUESTS = 5                    # timed requests; the kernel launches are counted in the first
HOP = int(FLAGSHIP_AUDIO["frame_shift_ms"] / 1000 * FLAGSHIP_AUDIO["sample_rate"])
HBM_BYTES_PER_S = 3.35e12       # H100 SXM
FP32_FLOP_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


def time_ms(fn, iters):
    """Mean time of ``fn()`` over ``iters`` back-to-back eager calls after two
    warm-ups: device time plus whatever host time the calls do not hide."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, reps=3):
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA graph,
    replayed ``reps`` times, so no host time enters."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


def max_err(got, want):
    if isinstance(got, tuple):
        return max(max_err(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    return float((got - want).abs().max())


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _lstm_inputs(randn, unif, T, B, H):
    """Both directions' W_hh and x_proj of a BiLSTM layer."""
    w = [unif(4 * H, H, a=H ** -0.5) for _ in range(2)]
    return w + [randn(T, B, 4 * H, scale=0.5) for _ in range(2)]


def _gru_inputs(randn, unif, T, B, H):
    """Both directions' W_hh, b_hh and x_proj of a BiGRU."""
    w = [unif(3 * H, H, a=H ** -0.5) for _ in range(2)]
    b = [unif(3 * H, a=H ** -0.5) for _ in range(2)]
    return w + b + [randn(T, B, 3 * H, scale=0.5) for _ in range(2)]


def _case_lstm(randn, unif, dev):
    """K1: the TTS encoder BiLSTM, both directions in one launch. Also
    checked at T=1, at B=5 (not a multiple of the rows per cluster), at
    H=80, and one direction at a time, forward and reversed."""
    from semi_tts_tpu_torch.kernels import rnn as k12

    T, H, D = 32, 256, 512
    x_in = randn(T, B, D)
    w_ih = [unif(4 * H, D, a=H ** -0.5) for _ in range(2)]
    bias = [unif(4 * H, a=H ** -0.5) for _ in range(2)]
    w_hh = [unif(4 * H, H, a=H ** -0.5) for _ in range(2)]
    x_proj = [(x_in @ w.T + b).contiguous() for w, b in zip(w_ih, bias)]
    lstm = torch.nn.LSTM(D, H, bidirectional=True).to(dev)
    with torch.no_grad():
        for sfx, wi, wh, b in zip(("", "_reverse"), w_ih, w_hh, bias):
            getattr(lstm, "weight_ih_l0" + sfx).copy_(wi)
            getattr(lstm, "weight_hh_l0" + sfx).copy_(wh)
            getattr(lstm, "bias_ih_l0" + sfx).copy_(b)
            getattr(lstm, "bias_hh_l0" + sfx).zero_()
    args = w_hh + x_proj
    checks = [(lambda a=a: k12.bilstm_rec(*a), lambda a=a: k12.bilstm_rec_plain(*a))
              for a in (_lstm_inputs(randn, unif, 1, B, H), _lstm_inputs(randn, unif, T, 5, H),
                        _lstm_inputs(randn, unif, T, 5, 80))]
    checks += [(lambda r=r: k12.lstm_rec(r, w_hh[0], x_proj[0]),
                lambda r=r: k12.lstm_rec_plain(r, w_hh[0], x_proj[0])) for r in (False, True)]
    return dict(
        name="bilstm_rec", replaces="tools/proto_pallas_rnn.py:33 (pallas_lstm_rec, pallas_call "
        "at :61); semi_tts_tpu/ops/rnn.py:95 (_lstm_rec_fwd), both directions",
        source="semi_tts_tpu_torch/csrc/rnn.cu",
        shapes=f"2 x x_proj ({T},{B},{4 * H}), 2 x w_hh ({4 * H},{H})", steps=T,
        kernel=lambda: k12.bilstm_rec(*args), plain=lambda: k12.bilstm_rec_plain(*args),
        checks=checks, rows=lambda r: k12.bilstm_rec(*args, rows=r), row_options=k12.LSTM_ROWS,
        library=lambda: lstm(x_in),
        library_note="cuDNN nn.LSTM(bidirectional=True), includes the input GEMM; graph-timed",
        tol=1e-4, nbytes=2 * 4 * (T * B * 4 * H + 4 * H * H + T * B * H),
        flops=2 * 2 * T * B * 4 * H * H, iters=20)


def _case_gru(randn, unif, dev):
    """K2: the CBHG BiGRU, both directions in one launch. Also checked at
    T=1, at B=5, at H=50, and one direction at a time, forward and
    reversed."""
    from semi_tts_tpu_torch.kernels import rnn as k12

    T, H = 300, 80
    x_in = randn(T, B, H)
    w_ih = [unif(3 * H, H, a=H ** -0.5) for _ in range(2)]
    b_ih = [unif(3 * H, a=H ** -0.5) for _ in range(2)]
    w_hh = [unif(3 * H, H, a=H ** -0.5) for _ in range(2)]
    b_hh = [unif(3 * H, a=H ** -0.5) for _ in range(2)]
    x_proj = [(x_in @ w.T + b).contiguous() for w, b in zip(w_ih, b_ih)]
    gru = torch.nn.GRU(H, H, bidirectional=True).to(dev)
    with torch.no_grad():
        for sfx, wi, wh, bi, bh in zip(("", "_reverse"), w_ih, w_hh, b_ih, b_hh):
            getattr(gru, "weight_ih_l0" + sfx).copy_(wi)
            getattr(gru, "weight_hh_l0" + sfx).copy_(wh)
            getattr(gru, "bias_ih_l0" + sfx).copy_(bi)
            getattr(gru, "bias_hh_l0" + sfx).copy_(bh)
    args = w_hh + b_hh + x_proj
    checks = [(lambda a=a: k12.bigru_rec(*a), lambda a=a: k12.bigru_rec_plain(*a))
              for a in (_gru_inputs(randn, unif, 1, B, H), _gru_inputs(randn, unif, T, 5, H),
                        _gru_inputs(randn, unif, 40, 5, 50))]
    checks += [(lambda r=r: k12.gru_rec(r, w_hh[0], b_hh[0], x_proj[0]),
                lambda r=r: k12.gru_rec_plain(r, w_hh[0], b_hh[0], x_proj[0]))
               for r in (False, True)]
    return dict(
        name="bigru_rec", replaces="semi_tts_tpu/ops/rnn.py:225 (_gru_rec_fwd), both directions",
        source="semi_tts_tpu_torch/csrc/rnn.cu",
        shapes=f"2 x x_proj ({T},{B},{3 * H}), 2 x w_hh ({3 * H},{H})", steps=T,
        kernel=lambda: k12.bigru_rec(*args), plain=lambda: k12.bigru_rec_plain(*args),
        checks=checks,
        library=lambda: gru(x_in),
        library_note="cuDNN nn.GRU(bidirectional=True), includes the input GEMM; graph-timed",
        tol=1e-4, nbytes=2 * 4 * (T * B * 3 * H + 3 * H * H + 3 * H + T * B * H),
        flops=2 * 2 * T * B * 3 * H * H, iters=10)


def ptxas_report(log):
    """Registers, spills and static shared memory of each instantiation of
    the recurrence kernels, from nvcc's ``-Xptxas -v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(lstm|gru)_rec_kernelILi(\d+)E(?:Li(\d+)E)?", line)
        if "Compiling entry function" in line:
            args = ",".join(a for a in m.groups()[1:] if a) if m else ""
            name = f"{m.group(1)}_rec_kernel<{args}>" if m else None
        elif name and "spill stores" in line:
            out.setdefault(name, {})["spill_bytes"] = int(re.search(r"(\d+) bytes spill stores", line)[1])
        elif name and "Used" in line:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(name, {}).update(registers=int(re.search(r"Used (\d+) registers", line)[1]),
                                            static_smem_bytes=int(smem[1]) if smem else 0)
    return out


@torch.no_grad()
def asr_lstm_check(dev):
    """K1 at P1's own shape, the ASR BiLSTM of `tools/proto_pallas_rnn.py`
    (T=267, B=16, H=256, input 512): agreement with the plain version and
    device time, beside cuDNN's bidirectional LSTM (input GEMM included)."""
    from semi_tts_tpu_torch.kernels import rnn as k12

    g = torch.Generator(device=dev).manual_seed(1)
    T, H, D = 267, 256, 512
    args = [(torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1) * H ** -0.5 for _ in range(2)]
    args += [torch.randn((T, B, 4 * H), generator=g, device=dev) * 0.5 for _ in range(2)]
    err = max_err(k12.bilstm_rec(*args), k12.bilstm_rec_plain(*args))
    if not err <= 1e-4:
        raise SystemExit(f"chip_smoke: bilstm_rec at T={T} disagrees with its plain version ({err})")
    ms = device_ms(lambda: k12.bilstm_rec(*args), 5)
    lstm, x_in = torch.nn.LSTM(D, H, bidirectional=True).to(dev), torch.randn(T, B, D, device=dev)
    return {"name": "bilstm_rec", "T": T, "B": B, "H": H, "max_abs_err": err, "tol": 1e-4,
            "ms": ms, "ms_per_step": ms / T, "library_ms": device_ms(lambda: lstm(x_in), 5),
            "library": "cuDNN nn.LSTM(bidirectional=True), includes the input GEMM; graph-timed"}


NO_LIBRARY = "none: no single PyTorch call computes this function"


def _case_attention(randn, unif, dev):
    """K3: one decoder attention step (no mask, as the flagship decodes).
    Also checked with a padding mask, at memory lengths that are not a
    multiple of 32 (L=45, and L=1000 near the plan's limit, where memory is
    read from L2 instead of shared memory), at B=5 and without location
    features (loc_aware: false)."""
    from semi_tts_tpu_torch.kernels import attention as k3

    L, A, D, C, F_, K = 32, 256, 512, 2, 32, 31
    weights = (unif(F_, C, K, a=0.3), unif(A, F_, a=0.3), unif(A, a=0.1))

    def inputs(L, B=B):
        pq, pm, mem = randn(B, A), randn(B, L, A, scale=0.5), randn(B, L, D)
        w = torch.softmax(randn(B, L), -1)
        hist = torch.stack([w, w + torch.softmax(randn(B, L), -1)], 1).contiguous()
        lengths = L - 12 + torch.arange(B, device=dev) % 13
        mask = torch.arange(L, device=dev)[None, :] >= lengths[:, None]
        return (pq, pm, mem, hist) + weights, mask

    args, mask = inputs(L)
    odd, odd_mask = inputs(45)
    long, long_mask = inputs(1000)
    five, five_mask = inputs(L, B=5)
    no_loc = args[:4] + (None, None, args[6])
    cases = ((args, mask), (odd, None), (odd, odd_mask), (long, None), (long, long_mask),
             (five, None), (five, five_mask), (no_loc, None), (no_loc, mask))
    return dict(
        name="attention_step", replaces="semi_tts_tpu/models/attention.py:39 (attention_step, "
        "in the decoder_apply step body, models/decoder.py:227)",
        source="semi_tts_tpu_torch/csrc/attention.cu",
        shapes=f"B={B} L={L} A={A} D={D} C={C} F={F_} K={K}",
        kernel=lambda: k3.attention_step(*args), plain=lambda: k3.attention_step_plain(*args),
        checks=[(lambda a=a, m=m: k3.attention_step(*a, m),
                 lambda a=a, m=m: k3.attention_step_plain(*a, m)) for a, m in cases],
        extra={"cluster": k3.attention_plan(B, L, A, D, C, F_, K)["cluster"]},
        library=None, library_note=NO_LIBRARY, tol=1e-4,
        nbytes=4 * (B * A + B * L * A + B * L * D + B * C * L + F_ * C * K + A * F_ + A + B * D + B * L),
        flops=2 * B * L * (F_ * C * K + A * F_ + 2 * A + D), iters=200)


def _case_gl_project(randn, unif, dev):
    """K4a: the phase projection at 300 frames of a 2048-point DFT."""
    from semi_tts_tpu_torch.kernels import griffin_lim as k4

    T, F_ = 300, 1025
    reim, mag = randn(B, T, 2 * F_), randn(B, T, F_).abs()
    reim[:, :2, :8] = 0.0  # exercise angle(0) = 0
    reim[:, :2, F_:F_ + 8] = 0.0
    return dict(
        name="gl_project", replaces="semi_tts_tpu/ops/griffin_lim.py:71 (griffin_lim body: "
        "phase projection)", source="semi_tts_tpu_torch/csrc/griffin_lim.cu",
        shapes=f"reim ({B},{T},{2 * F_}) mag ({B},{T},{F_})",
        kernel=lambda: k4.gl_project(reim, mag), plain=lambda: k4.gl_project_plain(reim, mag),
        library=None, library_note=NO_LIBRARY, tol=1e-4, nbytes=4 * B * T * 5 * F_,
        flops=6 * B * T * F_, iters=50)


def _case_gl_ola_frame(randn, unif, dev):
    """K4b: overlap-add + next-round framing at n_fft 2048, hop 275, win 1102.
    Also checked with the signal out (the last round) at T=300, and at T=5,
    where a tile's segment is reflected at both ends: with the default tile
    (greater than T), with one frame a tile and with 2 frames a tile, both
    outputs; at T=300 with one frame a tile; and at an odd window length
    (n_fft 512, hop 220, win 441). Timed by frames per tile."""
    from semi_tts_tpu_torch.kernels import griffin_lim as k4
    from semi_tts_tpu_torch.ops.stft import window_support

    T, geo = 300, dict(n_fft=2048, hop=275, win_length=1102)
    span = window_support(2048, 1102)[1]
    frames = randn(B, T, span, scale=0.1)
    short = randn(B, 5, span, scale=0.1)
    odd_geo = dict(n_fft=512, hop=220, win_length=441)  # odd span: scalar stores
    odd = randn(B, 12, 441, scale=0.1)
    S = geo["hop"] * (T - 1)
    checks = [(lambda x=x, e=e, n=n, g=g: k4.gl_ola_frame(x, emit_signal=e, tile=n, **g),
               lambda x=x, e=e, g=g: k4.gl_ola_frame_plain(x, emit_signal=e, **g))
              for x, n, g in ((frames, None, geo), (frames, 1, geo), (short, None, geo),
                              (short, 1, geo), (short, 2, geo), (odd, None, odd_geo))
              for e in (False, True)]
    return dict(
        name="gl_ola_frame", replaces="semi_tts_tpu/ops/stft.py:400 (istft_reim OLA/divide/trim) "
        "+ :373 (stft_reim pad/framing), per griffin_lim.py:77 round",
        source="semi_tts_tpu_torch/csrc/griffin_lim.cu", shapes=f"frames ({B},{T},{span})",
        kernel=lambda: k4.gl_ola_frame(frames, emit_signal=False, **geo),
        plain=lambda: k4.gl_ola_frame_plain(frames, emit_signal=False, **geo),
        checks=checks, tiles=lambda n: k4.gl_ola_frame(frames, emit_signal=False, tile=n, **geo),
        tile_options=(4, 8, 12, 16, 32), extra={"tile": k4.OLA_TILE},
        library=None, library_note=NO_LIBRARY, tol=1e-4, nbytes=4 * (2 * B * T * span + S),
        flops=B * T * span * (-(-span // geo["hop"]) + 1), iters=50)


def kernel_cases(dev):
    """One dict per kernel at its serving shapes: the kernel call, its plain
    version, a PyTorch library call or None, tolerance, bytes, FLOPs."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def unif(*shape, a):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * a

    return [case(randn, unif, dev) for case in
            (_case_lstm, _case_gru, _case_attention, _case_gl_project, _case_gl_ola_frame)]


def phase_kernels(dev):
    out = []
    with torch.no_grad():
        for c in kernel_cases(dev):
            err = max(max_err(kernel(), plain())
                      for kernel, plain in [(c["kernel"], c["plain"])] + c.get("checks", []))
            print(f"kernel {c['name']}: max_abs_err {err:.3e} (tol {c['tol']:.0e})", flush=True)
            if not err <= c["tol"]:
                raise SystemExit(f"chip_smoke: {c['name']} disagrees with its plain version")
            ms = device_ms(c["kernel"], c["iters"])
            eager_ms = time_ms(c["kernel"], c["iters"])
            plain_ms = device_ms(c["plain"], max(2, c["iters"] // 10))
            lib_ms = device_ms(c["library"], c["iters"]) if c["library"] else None
            bound_ms, bound_by = bound(c["nbytes"], c["flops"])
            row = {"name": c["name"], "route": "cuda", "source": c["source"],
                   "replaces": c["replaces"], "shapes": c["shapes"],
                   "launches": None, "max_abs_err": err, "max_err": err, "tol": c["tol"],
                   "ms": ms, "kernel_ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                   "library": c.get("library_note")}
            if "steps" in c:
                row["ms_per_step"] = ms / c["steps"]
            if "rows" in c:
                row["ms_by_rows"] = {r: device_ms(lambda r=r: c["rows"](r), c["iters"])
                                     for r in c["row_options"]}
            if "tiles" in c:
                row["ms_by_tile"] = {n: device_ms(lambda n=n: c["tiles"](n), c["iters"])
                                     for n in c["tile_options"]}
            row.update(c.get("extra", {}))
            out.append(row)
    return out


def serving_inputs(B, U, seed=0):
    """(text, sid) shaped like the JAX package's serving benches."""
    rng = np.random.RandomState(seed)
    text = np.zeros((B, U), np.int32)
    text[:, : U - 2] = rng.randint(3, 43, size=(B, U - 2))
    return text, rng.randint(0, 109, size=B).astype(np.int32)


def flagship_config(prenet_dropout=None):
    model = copy.deepcopy(FLAGSHIP_MODEL)
    model["codebook"]["phn_attr_pth"] = os.path.join(HERE, model["codebook"]["phn_attr_pth"])
    if prenet_dropout is not None:
        model["decoder"]["decoder"]["prenet_dropout"] = prenet_dropout
    return {"data": {"corpus": {"vocab_file": os.path.join(HERE, "data/cmu_phn.vocab"),
                                "spkr_map": os.path.join(HERE, "corpus_meta/spkr/lj_vctk.json")},
                     "audio": copy.deepcopy(FLAGSHIP_AUDIO)},
            "model": model}


def write_checkpoint(path, config):
    from semi_tts_tpu_torch.bridge import to_jax_params
    from semi_tts_tpu_torch.data.text import load_text_encoder
    from semi_tts_tpu_torch.models import vqvae as V
    from semi_tts_tpu_torch.train.checkpoint import save_checkpoint

    corpus = config["data"]["corpus"]
    with open(corpus["spkr_map"]) as f:
        n_spkr = len(json.load(f))
    vocab = load_text_encoder("phoneme", corpus["vocab_file"]).vocab_size
    cfg = V.config_from_yaml(config["model"], n_mels=80, linear_dim=1025, vocab_size=vocab,
                             n_spkr=n_spkr, attr_dim=31)
    model = V.VQVAE(cfg, generator=torch.Generator().manual_seed(0))
    params, state = to_jax_params(model)
    save_checkpoint(path, params=params, state=state, opt_state={}, step=0)
    return sum(p.numel() for p in model.parameters())


def phase_serving(build_dir):
    from semi_tts_tpu_torch import kernels
    from semi_tts_tpu_torch.serve import TTSServer

    ckpt = os.path.join(build_dir, "chip_smoke_ckpt.pth")
    try:
        n_params = write_checkpoint(ckpt, flagship_config())
        server = TTSServer.from_checkpoint(flagship_config(), ckpt)
        text, sid = serving_inputs(B, U)
        steps = server.decode_steps_for(text)
        server.synthesize(text, sid, key=1)  # warm-up: cuBLAS/cuDNN handles, bases
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        walls = []
        for i in range(REQUESTS):
            t0 = time.perf_counter()
            out = server.synthesize(text, sid, key=2 + i)  # returns on the host: synchronised
            walls.append(time.perf_counter() - t0)
            if i == 0:
                launches, wav = kernels.launch_counts(), out
        S = HOP * (steps * 3 - 1)
        if wav.shape != (B, S) or not np.isfinite(wav).all():
            raise SystemExit(f"chip_smoke: bad waveforms {wav.shape}, finite={np.isfinite(wav).all()}")
        if np.abs(wav).max() == 0.0:
            raise SystemExit("chip_smoke: all-zero waveforms")
        peak = torch.cuda.max_memory_allocated()
        wall = float(np.median(walls))
        idle = [n for n, c in launches.items() if c == 0]
        if idle:
            raise SystemExit(f"chip_smoke: kernels not launched on the main path: {idle}")
        stage_s = stage_times(server, text, sid, steps)
        profile = profiled_request(server, text, sid, wall)
        ref = reference_check(ckpt)
    finally:
        if os.path.exists(ckpt):
            os.remove(ckpt)
    return dict(batch=B, text_len=U, decode_steps=steps, frames=steps * 3, samples=S,
                params=n_params, wall_s=wall, walls_s=walls, utt_per_s=B / wall, peak_mem_bytes=peak,
                stage_s=stage_s, profile=profile, launches=launches, reference=ref)


def profiled_request(server, text, sid, wall):
    """One more request under torch.profiler: device busy time (the sum of
    the durations of device-side events: kernels and copies, on one stream),
    the idle share against the unprofiled median wall time, and the device
    time of the 16 busiest kernel names, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.synthesize(text, sid, key=99)
        profiled_wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:16]
    return {"profiled_wall_s": profiled_wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall,
            "top_device_ms": [[name[:70], n, us / 1e3] for name, (n, us) in top]}


def stage_times(server, text, sid, steps):
    """Wall seconds of the synthesis and vocoder stages of one more request,
    each ended by a synchronise."""
    synth, vocode = server.stages(steps)
    t, s = server._place(text, sid)
    g = server.generator(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    amp = synth(server.model, t, s, g)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    vocode(amp, g)
    torch.cuda.synchronize()
    return {"synth": t1 - t0, "vocode": time.perf_counter() - t1}


def reference_check(ckpt):
    """A small request through the card's kernels and through the plain path
    on the CPU, on the same checkpoint, prenet dropout 0 and the same phases."""
    from semi_tts_tpu_torch.serve import TTSServer

    config = flagship_config(prenet_dropout=0.0)
    gpu = TTSServer.from_checkpoint(config, ckpt)
    cpu = TTSServer.from_checkpoint(config, ckpt, device="cpu")
    text, sid = serving_inputs(2, 10, seed=3)
    steps = 4
    out = {}
    amps = []
    for srv in (gpu, cpu):
        synth, _ = srv.stages(steps)
        t, s = srv._place(text, sid)
        amps.append(synth(srv.model, t, s).cpu())
    rel = float(((amps[0] - amps[1]).abs() / amps[1].abs().clamp_min(1e-3)).max())
    phases = (torch.rand(amps[1].shape, generator=torch.Generator().manual_seed(4)) * 2 - 1) * math.pi
    wavs = [srv.stages(steps)[1](a.to(srv.device), phases=phases.to(srv.device)).cpu()
            for srv, a in ((gpu, amps[1]), (cpu, amps[1]))]
    out["amp_max_rel_err"] = rel
    out["amp_tol_rel"] = 1e-3
    out["wav_max_abs_err"] = float((wavs[0] - wavs[1]).abs().max())
    out["wav_tol"] = 1e-3
    if not (rel <= out["amp_tol_rel"] and out["wav_max_abs_err"] <= out["wav_tol"]):
        raise SystemExit(f"chip_smoke: card and CPU reference disagree: {out}")
    return out


def main():
    phase_device()
    from semi_tts_tpu_torch import kernels, use_fp32
    from semi_tts_tpu_torch.kernels.build import BUILD_DIR, LOGS

    use_fp32()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, {BUILD_DIR})", flush=True)
    print(json.dumps({"ptxas": ptxas_report(LOGS.get("rnn", ""))}), flush=True)
    table = phase_kernels(dev)
    print(json.dumps({"asr_shape": asr_lstm_check(dev)}), flush=True)
    serving = phase_serving(str(BUILD_DIR))
    for row in table:
        row["launches"] = serving["launches"][row["name"]]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
