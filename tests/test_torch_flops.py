"""`semi_tts_tpu_torch/utils/flops.py` against `semi_tts_tpu/utils/flops.py`.

`matmul_flops` counts the matrix-product and convolution FLOPs of one call:
the JAX module from the jaxpr (scans at their trip count), the port from
one eager call under `FlopCounterMode`, with each kernel wrapper adding the
dot FLOPs of the JAX function its kernel replaces (on the CPU the wrapper
runs its plain version, whose own products the counter leaves out). Each
case runs the same computation on the same shapes through both packages,
and the counts must be equal: the cases of tests/test_flops.py, then the
recurrences (both routes' wrappers), the attention step, CTC, the
featurizer, Griffin-Lim, trim/merge, the decoder in inference and a whole
paired train step at tests/helpers.tiny_config's widths."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from semi_tts_tpu.models import attention as JA
from semi_tts_tpu.models import decoder as JD
from semi_tts_tpu.ops import ctc as JC
from semi_tts_tpu.ops import griffin_lim as JG
from semi_tts_tpu.ops import rnn as JR
from semi_tts_tpu.ops.quantize import trim_merge_segments as j_trim_merge
from semi_tts_tpu.utils.flops import matmul_flops as jax_flops
from semi_tts_tpu_torch.bridge import load_jax_params, to_jax_params
from semi_tts_tpu_torch.models import attention as PA
from semi_tts_tpu_torch.models import decoder as PD
from semi_tts_tpu_torch.ops import ctc as PC
from semi_tts_tpu_torch.ops import griffin_lim as PG
from semi_tts_tpu_torch.ops import rnn as PR
from semi_tts_tpu_torch.ops.quantize import trim_merge_segments as p_trim_merge
from semi_tts_tpu_torch.utils.flops import matmul_flops


# ---- the cases of tests/test_flops.py ----

def _j_scan7(a, b):
    out, _ = jax.lax.scan(lambda c, _: (c @ b, ()), a, None, length=7)
    return out


def _p_loop(n):
    def f(a, b):
        for _ in range(n):
            a = a @ b
        return a
    return f


def _p_grad(a, b):
    a = a.clone().requires_grad_(True)
    return torch.autograd.grad((a @ b).sum(), a)


def _j_conv(x, k):
    return jax.lax.conv_general_dilated(x, k, (1,), "VALID",
                                        dimension_numbers=("NCH", "OIH", "NCH"))


_inner = jax.jit(lambda a, b: a @ b)

BASIC = {  # name: (JAX fn, port fn, shapes, the count tests/test_flops.py names)
    "matmul": (lambda a, b: a @ b, lambda a, b: a @ b, [(64, 32), (32, 16)], 2 * 64 * 32 * 16),
    "einsum": (lambda a, b: jnp.einsum("btn,nf->btf", a, b),
               lambda a, b: torch.einsum("btn,nf->btf", a, b), [(2, 3, 5), (5, 7)],
               2 * 2 * 3 * 5 * 7),
    "loop of 7": (_j_scan7, _p_loop(7), [(8, 8), (8, 8)], 7 * 2 * 8 * 8 * 8),
    "loop of 5": (lambda a, b: jax.lax.fori_loop(0, 5, lambda i, c: c @ b, a), _p_loop(5),
                  [(8, 8), (8, 8)], 5 * 2 * 8 * 8 * 8),
    "grad": (jax.grad(lambda a, b: jnp.sum(a @ b)), _p_grad, [(4, 4), (4, 4)],
             2 * 2 * 4 * 4 * 4),
    "conv": (_j_conv, F.conv1d, [(2, 3, 10), (4, 3, 3)], 2 * 2 * 4 * 8 * 3 * 3),
    "nested": (lambda a, b: _inner(a, b) + _inner(a, b), lambda a, b: a @ b + a @ b,
               [(8, 8), (8, 8)], 2 * 2 * 8 * 8 * 8),
}


@pytest.mark.parametrize("name", sorted(BASIC))
def test_basic_cases_match_jax(name):
    jfn, pfn, shapes, want = BASIC[name]
    got = matmul_flops(pfn, *(torch.ones(s) for s in shapes))
    assert got == jax_flops(jfn, *(jnp.ones(s) for s in shapes)) == want


# ---- the port's modules at tiny_config widths ----

def _rng_inputs(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("H", [8, 258])  # the ASR encoder's rnn_dim; past K1's plans
def test_lstm_layer_matches_jax(H, grad):
    """A bidirectional LSTM layer (the ASR encoder's, input 16) on B=2 x
    T=9, forward, and the gradient of every weight and the input."""
    B, T, D = 2, 9, 16
    layers = PR.multi_lstm_init(D, H, 1, True, generator=torch.Generator().manual_seed(0))
    params = to_jax_params(layers)[0]
    xs, cot = _rng_inputs(1, (B, T, D), (B, T, 2 * H))
    if not grad:
        want = jax_flops(JR.multi_lstm, params, jnp.asarray(xs))
        got = matmul_flops(lambda: PR.multi_lstm(layers, torch.from_numpy(xs)))
    else:
        want = jax_flops(jax.grad(lambda p, x: jnp.sum(JR.multi_lstm(p, x) * cot), (0, 1)),
                         params, jnp.asarray(xs))

        def port():
            x = torch.from_numpy(xs).requires_grad_(True)
            out = (PR.multi_lstm(layers, x) * torch.from_numpy(cot)).sum()
            return torch.autograd.grad(out, [*layers.parameters(), x])
        got = matmul_flops(port)
    assert got == want


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("H", [20, 129])  # the CBHG's GRU at tiny widths; past K2's plan
def test_gru_layer_matches_jax(H, grad):
    """The CBHG's bidirectional GRU (input H) on B=2 x T=9, forward, and
    the gradient of every weight and the input."""
    B, T = 2, 9
    g = torch.Generator().manual_seed(1)
    gru = torch.nn.ModuleDict({"fwd": PR.GRUParams(H, H, g), "bwd": PR.GRUParams(H, H, g)})
    params = to_jax_params(gru)[0]
    xs, cot = _rng_inputs(2, (B, T, H), (B, T, 2 * H))
    if not grad:
        want = jax_flops(JR.bigru, params, jnp.asarray(xs))
        got = matmul_flops(lambda: PR.bigru(gru, torch.from_numpy(xs)))
    else:
        want = jax_flops(jax.grad(lambda p, x: jnp.sum(JR.bigru(p, x) * cot), (0, 1)),
                         params, jnp.asarray(xs))

        def port():
            x = torch.from_numpy(xs).requires_grad_(True)
            return torch.autograd.grad((PR.bigru(gru, x) * torch.from_numpy(cot)).sum(),
                                       [*gru.parameters(), x])
        got = matmul_flops(port)
    assert got == want


@pytest.mark.parametrize("grad", [False, True])
def test_attention_step_matches_jax(grad):
    """The decoder's location-sensitive attention step at tiny widths
    (query 16, memory 16, attention 8, 4 filters of 7, both weight rows), B=2
    x L=9: forward, and the gradient of every weight and input."""
    B, L, Q, D, A, Fl, K = 2, 9, 16, 16, 8, 4, 7
    attn = PA.Attention(Q, D, A, Fl, K, loc_aware=True, use_summed_weights=True,
                        generator=torch.Generator().manual_seed(2))
    params = to_jax_params(attn)[0]
    query, memory, cot = _rng_inputs(3, (B, Q), (B, L, D), (B, D))
    hist = np.abs(_rng_inputs(4, (B, 2, L))[0])

    def jax_fn(p, q, m, h):
        ctx, w = JA.attention_step(p, q, m, JA.process_memory(p, m), h)
        return jnp.sum(ctx * cot) + jnp.sum(w)

    def port_fn(q, m, h):
        ctx, w = PA.attention_step(attn, q, m, PA.process_memory(attn, m), h)
        return (ctx * torch.from_numpy(cot)).sum() + w.sum()

    args = (query, memory, hist)
    if not grad:
        want = jax_flops(jax_fn, params, *map(jnp.asarray, args))
        with torch.no_grad():
            got = matmul_flops(port_fn, *map(torch.from_numpy, args))
    else:
        want = jax_flops(jax.grad(jax_fn, (0, 1, 2, 3)), params, *map(jnp.asarray, args))

        def port():
            ins = [torch.from_numpy(a).requires_grad_(True) for a in args]
            return torch.autograd.grad(port_fn(*ins), [*attn.parameters(), *ins])
        got = matmul_flops(port)
    assert got == want


def test_ctc_loss_matches_jax():
    """CTC's loss and its gradient (B=4, T=12, 7 classes, U=4): the
    backward's one-hot product, which K6's `ctc_beta_grad` replaces."""
    rng = np.random.RandomState(5)
    logits = rng.randn(4, 12, 7).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    targets = rng.randint(1, 7, size=(4, 4)).astype(np.int32)
    ilen, tlen = np.full(4, 12, np.int32), np.array([4, 3, 2, 4], np.int32)
    jargs = tuple(map(jnp.asarray, (targets, ilen, tlen)))
    want = jax_flops(jax.value_and_grad(lambda x: JC.ctc_loss(x, *jargs)), jnp.asarray(lp))

    def port():
        x = torch.from_numpy(lp).requires_grad_(True)
        loss = PC.ctc_loss(x, *map(torch.from_numpy, (targets, ilen, tlen)))
        return torch.autograd.grad(loss, x)
    got = matmul_flops(port)
    assert got == want == 2 * 4 * 12 * (2 * 4 + 1) * 7


def _waves(lengths, S=11025, seed=7):
    """Noise rows zero past each length (the counts do not read values)."""
    waves = 0.1 * np.random.RandomState(seed).randn(len(lengths), S).astype(np.float32)
    for b, n in enumerate(lengths):
        waves[b, n:] = 0.0
    return waves, np.asarray(lengths, np.int32)


def test_featurizer_matches_jax():
    """The featurizer's clean path at tiny widths (257 bins, 20 mels) on 3
    rows of up to 0.5 s: the DFT and mel products (K5 adds none)."""
    from semi_tts_tpu.ops.features import AudioConfig as JAudio
    from semi_tts_tpu.ops.features import AudioFeaturizer as JFeat
    from semi_tts_tpu_torch.ops.features import AudioConfig as PAudio
    from semi_tts_tpu_torch.ops.features import AudioFeaturizer as PFeat
    from test_torch_features import CFG

    waves, lengths = _waves((11025, 7000, 4410))
    jf = JFeat(JAudio(**CFG, dft_precision="highest"))
    pf = PFeat(PAudio(**CFG), device="cpu")
    want = jax_flops(jf.featurize, jnp.asarray(waves), jnp.asarray(lengths))
    got = matmul_flops(pf.featurize, torch.from_numpy(waves), torch.from_numpy(lengths))
    assert got == want


def test_griffin_lim_matches_jax():
    """Griffin-Lim, 4 rounds at n_fft 512 (257 bins, hop 220, window 441) on
    B=2 x 12 frames: the forward and inverse DFT products of every round
    (K4 adds none)."""
    from test_torch_griffin_lim import GEO, _jax_phases

    mag = np.abs(_rng_inputs(6, (2, 12, 257))[0])
    key = jax.random.PRNGKey(3)
    want = jax_flops(lambda m: JG.griffin_lim(m, key, n_iter=4, **GEO), jnp.asarray(mag))
    phases = torch.from_numpy(_jax_phases(key, mag.shape))
    got = matmul_flops(lambda: PG.griffin_lim(torch.from_numpy(mag), phases=phases, n_iter=4,
                                              **GEO))
    assert got == want


def test_trim_merge_matches_jax():
    """The speech-first step's segment trim/merge and its gradient (B6): no
    product in either package."""
    from test_quantize import _case

    p, latent = _case(0)
    want = jax_flops(jax.grad(lambda lat: jnp.sum(j_trim_merge(jnp.asarray(p), lat,
                                                               max_frames_per_phn=3)[0])),
                     jnp.asarray(latent))

    def port():
        lat = torch.from_numpy(latent).requires_grad_(True)
        out = p_trim_merge(torch.from_numpy(p), lat, max_frames_per_phn=3)[0]
        return torch.autograd.grad(out.sum(), lat)
    assert matmul_flops(port) == want == 0


def test_decoder_inference_matches_jax():
    """The TTS decoder's autoregressive inference at tiny widths (10 steps,
    AdaIN speaker conditioning, B=2 x 9 memory positions): the prenet,
    both LSTM cells, the attention step (K3) and the projections of every
    step."""
    from test_torch_models import STEPS, _gen, _jax_weights

    base = dict(n_mels=20, n_frames_per_step=3, enc_embed_dim=16, spkr_embed_dim=8,
                prenet_dim=8, prenet_dropout=0.0, query_rnn_dim=16, dec_rnn_dim=16,
                attn_dim=8, n_location_filters=4, location_kernel_size=7)
    jcfg, pcfg = JD.DecoderConfig(**base), PD.DecoderConfig(**base)
    params, _ = _jax_weights(PD.Decoder(pcfg, generator=_gen(2)))
    dec = load_jax_params(PD.Decoder(pcfg, generator=_gen(3)), params, {})
    memory, spk = _rng_inputs(4, (2, 9, 16), (2, 8))
    want = jax_flops(lambda m, s: JD.decoder_apply(params, jax.random.PRNGKey(0), m, s, cfg=jcfg,
                                                   decode_steps=STEPS, train=False, teacher=None,
                                                   tf_rate=0.0),
                     jnp.asarray(memory), jnp.asarray(spk))
    with torch.no_grad():
        got = matmul_flops(lambda: PD.decoder_apply(dec, torch.from_numpy(memory),
                                                    torch.from_numpy(spk), cfg=pcfg,
                                                    decode_steps=STEPS))
    assert got == want


def test_paired_step_matches_jax():
    """A paired train step of the tiny VQVAE (B=2 x 0.5 s, U=6): the
    featurizer's clean and augmented paths, the ASR (its BiLSTM, K1 and K7),
    CTC (K6), the TTS encoder and the teacher-forced decoder (K2, K8, K3,
    K9 and the probes' weight gradients), the postnet and every backward
    product: JAX's `make_paired_step` with its Adam update stubbed out and
    the port's `paired_loss_and_grads`, the step's body before its update
    (an update has no product; left out, it spares the trace ~5 s)."""
    from semi_tts_tpu.ops.features import AudioConfig as JAudio
    from semi_tts_tpu.ops.features import AudioFeaturizer as JFeat
    from semi_tts_tpu.train.steps import StepBuilder as JBuilder
    from semi_tts_tpu.train.steps import Weights as JWeights
    from semi_tts_tpu_torch.ops.features import AudioConfig as PAudio
    from semi_tts_tpu_torch.ops.features import AudioFeaturizer as PFeat
    from semi_tts_tpu_torch.train.steps import StepBuilder as PBuilder
    from semi_tts_tpu_torch.train.steps import Weights
    from test_torch_features import CFG
    from test_torch_train_paired import FLOSS, _paired_model

    jcfg, pcfg, params, state, port, phn_attr = _paired_model()
    jb = JBuilder(jcfg, JFeat(JAudio(**CFG, dft_precision="highest")), jnp.asarray(phn_attr), None,
                  weights=JWeights(), freq_loss_kwargs=FLOSS)
    pb = PBuilder(pcfg, PFeat(PAudio(**CFG), device="cpu"), torch.from_numpy(phn_attr),
                  weights=Weights(), freq_loss_kwargs=FLOSS)
    waves, lengths = _waves((11025, 8025))
    text = np.asarray([[5, 9, 3, 12, 0, 0], [7, 4, 22, 31, 8, 14]], np.int32)
    sid = np.asarray([2, 0], np.int32)
    jb._apply_updates = lambda p, opt_state, grads: (p, opt_state, jnp.float32(0.0))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = jax_flops(jb.make_paired_step(), jp, jax.tree_util.tree_map(jnp.asarray, state), (),
                     jax.random.PRNGKey(1), 0, 1.0, *map(jnp.asarray, (waves, lengths, text, sid)))
    got = matmul_flops(pb.paired_loss_and_grads, port,
                       *map(torch.from_numpy, (waves, lengths, text, sid)), 1.0,
                       torch.Generator().manual_seed(0))
    # The one difference: JAX's decoder scan transposes every step alike,
    # while the port's autograd skips the products whose cotangent reaches
    # only the first decode step's constant inputs (the two cells' zero
    # initial states, the zero go frame into the prenet): 12,544 of ~2e8
    # FLOPs here, 0.006%.
    assert 0 <= want - got <= 0.005 * want
