"""The port's DSP, model-block and metric functions that no train or serve
path runs, each against its JAX counterpart on inputs drawn with numpy:
`ops/stft.py` (`hann_window`, `stft_complex`, `istft`, `nola_check`),
`ops/features.py` (`AudioFeaturizer.mfcc`, `cmvn`, `segment_features`,
`compute_len_ratio`), `models/common.py` (`MLP`, the conv-stack `Postnet`,
`sinusoid_encoding_table`, weights carried by `bridge`),
`utils/metrics.py` (`cal_ppx`, `mcd`) and `ops/ctc.py`
(`ctc_loss_autodiff`)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_tts_tpu.models import common as JC
from semi_tts_tpu.ops import ctc as JCTC
from semi_tts_tpu.ops import features as JF
from semi_tts_tpu.ops import stft as JS
from semi_tts_tpu.utils import metrics as JM
from semi_tts_tpu_torch import bridge
from semi_tts_tpu_torch.models import common as PC
from semi_tts_tpu_torch.ops import ctc as PCTC
from semi_tts_tpu_torch.ops import features as PF
from semi_tts_tpu_torch.ops import stft as PS
from semi_tts_tpu_torch.utils import metrics as PM
from helpers import synthesize_speech
from test_ctc import _rand_case
from test_features import _ref_features
from test_torch_features import CFG

SR = 22050
N_FFT, HOP, WIN = 2048, 275, 1102  # the flagship's 50 ms window and 12.5 ms hop
SMALL = dict(n_fft=512, hop=110, win_length=441)  # CFG's geometry (20 ms / 10 ms)
TOL = 1e-5  # of the largest magnitude: fp32 in another summation order


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _signal(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 0.3).astype(np.float32)


# ---------------- ops/stft.py ----------------

def test_hann_window_matches_jax_and_torch():
    got = PS.hann_window(WIN).numpy()
    np.testing.assert_allclose(got, np.asarray(JS.hann_window(WIN)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, torch.hann_window(WIN).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,geom", [((HOP * 40,), dict(n_fft=N_FFT, hop=HOP, win_length=WIN)),
                                        ((2, 3, 4000), SMALL)])
def test_stft_complex_matches_jax(shape, geom):
    x = _signal(shape, 1)
    want = np.asarray(JS.stft_complex(jnp.asarray(x), **geom))
    got = PS.stft_complex(_t(x), **geom).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def test_istft_roundtrip():
    """stft -> istft reproduces the signal (least squares) over the whole
    trimmed length, as the JAX test holds its istft."""
    L = HOP * 80
    x = _signal((L,), 2)
    y = PS.stft_complex(_t(x), n_fft=N_FFT, hop=HOP, win_length=WIN)
    back = PS.istft(y, n_fft=N_FFT, hop=HOP, win_length=WIN).numpy()
    assert back.shape == (HOP * (y.shape[0] - 1),)
    n = min(L, back.shape[0])
    np.testing.assert_allclose(back[:n], x[:n], atol=1e-3)


def test_istft_batched():
    x = _signal((3, HOP * 40), 3)
    y = PS.stft_complex(_t(x), n_fft=N_FFT, hop=HOP, win_length=WIN)
    back = PS.istft(y, n_fft=N_FFT, hop=HOP, win_length=WIN).numpy()
    assert back.shape[0] == 3
    np.testing.assert_allclose(back, x[:, :back.shape[1]], atol=1e-3)


@pytest.mark.parametrize("length", [None, HOP * 30 + 17])
def test_istft_matches_jax(length):
    """Both packages' istft of one complex spectrogram, with and without
    the ``length=`` trim."""
    x = _signal((2, HOP * 40), 4)
    y = np.asarray(JS.stft_complex(jnp.asarray(x), n_fft=N_FFT, hop=HOP, win_length=WIN))
    want = np.asarray(JS.istft(jnp.asarray(y), n_fft=N_FFT, hop=HOP, win_length=WIN,
                               length=length))
    got = PS.istft(_t(y), n_fft=N_FFT, hop=HOP, win_length=WIN, length=length).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def test_istft_matches_istft_reim():
    """The reference form against the Griffin-Lim GEMM form (`istft_reim`)."""
    x = _signal((2, HOP * 40), 5)
    y = PS.stft_complex(_t(x), n_fft=N_FFT, hop=HOP, win_length=WIN)
    want = PS.istft_reim(y.real.contiguous(), y.imag.contiguous(), n_fft=N_FFT, hop=HOP,
                         win_length=WIN).numpy()
    got = PS.istft(y, n_fft=N_FFT, hop=HOP, win_length=WIN).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("geom", [(N_FFT, HOP, WIN), (512, 110, 441), (400, 100, 400)])
def test_nola_check_equals_jax(geom):
    got = PS.nola_check(*geom)
    assert got == JS.nola_check(*geom) and got > 1e-11


# ---------------- ops/features.py ----------------

def test_mfcc_matches_jax():
    x = np.random.RandomState(6).rand(2, 30, CFG["num_mels"]).astype(np.float32) - 1.0
    want = np.asarray(JF.AudioFeaturizer(JF.AudioConfig(**CFG)).mfcc(jnp.asarray(x)))
    got = PF.AudioFeaturizer(PF.AudioConfig(**CFG), device="cpu").mfcc(_t(x)).numpy()
    assert got.shape == (2, 30, 39) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("axis", [-2, 0])
def test_cmvn_matches_jax(axis):
    x = np.random.RandomState(7).randn(40, 13).astype(np.float32) * 3 + 1
    want = np.asarray(JF.cmvn(jnp.asarray(x), axis=axis))
    got = PF.cmvn(_t(x), axis=axis).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("ratios,min_len", [([0.1, 0.15, 0.5, 0.52, 1.0], 2),
                                            ([0.3, 0.6, 1.0], 5)])
def test_segment_features_equals_jax(ratios, min_len):
    feat = np.random.RandomState(8).randn(50, 6).astype(np.float32)
    want = JF.segment_features(feat, ratios, min_len)
    got = PF.segment_features(feat, ratios, min_len)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_compute_len_ratio_equals_jax():
    for v in ("12_34_56", "3_3_10_40"):
        assert PF.compute_len_ratio(v) == JF.compute_len_ratio(v)


# ---------------- models/common.py ----------------

def _jax_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_mlp_matches_jax():
    params = JC.mlp_init(jax.random.PRNGKey(0), 12, (16, 8))
    x = np.random.RandomState(9).randn(3, 5, 12).astype(np.float32)
    port = bridge.load_jax_params(PC.MLP(12, (16, 8), generator=torch.Generator()),
                                  _jax_tree(params), {})
    for relu in (True, False):
        want = np.asarray(JC.mlp(params, jax.random.PRNGKey(1), jnp.asarray(x), relu=relu))
        got = PC.mlp(port, _t(x), relu=relu).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("train", [True, False])
def test_postnet_matches_jax(train):
    """The conv-stack postnet with train-mode BatchNorm (batch statistics
    and the running update) and eval-mode (the running statistics)."""
    params, state = JC.postnet_init(jax.random.PRNGKey(2), 10, 16, 5, 3)
    params, state = _jax_tree(params), _jax_tree(state)
    state["bn"][1]["mean"] = np.full(16, 0.3, np.float32)  # eval mode reads these
    state["bn"][1]["var"] = np.full(16, 2.0, np.float32)
    x = np.random.RandomState(10).randn(2, 20, 10).astype(np.float32)
    port = bridge.load_jax_params(PC.Postnet(10, 16, 5, 3, generator=torch.Generator()),
                                  params, state)
    want, want_s = JC.postnet_apply(params, state, jax.random.PRNGKey(3), jnp.asarray(x),
                                    drop_rate=0.0, train=train)
    got = PC.postnet_apply(port, _t(x), drop_rate=0.0, train=train).detach().numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    got_s = bridge._flatten(bridge.to_jax_params(port)[1])
    for path, v in bridge._flatten(_jax_tree(want_s)).items():
        np.testing.assert_allclose(got_s[path], v, rtol=TOL, atol=TOL, err_msg=path)


@pytest.mark.parametrize("padding_idx", [None, 0])
def test_sinusoid_encoding_table_matches_jax(padding_idx):
    want = np.asarray(JC.sinusoid_encoding_table(50, 24, padding_idx))
    got = PC.sinusoid_encoding_table(50, 24, padding_idx).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


# ---------------- utils/metrics.py ----------------

def test_cal_ppx_matches_jax():
    rng = np.random.RandomState(11)
    prob = rng.rand(3, 12, 43)
    prob /= prob.sum(-1, keepdims=True)
    prob[1, 8:] = 0.0  # padded frames
    np.testing.assert_allclose(PM.cal_ppx(prob), JM.cal_ppx(prob), rtol=1e-6)


def test_mcd_matches_jax():
    rng = np.random.RandomState(12)
    a, b = rng.rand(20, 80), rng.rand(20, 80)
    for skip in (True, False):
        np.testing.assert_allclose(PM.mcd(a, b, skip_c0=skip), JM.mcd(a, b, skip_c0=skip),
                                   rtol=1e-6)


def test_mcd_metric_properties():
    rng = np.random.RandomState(1)
    a = rng.rand(20, 80)
    assert PM.mcd(a, a) == 0.0
    assert PM.mcd(a, a + 0.001) < 1e-6  # +0.1 dB uniform offset, c0 excluded
    assert PM.mcd(a, a + rng.randn(20, 80) * 0.01) > 0.1


def test_featurizer_mcd_within_budget():
    """The port's featurizer (kernel K5's plain version on the CPU) against
    the reference math of the JAX test, in MCD: far inside 0.1 dB."""
    feat = PF.AudioFeaturizer(PF.AudioConfig(), device="cpu")
    L = 44100
    t = np.arange(L) / SR
    wave = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 660 * t)
            + 0.02 * np.random.RandomState(0).randn(L)).astype(np.float32)
    waves = np.zeros((1, 45000), np.float32)
    waves[0, :L] = wave
    mel, _, _ = feat.featurize(_t(waves), _t(np.asarray([L], np.int32)))
    want_mel, _ = _ref_features(wave)
    T = want_mel.shape[0]
    d = PM.mcd(mel.numpy()[0, :T], want_mel)
    assert d < 0.02, f"MCD {d} dB vs the reference math (budget 0.1 dB)"
    speech = synthesize_speech(1.0, seed=7, f0=135.0)
    mel, _, _ = feat.featurize(_t(speech[None]), _t(np.asarray([len(speech)], np.int32)))
    want_mel, _ = _ref_features(speech)
    assert PM.mcd(mel.numpy()[0, :want_mel.shape[0]], want_mel) < 0.02


# ---------------- ops/ctc.py ----------------

def _ctc_args(seed, **kw):
    lp, tg, il, tl = _rand_case(seed, **kw)
    return lp, tg, il, tl


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_ctc_autodiff_gradient_matches_jax(reduction):
    """The port's autodiff CTC gradient against JAX's autodiff CTC's."""
    for seed in (0, 3):
        lp, tg, il, tl = _ctc_args(seed, B=4, T=40, C=12, U=9)
        args = tuple(map(jnp.asarray, (tg, il, tl)))
        want = jax.grad(lambda x: JCTC.ctc_loss_autodiff(x, *args, reduction=reduction))(
            jnp.asarray(lp))
        x = _t(lp).requires_grad_(True)
        loss = PCTC.ctc_loss_autodiff(x, _t(tg), _t(il), _t(tl), reduction=reduction)
        loss.backward()
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=0, atol=1e-5,
                                   err_msg=f"seed {seed}")


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_autodiff_matches_ctc_loss(reduction):
    """Autograd through the alpha recursion against `ctc_loss`'s
    alpha-beta gradient (K6's plain versions on the CPU): loss and
    gradient."""
    lp, tg, il, tl = _ctc_args(5, B=3, T=30, C=10, U=8)
    w = torch.linspace(0.5, 1.5, 3)
    grads, losses = [], []
    for fn in (PCTC.ctc_loss, PCTC.ctc_loss_autodiff):
        x = _t(lp).requires_grad_(True)
        loss = fn(x, _t(tg), _t(il), _t(tl), reduction=reduction)
        (loss * w if reduction == "none" else loss).sum().backward()
        grads.append(x.grad.numpy())
        losses.append(loss.detach().numpy())
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    np.testing.assert_allclose(grads[1], grads[0], rtol=0, atol=1e-5)
