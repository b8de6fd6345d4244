"""The port's STFT pieces, Griffin-Lim (kernel K4 via its plain versions on
the CPU) and inverse pre-emphasis against `semi_tts_tpu.ops`."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_tts_tpu.ops import features as JF
from semi_tts_tpu.ops import griffin_lim as JG
from semi_tts_tpu.ops import stft as JS
from semi_tts_tpu_torch.kernels import griffin_lim as k4
from semi_tts_tpu_torch.ops import features as PF
from semi_tts_tpu_torch.ops import griffin_lim as PG
from semi_tts_tpu_torch.ops import stft as PS

# tiny geometry of tests/helpers.tiny_config: num_freq 257, 20 ms / 10 ms at 22.05 kHz
GEO = dict(n_fft=512, hop=220, win_length=441)


def _jax_phases(key, shape):
    """The initial phases exactly as `semi_tts_tpu.ops.griffin_lim` draws them."""
    return np.array(jax.random.uniform(key, shape, minval=-jnp.pi, maxval=jnp.pi))


def test_stft_istft_reim_match_jax():
    rng = np.random.RandomState(0)
    x = (0.3 * rng.randn(2, 2420)).astype(np.float32)  # speech-scale amplitudes
    re_j, im_j = JS.stft_reim(jnp.asarray(x), **GEO)
    re_p, im_p = PS.stft_reim(torch.from_numpy(x), **GEO)
    # the JAX basis is generated in float32 in-graph (~4e-7 from the float64
    # tables the port casts), so the spectrum agrees to ~1e-5 at this scale
    np.testing.assert_allclose(re_p.numpy(), np.asarray(re_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(im_p.numpy(), np.asarray(im_j), rtol=0, atol=1e-5)
    sig_j = JS.istft_reim(re_j, im_j, **GEO)
    sig_p = PS.istft_reim(re_p, im_p, **GEO)
    np.testing.assert_allclose(sig_p.numpy(), np.asarray(sig_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(sig_p.numpy(), x, rtol=0, atol=1e-5)  # perfect reconstruction


def test_window_support_and_envelope_match_jax():
    assert PS.window_support(2048, 1102) == JS.window_support(2048, 1102)
    np.testing.assert_array_equal(PS._static_ola_envelope(512, 220, 441, 12),
                                  JS._static_ola_envelope(512, 220, 441, 12))
    for got, want in zip(PS._inv_dft_basis_np(512, 441), JS._inv_dft_window_matrices(512, 441)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_iter", [0, 1, 30])
def test_griffin_lim_matches_jax(n_iter):
    rng = np.random.RandomState(1)
    mag = np.abs(rng.randn(2, 12, 257)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JG.griffin_lim(jnp.asarray(mag), key, n_iter=n_iter, **GEO))
    got = PG.griffin_lim(torch.from_numpy(mag), phases=torch.from_numpy(_jax_phases(key, mag.shape)),
                         n_iter=n_iter, **GEO).numpy()
    assert got.shape == (2, 220 * 11)
    # fp32 on both sides; 30 rounds divide by |z| each, measured ~3e-6 here
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_specgram_to_waveform_matches_jax():
    rng = np.random.RandomState(2)
    mag = np.abs(rng.randn(2, 15, 257)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(JG.specgram_to_waveform(jnp.asarray(mag), key, **GEO))
    got = PG.specgram_to_waveform(torch.from_numpy(mag),
                                  phases=torch.from_numpy(_jax_phases(key, mag.shape)),
                                  **GEO).numpy()
    # the inverse pre-emphasis IIR amplifies Griffin-Lim's ~3e-6 difference by
    # up to 1 / (1 - 0.97) = 33x; measured ~4e-6 here, so 1e-4 rather than 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_inv_preemphasis_matches_jax_and_lfilter():
    from scipy.signal import lfilter

    rng = np.random.RandomState(3)
    wav = (0.3 * rng.randn(2, 3001)).astype(np.float32)  # two scan levels of 256
    want = np.asarray(JF.inv_preemphasis(jnp.asarray(wav), 0.97))
    got = PF.inv_preemphasis(torch.from_numpy(wav), 0.97).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    long = (0.3 * rng.randn(2, 70001)).astype(np.float32)  # three levels
    np.testing.assert_allclose(PF.inv_preemphasis(torch.from_numpy(long), 0.97).numpy(),
                               lfilter([1.0], [1.0, -0.97], long.astype(np.float64)),
                               rtol=0, atol=1e-5)


def test_spectral_transforms_match_jax():
    rng = np.random.RandomState(4)
    lin = rng.rand(2, 5, 7).astype(np.float32) * 1.2 - 0.1
    feat = JF.AudioFeaturizer(JF.AudioConfig(num_freq=257, num_mels=20))
    want = np.asarray(feat.linear_to_amp(jnp.asarray(lin)))
    got = PF.linear_to_amp(torch.from_numpy(lin)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    amp = np.abs(rng.randn(4, 6)).astype(np.float32)
    np.testing.assert_allclose(PF.normalize_db(PF.amp_to_db(torch.from_numpy(amp))).numpy(),
                               np.asarray(JF.normalize_db(JF.amp_to_db(jnp.asarray(amp)))),
                               rtol=1e-6, atol=1e-7)


def test_audio_config_mirrors_jax():
    for kw in ({}, dict(num_freq=257, num_mels=20, frame_length_ms=20, frame_shift_ms=10)):
        j, p = JF.AudioConfig(**kw), PF.AudioConfig(**kw)
        for name in ("n_fft", "hop_length", "win_length", "num_mels", "num_freq",
                     "preemphasis_coeff", "sample_rate"):
            assert getattr(p, name) == getattr(j, name), name


def test_k4_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the K4 wrappers return their plain versions exactly
    and count no launch; the plain OLA+framing equals the stft pieces."""
    rng = np.random.RandomState(5)
    span = GEO["win_length"]
    inv = torch.from_numpy(rng.randn(2, 12, span).astype(np.float32))
    reim = torch.from_numpy(rng.randn(2, 12, 2 * 257).astype(np.float32))
    reim[0, 0, :5] = 0.0
    reim[0, 0, 257:262] = 0.0
    mag = torch.from_numpy(np.abs(rng.randn(2, 12, 257)).astype(np.float32))
    before = (k4.gl_project.launches, k4.gl_ola_frame.launches)
    y = k4.gl_project(reim, mag)
    torch.testing.assert_close(y, k4.gl_project_plain(reim, mag), rtol=0, atol=0)
    torch.testing.assert_close(y[0, 0, :5], mag[0, 0, :5], rtol=0, atol=0)  # angle(0) = 0
    assert torch.all(y[0, 0, 257:262] == 0)
    for emit in (False, True):
        got = k4.gl_ola_frame(inv, emit_signal=emit, **GEO)
        sig = PS.overlap_add(inv, **GEO)
        torch.testing.assert_close(got, sig if emit else PS.frame_reflect(sig, **GEO),
                                   rtol=0, atol=0)
    assert (k4.gl_project.launches, k4.gl_ola_frame.launches) == before


# (n_fft, hop, win_length): the flagship's, the tiny config's, and one short
# enough that two frames can be reflect-padded
OLA_GEOMETRIES = {"flagship": (2048, 275, 1102), "tiny": (512, 220, 441), "short": (8, 6, 7)}
OLA_CASES = [(g, T) for g in ("flagship", "tiny") for T in (5, 7, 300)] + \
            [("short", T) for T in (2, 5, 7, 300)]


def _ola_geometry(name):
    n_fft, hop, win = OLA_GEOMETRIES[name]
    off, span = PS.window_support(n_fft, win)
    return dict(span=span, hop=hop, off=off, half=n_fft // 2), dict(n_fft=n_fft, hop=hop,
                                                                    win_length=win)


def _reflect(x, S):
    x = np.abs(x)
    return np.where(x >= S, 2 * (S - 1) - x, x)


@pytest.mark.parametrize("tile", [1, 8, 32, "T+3"])
@pytest.mark.parametrize("geo,T", OLA_CASES)
def test_ola_plan_tiles(geo, T, tile):
    """Tiles cover the frames once; each segment is exactly the span of the
    reflected signal indices its frames read; every inverse frame that
    overlaps the segment is among those the tile reads; the signal stretches
    of the last round partition the signal."""
    g, _ = _ola_geometry(geo)
    span, hop, off, half = g["span"], g["hop"], g["off"], g["half"]
    S = hop * (T - 1)
    plan = k4.ola_plan(T, **g, tile=T + 3 if tile == "T+3" else tile)
    tiles = plan["tiles"]
    assert plan["grid_x"] == len(tiles)
    assert [t for tl in tiles for t in range(tl["t0"], tl["t1"])] == list(range(T))
    assert [s for tl in tiles for s in range(tl["sig_lo"], tl["sig_hi"])] == list(range(S))
    t_all = np.arange(T)
    starts = t_all * hop + off - half          # signal position of each inverse frame's start
    for tl in tiles:
        x = (np.arange(tl["t0"], tl["t1"])[:, None] * hop + off - half + np.arange(span)[None, :])
        read = _reflect(x, S)
        assert (tl["seg_lo"], tl["seg_hi"]) == (read.min(), read.max())
        overlaps = t_all[(starts <= tl["seg_hi"]) & (starts + span - 1 >= tl["seg_lo"])]
        assert tl["f_lo"] <= overlaps.min() and overlaps.max() <= tl["f_hi"]
    assert plan["smem_bytes"] == 4 * max(tl["seg_hi"] - tl["seg_lo"] + 1 for tl in tiles)


def _ola_frame_tiled(frames, env, plan, g, emit_signal):
    """The algorithm of csrc/griffin_lim.cu `gl_ola_frame_kernel` in numpy:
    per tile, the overlap-add of its segment summed from the highest frame
    down, divided by the envelope once, then framed out of the segment."""
    B, T, span = frames.shape
    hop, off, half = g["hop"], g["off"], g["half"]
    S = hop * (T - 1)
    out = np.zeros((B, S) if emit_signal else (B, T, span), np.float32)
    for tl in plan["tiles"]:
        lo, hi = (tl["sig_lo"], tl["sig_hi"] - 1) if emit_signal else (tl["seg_lo"], tl["seg_hi"])
        rel = np.arange(lo, hi + 1) + half - off
        acc = np.zeros((B, hi - lo + 1), np.float32)
        for t in range(T - 1, -1, -1):
            e = rel - t * hop
            ok = (e >= 0) & (e < span)
            acc[:, ok] += frames[:, t, e[ok]]
        seg = acc / env[lo : hi + 1]
        if emit_signal:
            out[:, lo : hi + 1] = seg
            continue
        for t in range(tl["t0"], tl["t1"]):
            out[:, t] = seg[:, _reflect(t * hop + off - half + np.arange(span), S) - lo]
    return out


@pytest.mark.parametrize("emit_signal", [False, True])
@pytest.mark.parametrize("geo,T,tile", [("flagship", 5, 1), ("flagship", 5, 8), ("flagship", 7, 3),
                                        ("flagship", 300, 32), ("tiny", 7, 2), ("short", 2, 1),
                                        ("short", 7, 4)])
def test_tiled_ola_frame_is_bit_identical_to_plain(geo, T, tile, emit_signal):
    """The tiled overlap-add keeps the plain version's summation order, so
    the kernel's algorithm equals `gl_ola_frame_plain` exactly."""
    g, stft_geo = _ola_geometry(geo)
    frames = np.random.RandomState(T).randn(2, T, g["span"]).astype(np.float32)
    env = PS.trimmed_envelope(stft_geo["n_fft"], g["hop"], stft_geo["win_length"], T, "cpu").numpy()
    got = _ola_frame_tiled(frames, env, k4.ola_plan(T, **g, tile=tile), g, emit_signal)
    want = k4.gl_ola_frame_plain(torch.from_numpy(frames), emit_signal=emit_signal, **stft_geo)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("T,tile", [(1, None), (5, 0)])
def test_ola_plan_raises(T, tile):
    g, _ = _ola_geometry("flagship")
    with pytest.raises(ValueError):
        k4.ola_plan(T, **g, tile=tile)
