"""The port's featurizer (`semi_tts_tpu_torch/ops/features.py`, kernel K5
through its plain version on the CPU) and STFT pieces against
`semi_tts_tpu.ops.features`/`.stft` on the same seeded inputs. The JAX
featurizer runs at ``dft_precision="highest"`` (fp32), as the port does."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import synthesize_speech
from semi_tts_tpu.ops import features as JF
from semi_tts_tpu.ops import mel as JM
from semi_tts_tpu.ops import stft as JS
from semi_tts_tpu_torch.kernels import features as K5
from semi_tts_tpu_torch.ops import features as PF
from semi_tts_tpu_torch.ops import mel as PM
from semi_tts_tpu_torch.ops import stft as PS

# normalized dB in [0, 1] (dB / 100): fp32 DFTs summed in another order differ
# by ~1e-6 relative in magnitude, ~1e-8 after dB/100, but a bin near the
# 1e-5 amplitude floor is a sum that cancels to ~1e-4 of its terms, where the
# order moves the magnitude by up to ~1e-3 relative: 1.2e-4 measured
ATOL = 5e-4
CFG = dict(num_freq=257, num_mels=20, frame_length_ms=20, frame_shift_ms=10,
           preemphasis_coeff=0.97, sample_rate=22050, use_linear=True,
           snr_range=(10, 100), time_stretch_range=(0.9, 1.1))
LEVELS = dict(min_db=PF.MIN_LEVEL_DB, ref_db=PF.REF_LEVEL_DB)


def _batch(lengths=(11025, 7000, 4410), S=11025):
    waves = np.zeros((len(lengths), S), np.float32)
    for b, n in enumerate(lengths):
        waves[b, :n] = synthesize_speech(n / 22050, seed=b)[:n]
    return waves, np.asarray(lengths, np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def featurizers():
    return (JF.AudioFeaturizer(JF.AudioConfig(**CFG, dft_precision="highest")),
            PF.AudioFeaturizer(PF.AudioConfig(**CFG), device="cpu"))


def test_featurizer_without_device_raises_on_cpu_host():
    """The featurizer's tables go to the card unless the caller passes
    ``device="cpu"``; a host without one raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PF.AudioFeaturizer(PF.AudioConfig(**CFG))
    assert PF.AudioFeaturizer(PF.AudioConfig(**CFG), device="cpu").device.type == "cpu"


def test_featurize_matches_jax(featurizers):
    jf, pf = featurizers
    waves, lengths = _batch()
    want = jf.featurize(jnp.asarray(waves), jnp.asarray(lengths))
    got = pf.featurize(torch.from_numpy(waves), torch.from_numpy(lengths))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
    _close(got[0], want[0])
    _close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("rate", [0.9, 0.97, 1.1])
def test_featurize_augmented_at_matches_jax(featurizers, rate):
    """Same snrs, rate and noise: JAX draws the noise from the key it is
    given; the port is handed that draw."""
    jf, pf = featurizers
    waves, lengths = _batch((11025, 9000, 6000))
    snrs = np.asarray([15.0, 40.0, 90.0], np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, waves.shape, jnp.float32))
    want = jf.featurize_augmented_at(jnp.asarray(waves), jnp.asarray(lengths),
                                     jnp.asarray(snrs), jnp.float32(rate), key)
    got = pf.featurize_augmented_at(torch.from_numpy(waves), torch.from_numpy(lengths),
                                    torch.from_numpy(snrs), rate, torch.from_numpy(noise))
    assert tuple(got[0].shape) == tuple(want[0].shape)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_featurize_augmented_draws_from_the_generator(featurizers):
    _, pf = featurizers
    waves, lengths = map(torch.from_numpy, _batch())
    a = pf.featurize_augmented(waves, lengths, torch.Generator().manual_seed(1))
    b = pf.featurize_augmented(waves, lengths, torch.Generator().manual_seed(1))
    c = pf.featurize_augmented(waves, lengths, torch.Generator().manual_seed(2))
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert a[0].shape == (3, 1 + 11025 // pf.cfg.min_stretch_hop, 20)


@pytest.mark.parametrize("cfg", [CFG, dict(CFG, num_freq=1025, num_mels=80, frame_length_ms=50,
                                           frame_shift_ms=12.5)])
def test_audio_config_properties_match_jax(cfg):
    j, p = JF.AudioConfig(**cfg), PF.AudioConfig(**cfg)
    for name in ("n_fft", "hop_length", "win_length", "use_noise", "min_stretch_hop",
                 "max_stretch_win"):
        assert getattr(p, name) == getattr(j, name), name


@pytest.mark.parametrize("lengths", [(64, 50, 33), (64, 64, 64)])
def test_reflect_pad_ragged_matches_jax(lengths):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 64).astype(np.float32)
    L = np.asarray(lengths, np.int32)
    want = JS.reflect_pad_ragged(jnp.asarray(x), jnp.asarray(L), 16)
    got = PS.reflect_pad_ragged(torch.from_numpy(x), torch.from_numpy(L), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hop,num_frames", [(7, 10), (7, 14), (5, 30)])
def test_frame_signal_matches_jax_static_and_traced(hop, num_frames):
    """Static hop zero-pads a frame past the end; a traced hop clamps its
    start (`frame_signal_static` notes the difference). (7, 14) and (5, 30)
    overrun the padded signal."""
    rng = np.random.RandomState(1)
    xp = rng.randn(2, 80).astype(np.float32)
    sup = (3, 20)
    want_s = JS.frame_signal(jnp.asarray(xp), 26, hop, num_frames, support=sup)
    got_s = PS.frame_signal(torch.from_numpy(xp), 26, hop, num_frames, support=sup)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    want_t = jax.jit(lambda x, h: JS.frame_signal(x, 26, h, num_frames, support=sup))(
        jnp.asarray(xp), jnp.int32(hop))
    got_t = PS.frame_signal(torch.from_numpy(xp), 26, torch.tensor(hop), num_frames, support=sup)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


@pytest.mark.parametrize("win", [441, 400, 485])
def test_dynamic_hann_window_matches_jax(win):
    want = JS.dynamic_hann_window(512, jnp.int32(win))
    got = PS.dynamic_hann_window(512, torch.tensor(win))
    _close(got, want, atol=1e-7)


@pytest.mark.parametrize("win", [441, "traced"])
def test_stft_magnitude_matches_jax(win):
    """|STFT| as the featurizer forms it (K5 frames with pre-emphasis off,
    the support DFT GEMM, `spec_db`'s magnitude) against JAX
    `stft_magnitude` at a static window and a traced one."""
    waves, lengths = _batch()
    kw = dict(n_fft=512, hop=220, num_frames=1 + waves.shape[1] // 220)
    flen = 1 + lengths // 220
    if win == "traced":
        want = jax.jit(lambda x, l, w: JS.stft_magnitude(x, l, win_length=w, frame_lengths=flen,
                                                         **kw))(
            jnp.asarray(waves), jnp.asarray(lengths), jnp.int32(441))
    else:
        want = JS.stft_magnitude(jnp.asarray(waves), jnp.asarray(lengths), win_length=win,
                                 frame_lengths=jnp.asarray(flen), **kw)
    sup = PS.window_support(512, 441)
    frames = K5.stft_frames(torch.from_numpy(waves), torch.from_numpy(lengths),
                            torch.tensor([220, 441], dtype=torch.int32), n_fft=512, support=sup,
                            num_frames=kw["num_frames"], clamp=win == "traced", coeff=0.0)
    reim = frames @ PS.support_dft_basis(512, *sup, torch.device("cpu"))
    got, _ = K5.spec_db(reim, torch.from_numpy(flen), reim=True, db=False, **LEVELS)
    _close(got, want, atol=1e-4 * float(np.abs(np.asarray(want)).max()))


def test_mel_filterbank_copy_matches_jax():
    for sr, n_fft, m in ((22050, 2048, 80), (22050, 512, 20), (16000, 400, 40)):
        np.testing.assert_array_equal(PM.mel_filterbank(sr, n_fft, n_mels=m),
                                      JM.mel_filterbank(sr, n_fft, n_mels=m))
    fb = JM.mel_filterbank(22050, 512, n_mels=20)
    np.testing.assert_array_equal(PM.mel_pinv(fb), JM.mel_pinv(fb))
    np.testing.assert_array_equal(PM.dct_matrix(13, 20), JM.dct_matrix(13, 20))


def test_spec_db_plain_modes():
    """[re | im] -> magnitude and normalized dB; amplitude -> dB; zero past
    each row's frame length; the dB output of an amplitude equals the JAX
    finalize."""
    rng = np.random.RandomState(2)
    reim = torch.from_numpy(rng.randn(2, 5, 6).astype(np.float32))
    flen = torch.tensor([5, 3], dtype=torch.int32)
    mag, db = K5.spec_db(reim, flen, reim=True, **LEVELS)
    _close(mag, np.hypot(reim[..., :3].numpy(), reim[..., 3:].numpy()), atol=1e-6)
    assert torch.all(db[1, 3:] == 0) and db.shape == (2, 5, 3)
    want = JF.normalize_db(JF.amp_to_db(jnp.asarray(mag.numpy())) - JF.REF_LEVEL_DB)
    _close(db[0], np.asarray(want)[0], atol=1e-6)
    _, db2 = K5.spec_db(mag, flen, reim=False, **LEVELS)
    _close(db2, db, atol=0)
    mag3, none = K5.spec_db(reim, flen, reim=True, db=False, **LEVELS)
    assert none is None and torch.equal(mag3, mag)


def test_k5_wrappers_count_no_launch_on_cpu(featurizers):
    _, pf = featurizers
    waves, lengths = map(torch.from_numpy, _batch())
    before = (K5.stft_frames.launches, K5.spec_db.launches)
    pf.featurize(waves, lengths)
    pf.featurize_augmented(waves, lengths, torch.Generator().manual_seed(0))
    assert (K5.stft_frames.launches, K5.spec_db.launches) == before


# ---------------- K5 stft_frames: its launch plan and a replay of its tiles ----------------

FLAGSHIP = PF.AudioConfig(num_freq=1025, num_mels=80, frame_length_ms=50, frame_shift_ms=12.5)


def _k5_geometry(audio, S, path):
    """(T, span, max_hop) of the augmented or clean framing of S samples."""
    if path == "augmented":
        return 1 + S // audio.min_stretch_hop, audio.max_stretch_win, audio.max_stretch_hop
    return 1 + S // audio.hop_length, audio.win_length, audio.hop_length


@pytest.mark.parametrize("B,S,path", [
    (8, 66150, "augmented"), (8, 66150, "clean"),       # the flagship steps, B=8 x 3.0 s
    (16, 66150, "augmented"), (2, 66150, "clean"),      # the cycles' rows; a checked step
    (1, 336924, "augmented"), (1, 336924, "clean"),     # the 15.28 s utterance
    (2, 336924, "augmented"), (2, 336924, "clean"),     # ... beside a paired row
    (49, 336924, "augmented")])                         # 66,591 frame rows, past 65,535
def test_frames_plan_fits_every_step_shape(B, S, path):
    T, span, max_hop = _k5_geometry(FLAGSHIP, S, path)
    plan = K5.frames_plan(B, T, span, max_hop, noise=path == "augmented")
    assert plan["smem_bytes"] <= 232_448
    assert plan["grid"] == B * -(-T // plan["tile"]) and plan["tile"] in K5.FRAMES_TILES
    assert plan["staged"] == (plan["tile"] - 1) * max_hop + span
    if B == 49:
        assert B * T == 66_591 > 65_535


def test_frames_plan_tiles_and_limits():
    """The flagship's tiles (6 frames augmented, 8 clean), a tile given, and
    a tile past the card's shared memory."""
    assert K5.frames_plan(8, 267, 1212, 303, noise=True)["tile"] == 6
    assert K5.frames_plan(8, 241, 1102, 275, noise=False)["tile"] == 8
    plan = K5.frames_plan(8, 267, 1212, 303, noise=True, tile=1)
    assert plan["grid"] == 8 * 267 and plan["smem_bytes"] == 4 * (1212 + 1212 + 2 * 1220)
    with pytest.raises(ValueError, match="shared memory"):
        K5.frames_plan(1, 100, 2048, 20_000, noise=True, tile=8)
    with pytest.raises(ValueError):
        K5.frames_plan(1, 100, 2048, 0, noise=True)


def _source_index(i, L, pad):
    if i < 0:
        return -i
    if i < L:
        return i
    if i < L + pad:
        return 2 * L - 2 - i if L >= pad + 1 else L + pad - 1 - i
    return -1


def _k5_replay(waves, lengths, hop, win, *, n_fft, support, T, coeff, noise=None, mix=None,
               tile, window):
    """`stft_frames_kernel` a tile at a time in float32 numpy: the sample
    range a tile reads (the interior, the mirrors, one before), staged; the
    padded signal from it (the interior path where the tile has no mirror);
    the frames. ``window``: the support's window row (the kernel's is
    cospi-based, within 1 ulp of this one)."""
    off, span = support
    pad, B, S = n_fft // 2, *waves.shape
    c = np.float32(coeff)
    W_max = (tile - 1) * hop + span
    frames = np.zeros((B, T, span), np.float32)
    for b in range(B):
        L = int(lengths[b])
        m = np.float32(mix[b]) if noise is not None else None
        for t0 in range(0, T, tile):
            rows = min(tile, T - t0)
            kept = max(0, min(rows, 1 + L // hop - t0))
            if kept == 0:
                continue
            W = (kept - 1) * hop + span
            i0 = t0 * hop + off - pad
            i1 = i0 + W
            need = []
            if i0 < 0:
                need.append((1 - min(i1, 0), 1 - i0))
            need.append((max(i0, 0), min(i1, L)))
            ra, re = max(i0, L), min(i1, L + pad)
            if ra < re:
                need.append((2 * L - 1 - re, 2 * L - 1 - ra) if L >= pad + 1
                            else (L + pad - re, L + pad - ra))
            need = [(a, e) for a, e in need if a < e]
            lo = max(min([a for a, _ in need], default=L) - 1, 0)
            hi = min(max([e for _, e in need], default=0), L)
            assert max(hi - lo, 0) + 3 <= -(-(W_max + 8) // 4) * 4   # the staging buffer
            rw = waves[b, lo:hi]
            rz = noise[b, lo:hi] if noise is not None else None

            def mixed(k):
                return rw[k] + m * rz[k] if rz is not None else rw[k]

            xs = np.zeros(W, np.float32)
            if i0 >= 1 and i1 <= L:                                     # the interior
                cur, prev = mixed(np.arange(1, W + 1)), mixed(np.arange(W))
                xs[:] = cur - c * prev
            else:
                for j in range(W):
                    idx = _source_index(i0 + j, L, pad)
                    if 0 <= idx < L:
                        k = idx - lo
                        xs[j] = mixed(k) - c * mixed(k - 1) if idx > 0 else mixed(k)
            for g in range(kept):
                frames[b, t0 + g] = xs[g * hop:g * hop + span] * window
    return frames


def _jax_frames(waves, lengths, hop, win, *, n_fft, support, T, coeff, noise=None, mix=None):
    """The JAX featurizer's windowed frames (`_augment_impl`'s framing at a
    traced hop), zero at t >= 1 + length // hop."""
    off, span = support
    x, L = jnp.asarray(waves), jnp.asarray(lengths)
    in_range = jnp.arange(x.shape[1])[None, :] < L[:, None]
    if noise is not None:
        x = jnp.where(in_range, x + jnp.asarray(mix)[:, None] * jnp.asarray(noise), 0.0)
    x = jnp.where(in_range, JF.preemphasis(x, coeff), 0.0)
    xp = JS.reflect_pad_ragged(x, L, n_fft // 2)
    frames = jax.jit(lambda xp, h: JS.frame_signal(xp, n_fft, h, T, support=support))(
        xp, jnp.int32(hop))
    frames = frames * JS.dynamic_hann_window(n_fft, jnp.int32(win))[off:off + span]
    keep = np.arange(T)[None, :] < (1 + np.asarray(lengths) // hop)[:, None]
    return np.where(keep[:, :, None], np.asarray(frames), 0.0)


@pytest.mark.parametrize("rate,noisy", [(0.9, True), (1.0, True), (1.1, True), (1.0, False)])
@pytest.mark.parametrize("tile", [1, 3, 6])
def test_stft_frames_replay_matches_plain_and_jax(featurizers, rate, noisy, tile):
    """The kernel's tiles replayed at ragged lengths (L just above n_fft/2,
    L <= n_fft/2, tiles that straddle 1 + L/hop) equal the plain version bit
    for bit, and JAX's framing to 1e-6 on the rows longer than n_fft/2 (the
    JAX featurizer's domain; below it the plain version clamps the right
    mirror's start to 0, and so does the kernel)."""
    _, pf = featurizers
    audio = pf.cfg
    n_fft, pad = audio.n_fft, audio.n_fft // 2
    S = 6000
    lengths = np.asarray([S, 4411, pad + 1, pad, pad - 57], np.int32)
    rng = np.random.RandomState(4)
    waves = (0.3 * rng.randn(len(lengths), S)).astype(np.float32)
    waves[np.arange(S)[None, :] >= lengths[:, None]] = 0.0
    noise = rng.randn(*waves.shape).astype(np.float32) if noisy else None
    mix = rng.uniform(0.05, 0.3, len(lengths)).astype(np.float32) if noisy else None
    hop, win = (int(v) for v in pf.stretch_geometry(rate))
    if noisy:
        support = PS.window_support(n_fft, audio.max_stretch_win)
        T, clamp = 1 + S // audio.min_stretch_hop, True
    else:
        support, T, clamp = PS.window_support(n_fft, win), 1 + S // hop, False
    kw = dict(n_fft=n_fft, support=support, num_frames=T, clamp=clamp,
              coeff=audio.preemphasis_coeff)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want = K5.stft_frames_plain(t(waves), t(lengths), torch.tensor([hop, win], dtype=torch.int32),
                                noise=t(noise), mix=t(mix), **kw).numpy()
    off, span = support
    window = PS.dynamic_hann_window(n_fft, win)[off:off + span].numpy()
    got = _k5_replay(waves, lengths, hop, win, n_fft=n_fft, support=support, T=T,
                     coeff=audio.preemphasis_coeff, noise=noise, mix=mix, tile=tile, window=window)
    np.testing.assert_array_equal(got, want)
    jf = _jax_frames(waves, lengths, hop, win, n_fft=n_fft, support=support, T=T,
                     coeff=audio.preemphasis_coeff, noise=noise, mix=mix)
    _close(got[lengths > pad], jf[lengths > pad], atol=1e-6)
    straddle = [(1 + int(n) // hop) % tile for n in lengths]
    assert tile == 1 or any(straddle)                      # a tile holds kept and zero frames


def test_stft_frames_kernel_needs_max_hop_on_the_card(featurizers):
    """The plain version takes no max_hop; the wrapper asks for it only
    where it launches the kernel (a CPU tensor never does)."""
    _, pf = featurizers
    waves, lengths = map(torch.from_numpy, _batch())
    sup = PS.window_support(pf.cfg.n_fft, pf.cfg.win_length)
    kw = dict(n_fft=pf.cfg.n_fft, support=sup, num_frames=1 + waves.shape[1] // pf.cfg.hop_length,
              clamp=False, coeff=pf.cfg.preemphasis_coeff)
    a = K5.stft_frames(waves, lengths, pf._clean_geom, **kw)
    b = K5.stft_frames(waves, lengths, pf._clean_geom, max_hop=pf.cfg.hop_length, tile=3, **kw)
    assert torch.equal(a, b)
    assert pf.cfg.max_stretch_hop == int(pf.cfg.frame_shift_ms / 1000
                                         * int(pf.cfg.sample_rate * 1.1))
