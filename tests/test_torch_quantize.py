"""The port's trim/merge (`semi_tts_tpu_torch/ops/quantize.py`, kernel B6's
plain version on the CPU) against the JAX package's
`semi_tts_tpu.ops.quantize.trim_merge_segments`: the trimmed latents, the
lengths and the all-blank flag, the gradient with respect to the latents
against ``jax.vjp``, and `padded_concat`."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_tts_tpu.ops.quantize import padded_concat as j_padded_concat
from semi_tts_tpu.ops.quantize import trim_merge_segments as j_trim_merge
from semi_tts_tpu_torch.kernels import quantize as B6
from semi_tts_tpu_torch.ops.quantize import padded_concat, trim_merge_segments
from test_quantize import _case

# Means of at most max_frames_per_phn + 1 fp32 latents in the same order on
# both sides (measured 0): the tolerance covers a reordered sum.
ATOL = 1e-6


def _blank_row():
    """Row 0 all blank; row 1 blank, then a run of token 2."""
    p = np.full((2, 12, 5), 0.01, np.float32)
    p[0, :, 0] = 1.0
    p[1, :4, 0] = 1.0
    p[1, 4:, 2] = 1.0
    return p, np.random.RandomState(1).randn(2, 12, 3).astype(np.float32)


def _long_runs():
    """Runs of 5 to 9 frames of one token, cut every max_frames_per_phn + 1."""
    rng = np.random.RandomState(2)
    p = np.full((3, 60, 7), 0.01, np.float32)
    for b in range(3):
        t, tok = 0, 0
        while t < 60:
            n = rng.randint(5, 10)
            tok = (tok + rng.randint(1, 7)) % 7
            p[b, t:t + n, tok] = 1.0
            t += n
    return p, rng.randn(3, 60, 4).astype(np.float32)


def _ties():
    """Exact ties between two classes (the first wins), one of them blank."""
    p = np.full((2, 16, 6), 0.01, np.float32)
    p[:, :, 2] = p[:, :, 4] = 0.5
    p[0, 3:7, 0] = 0.5   # blank ties with 2 and 4: blank wins
    p[1, 8:, 1] = 0.5    # 1 ties with 2 and 4: 1 wins
    return p, np.random.RandomState(3).randn(2, 16, 5).astype(np.float32)


CASES = {**{f"seed{s}": (lambda s=s: _case(s)) for s in range(8)},
         "blank_row": _blank_row, "long_runs": _long_runs, "ties": _ties,
         "T1": lambda: _case(9, T=1)}


@pytest.mark.parametrize("max_f", [0, 3, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_trim_merge_matches_jax(case, max_f):
    p, latent = CASES[case]()
    want, want_len, want_ok = j_trim_merge(jnp.asarray(p), jnp.asarray(latent),
                                           max_frames_per_phn=max_f)
    got, lengths, ok = trim_merge_segments(torch.from_numpy(p), torch.from_numpy(latent),
                                           max_frames_per_phn=max_f)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_len))
    assert lengths.dtype == torch.int32 and ok.dtype == torch.bool
    assert bool(ok) == bool(want_ok)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["seed0", "seed3", "blank_row", "long_runs", "ties"])
def test_trim_merge_grad_matches_jax(case):
    """The gradient with respect to the latents (d_out[slot] / count on kept
    frames, 0 on dropped ones) against jax.vjp; p_code gets none."""
    p, latent = CASES[case]()
    cot = np.random.RandomState(7).randn(*latent.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x: j_trim_merge(jnp.asarray(p), x, max_frames_per_phn=3)[0],
                     jnp.asarray(latent))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    pt = torch.from_numpy(p).requires_grad_(True)
    x = torch.from_numpy(latent).requires_grad_(True)
    out, _, _ = trim_merge_segments(pt, x, max_frames_per_phn=3)
    got, gp = torch.autograd.grad(out, (x, pt), torch.from_numpy(cot), allow_unused=True)
    assert gp is None
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_trim_merge_follows_given_tokens():
    """``tokens=`` segments by the tokens given: the argmax gives the same
    result as none, and all-blank tokens keep nothing (ok False)."""
    p, latent = _long_runs()
    pt, x = torch.from_numpy(p), torch.from_numpy(latent)
    ref = trim_merge_segments(pt, x, max_frames_per_phn=3)
    same = trim_merge_segments(pt, x, max_frames_per_phn=3, tokens=pt.argmax(-1))
    for a, b in zip(ref, same):
        assert torch.equal(a, b)
    out, lengths, ok = trim_merge_segments(pt, x, max_frames_per_phn=3,
                                           tokens=torch.zeros(p.shape[:2], dtype=torch.int64))
    assert not bool(ok) and lengths.tolist() == [0, 0, 0] and not out.any()


def test_trim_merge_plain_slot_and_count():
    """The per-frame output slot (-1 on dropped frames) and segment frame
    count the backward reads, on one hand-made row: blank x2, token 3 x5
    (cut at 4 with max_frames_per_phn 3), blank, token 1."""
    tok = torch.tensor([[0, 0, 3, 3, 3, 3, 3, 0, 1]])
    latent = torch.arange(9, dtype=torch.float32).reshape(1, 9, 1)
    out, lengths, slot, count = B6.trim_merge_plain(None, latent, 3, tokens=tok)
    assert slot.tolist() == [[-1, -1, 0, 0, 0, 0, 1, -1, 2]]
    assert count.tolist() == [[2, 2, 4, 4, 4, 4, 1, 1, 1]]
    assert lengths.tolist() == [3]
    assert out[0, :, 0].tolist() == [3.5, 6.0, 8.0] + [0.0] * 6


def test_trim_merge_runs_plain_on_cpu():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    p, latent = _case(0)
    before = (B6.trim_merge.launches, B6.trim_merge_bwd.launches)
    x = torch.from_numpy(latent).requires_grad_(True)
    out, _, _ = trim_merge_segments(torch.from_numpy(p), x, max_frames_per_phn=3)
    out.sum().backward()
    assert (B6.trim_merge.launches, B6.trim_merge_bwd.launches) == before


@pytest.mark.parametrize("shapes", [((2, 5, 3), (3, 8, 3)), ((3, 8, 3), (2, 5, 3)),
                                    ((2, 4), (1, 4))])
def test_padded_concat_matches_jax(shapes):
    rng = np.random.RandomState(0)
    a, b = (rng.randn(*s).astype(np.float32) for s in shapes)
    _, want = j_padded_concat(jnp.asarray(a), jnp.asarray(b))
    got = padded_concat(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
