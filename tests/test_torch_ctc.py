"""The port's CTC (`semi_tts_tpu_torch/ops/ctc.py`, kernel K6 through its
plain version on the CPU) against `semi_tts_tpu.ops.ctc.ctc_loss` (custom
VJP) and `torch.nn.functional.ctc_loss`, NLL and gradient, with every edge
of the JAX lattice: input lengths below T, target length 0, T = 1,
repeated labels and an impossible alignment."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from semi_tts_tpu.ops import ctc as JC
from semi_tts_tpu_torch.kernels import ctc as K6
from semi_tts_tpu_torch.ops import ctc as PC

# fp32 log-semiring sums in the same order: NLLs agree to ~1e-6 relative and
# gradients (occupancies in [0, 1]) to ~1e-6 absolute
ATOL = 1e-5


def _inputs(B=4, T=12, C=7, U=4, seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, C).astype(np.float32)
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    targets = np.zeros((B, U), np.int32)
    tlen = rng.randint(1, U + 1, size=B).astype(np.int32)
    for b in range(B):
        targets[b, :tlen[b]] = rng.randint(1, C, size=tlen[b])
    ilen = np.full((B,), T, np.int32)
    return lp, targets, ilen, tlen


def _jax(lp, targets, ilen, tlen, reduction="mean"):
    f = lambda x: JC.ctc_loss(x, jnp.asarray(targets), jnp.asarray(ilen), jnp.asarray(tlen),
                              reduction=reduction)
    if reduction == "none":
        val = np.asarray(f(jnp.asarray(lp)))
        grad = np.asarray(jax.grad(lambda x: jnp.sum(f(x)))(jnp.asarray(lp)))
        return val, grad
    val, grad = jax.value_and_grad(f)(jnp.asarray(lp))
    return np.asarray(val), np.asarray(grad)


def _port(lp, targets, ilen, tlen, reduction="mean"):
    x = torch.from_numpy(lp.copy()).requires_grad_(True)
    val = PC.ctc_loss(x, torch.from_numpy(targets), torch.from_numpy(ilen),
                      torch.from_numpy(tlen), reduction=reduction)
    (val.sum() if reduction == "none" else val).backward()
    return val.detach().numpy(), x.grad.numpy()


def _close(lp, targets, ilen, tlen, reduction="mean", atol=ATOL):
    want_v, want_g = _jax(lp, targets, ilen, tlen, reduction)
    got_v, got_g = _port(lp, targets, ilen, tlen, reduction)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=atol)
    return got_v, got_g


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_matches_jax(reduction):
    _close(*_inputs(), reduction=reduction)


def test_ctc_matches_torch_ctc_loss():
    """Against ``F.ctc_loss`` through a log-softmax of the same logits: its
    native backward folds the softmax into the gradient it returns, so the
    two gradients agree with respect to the logits."""
    lp, targets, _, tlen = _inputs(B=3, T=15, C=6, U=5, seed=1)
    ilen = torch.tensor([15, 11, 9])
    grads, vals = [], []
    for loss in (PC.ctc_loss, None):
        x = torch.from_numpy(lp.copy()).requires_grad_(True)
        y = torch.log_softmax(x, -1)
        if loss is None:
            v = F.ctc_loss(y.transpose(0, 1), torch.from_numpy(targets).long(), ilen,
                           torch.from_numpy(tlen).long(), reduction="mean")
        else:
            v = loss(y, torch.from_numpy(targets), ilen, torch.from_numpy(tlen))
        v.backward()
        vals.append(v.item())
        grads.append(x.grad.numpy())
    np.testing.assert_allclose(vals[0], vals[1], rtol=1e-5)
    np.testing.assert_allclose(grads[0], grads[1], rtol=0, atol=ATOL)


def test_ctc_input_lengths_below_t_freeze_and_zero_the_gradient():
    lp, targets, _, tlen = _inputs(seed=2)
    ilen = np.asarray([12, 9, 10, 11], np.int32)
    _, g = _close(lp, targets, ilen, tlen, reduction="sum")
    assert np.all(g[1, 9:] == 0) and np.all(g[2, 10:] == 0)


def test_ctc_target_length_zero():
    lp, targets, ilen, tlen = _inputs(seed=3)
    targets[1] = 0
    tlen[1] = 0
    v, _ = _close(lp, targets, ilen, tlen, reduction="none")
    np.testing.assert_allclose(v[1], -lp[1, :, 0].sum(), rtol=1e-5)


def test_ctc_single_frame():
    lp, targets, ilen, tlen = _inputs(B=3, T=1, U=2, seed=4)
    tlen[:] = [1, 0, 1]
    targets[1] = 0
    ilen[:] = 1
    _close(lp, targets, ilen, tlen, reduction="sum")


def test_ctc_repeated_labels():
    lp, targets, ilen, tlen = _inputs(B=2, T=10, U=4, seed=5)
    targets[:] = [[3, 3, 5, 5], [2, 2, 2, 0]]
    tlen[:] = [4, 3]
    _close(lp, targets, ilen, tlen)


def test_ctc_impossible_alignment_has_zero_gradient():
    """Three repeated labels need 5 frames; 4 give P = 0: nll ~1e30 and a
    zero gradient for that row, the other row unaffected."""
    lp, targets, ilen, tlen = _inputs(B=2, T=4, U=3, seed=6)
    targets[:] = [[4, 4, 4], [1, 2, 0]]
    tlen[:] = [3, 2]
    v, g = _close(lp, targets, ilen, tlen, reduction="none")
    assert v[0] > 1e29 and np.all(g[0] == 0) and np.any(g[1] != 0)


def test_ctc_alpha_plain_matches_jax_alpha_pass():
    lp, targets, ilen, tlen = _inputs(seed=7)
    ilen[2] = 7
    z, can_skip, valid = JC._lattice(jnp.asarray(targets), jnp.asarray(tlen), 0)
    want_nll, want_alphas = JC._alpha_pass(jnp.asarray(lp), z, can_skip, valid, jnp.asarray(ilen),
                                           jnp.asarray(tlen), 0, collect=True)
    alphas, nll = K6.ctc_alpha(*map(torch.from_numpy, (lp, targets, ilen, tlen)))
    np.testing.assert_allclose(nll.numpy(), np.asarray(want_nll), rtol=1e-6)
    np.testing.assert_allclose(alphas.numpy(), np.asarray(want_alphas), rtol=1e-6, atol=1e-4)


def test_ctc_wrappers_count_no_launch_on_cpu():
    before = (K6.ctc_alpha.launches, K6.ctc_beta_grad.launches)
    _port(*_inputs())
    assert (K6.ctc_alpha.launches, K6.ctc_beta_grad.launches) == before
