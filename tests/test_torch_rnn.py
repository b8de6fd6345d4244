"""The port's recurrences (`semi_tts_tpu_torch/ops/rnn.py`, kernels K1/K2 via
their plain versions on the CPU) against `semi_tts_tpu.ops.rnn`."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_tts_tpu.ops import rnn as J
from semi_tts_tpu_torch.bridge import load_jax_params
from semi_tts_tpu_torch.ops import rnn as P

ATOL = 1e-5  # fp32 on both sides; only the summation order of h @ W_hh^T differs


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_rec_matches_jax(reverse):
    rng = np.random.RandomState(0)
    T, B, H = 9, 3, 16
    x_proj = (0.5 * rng.randn(T, B, 4 * H)).astype(np.float32)
    w_hh = (0.3 * rng.randn(4 * H, H)).astype(np.float32)
    want = np.asarray(J._lstm_rec(reverse, jnp.asarray(w_hh), jnp.asarray(x_proj)))
    got = P.lstm_rec(reverse, _t(w_hh), _t(x_proj)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_rec_matches_jax(reverse):
    rng = np.random.RandomState(1)
    T, B, H = 11, 3, 12
    x_proj = (0.5 * rng.randn(T, B, 3 * H)).astype(np.float32)
    w_hh = (0.3 * rng.randn(3 * H, H)).astype(np.float32)
    b_hh = (0.3 * rng.randn(3 * H)).astype(np.float32)
    want = np.asarray(J._gru_rec(reverse, jnp.asarray(w_hh), jnp.asarray(b_hh),
                                 jnp.asarray(x_proj)))
    got = P.gru_rec(reverse, _t(w_hh), _t(b_hh), _t(x_proj)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_multi_lstm_matches_jax(num_layers):
    rng = np.random.RandomState(2)
    B, T, D, H = 2, 7, 10, 8
    params = J.multi_lstm_init(jax.random.PRNGKey(num_layers), D, H, num_layers, True)
    xs = rng.randn(B, T, D).astype(np.float32)
    want = np.asarray(J.multi_lstm(params, jnp.asarray(xs)))
    layers = P.multi_lstm_init(D, H, num_layers, True, generator=torch.Generator())
    load_jax_params(layers, jax.tree_util.tree_map(np.asarray, params), {})
    got = P.multi_lstm(layers, _t(xs)).detach().numpy()
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_bigru_matches_jax():
    rng = np.random.RandomState(3)
    B, T, D = 2, 13, 6
    params = J.bigru_init(jax.random.PRNGKey(5), D, D)
    xs = rng.randn(B, T, D).astype(np.float32)
    want = np.asarray(J.bigru(params, jnp.asarray(xs)))
    gru = torch.nn.ModuleDict({"fwd": P.GRUParams(D, D), "bwd": P.GRUParams(D, D)})
    load_jax_params(gru, jax.tree_util.tree_map(np.asarray, params), {})
    got = P.bigru(gru, _t(xs)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_lstm_cell_matches_jax():
    rng = np.random.RandomState(4)
    B, D, H = 3, 5, 7
    params = J.lstm_init(jax.random.PRNGKey(0), D, H)
    x, h, c = (rng.randn(B, n).astype(np.float32) for n in (D, H, H))
    want = J.lstm_cell(params, jnp.asarray(x), jnp.asarray(h), jnp.asarray(c))
    p = P.LSTMParams(D, H)
    load_jax_params(p, jax.tree_util.tree_map(np.asarray, params), {})
    got = P.lstm_cell(p, _t(x), _t(h), _t(c))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_wrappers_count_no_launch_on_cpu():
    """On CPU tensors the wrappers take the plain version: no kernel launch
    is counted."""
    from semi_tts_tpu_torch import kernels

    before = kernels.launch_counts()
    P.lstm_rec(False, torch.zeros(8, 2), torch.zeros(3, 1, 8))
    P.gru_rec(True, torch.zeros(6, 2), torch.zeros(6), torch.zeros(3, 1, 6))
    assert kernels.launch_counts() == before
