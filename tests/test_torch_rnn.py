"""The port's recurrences (`semi_tts_tpu_torch/ops/rnn.py`, kernels K1/K2 via
their plain versions on the CPU) against `semi_tts_tpu.ops.rnn`, and the
kernels' launch plans."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_tts_tpu.ops import rnn as J
from semi_tts_tpu_torch.bridge import load_jax_params
from semi_tts_tpu_torch.kernels import rnn as K
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


@pytest.mark.parametrize("T,B,H", [(9, 3, 16), (1, 2, 8), (6, 5, 12)])
def test_bilstm_rec_matches_jax_per_direction(T, B, H):
    """Both directions in one call: forward in [..., :H], reversed in [..., H:]."""
    rng = np.random.RandomState(T)
    w_f, w_b = ((0.3 * rng.randn(4 * H, H)).astype(np.float32) for _ in range(2))
    x_f, x_b = ((0.5 * rng.randn(T, B, 4 * H)).astype(np.float32) for _ in range(2))
    want = np.concatenate([np.asarray(J._lstm_rec(False, jnp.asarray(w_f), jnp.asarray(x_f))),
                           np.asarray(J._lstm_rec(True, jnp.asarray(w_b), jnp.asarray(x_b)))], -1)
    got = K.bilstm_rec(_t(w_f), _t(w_b), _t(x_f), _t(x_b)).numpy()
    assert got.shape == (T, B, 2 * H)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("T,B,H", [(11, 3, 12), (1, 2, 8), (7, 5, 10)])
def test_bigru_rec_matches_jax_per_direction(T, B, H):
    rng = np.random.RandomState(T)
    w_f, w_b = ((0.3 * rng.randn(3 * H, H)).astype(np.float32) for _ in range(2))
    b_f, b_b = ((0.3 * rng.randn(3 * H)).astype(np.float32) for _ in range(2))
    x_f, x_b = ((0.5 * rng.randn(T, B, 3 * H)).astype(np.float32) for _ in range(2))
    want = np.concatenate(
        [np.asarray(J._gru_rec(False, jnp.asarray(w_f), jnp.asarray(b_f), jnp.asarray(x_f))),
         np.asarray(J._gru_rec(True, jnp.asarray(w_b), jnp.asarray(b_b), jnp.asarray(x_b)))], -1)
    got = K.bigru_rec(_t(w_f), _t(w_b), _t(b_f), _t(b_b), _t(x_f), _t(x_b)).numpy()
    assert got.shape == (T, B, 2 * H)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_bidirectional_wrappers_match_jax_layer(kind):
    """bilstm_rec / bigru_rec on x_proj built from the JAX layer's weights
    equal `J.multi_lstm` / `J.bigru` (batch-first, forward then backward)."""
    rng = np.random.RandomState(6)
    B, T, D, H = 3, 8, 6, 5
    xs = rng.randn(B, T, D).astype(np.float32)
    if kind == "lstm":
        params = J.multi_lstm_init(jax.random.PRNGKey(7), D, H, 1, True)
        want = np.asarray(J.multi_lstm(params, jnp.asarray(xs)))
        layer = jax.tree_util.tree_map(np.asarray, params)[0]
        f, b = layer["fwd"], layer["bwd"]
        proj = [np.einsum("btd,gd->tbg", xs, p["w_ih"]) + p["b_ih"] + p["b_hh"] for p in (f, b)]
        got = K.bilstm_rec(_t(f["w_hh"]), _t(b["w_hh"]), *map(_t, proj))
    else:
        params = J.bigru_init(jax.random.PRNGKey(8), D, H)
        want = np.asarray(J.bigru(params, jnp.asarray(xs)))
        p = jax.tree_util.tree_map(np.asarray, params)
        f, b = p["fwd"], p["bwd"]
        proj = [np.einsum("btd,gd->tbg", xs, q["w_ih"]) + q["b_ih"] for q in (f, b)]
        got = K.bigru_rec(_t(f["w_hh"]), _t(b["w_hh"]), _t(f["b_hh"]), _t(b["b_hh"]),
                          *map(_t, proj))
    np.testing.assert_allclose(got.transpose(0, 1).numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("max_clusters,rows,clusters", [(16, 2, 16), (15, 4, 8), (64, 1, 32)])
def test_lstm_plan_flagship(max_clusters, rows, clusters):
    """The serving BiLSTM (B=16, H=256, both directions): the fewest rows per
    cluster that let every cluster of 8 CTAs run at once."""
    plan = K.lstm_plan(16, 256, 2, max_clusters)
    assert (plan["cluster"], plan["rows"], plan["clusters"]) == (8, rows, clusters)
    assert plan["grid"] == (8 * clusters // 2, 2)
    assert plan["units_per_cta"] == 32 and plan["threads"] == 256
    assert plan["smem_bytes"] <= K.SMEM_PER_BLOCK
    assert plan["smem_bytes"] >= 128 * 256 * 4   # the CTA's 128 gate rows of W_hh


@pytest.mark.parametrize("rows", K.LSTM_ROWS)
def test_lstm_plan_fits_shared_memory_up_to_max_h(rows):
    for H in (4, 80, 256, K.LSTM_MAX_H):
        plan = K.lstm_plan(16, H, 2, 15, rows)
        assert plan["smem_bytes"] <= K.SMEM_PER_BLOCK
        assert plan["units_per_cta"] * plan["cluster"] >= H


def test_gru_plan_flagship():
    plan = K.gru_plan(16, 80, 2)
    assert plan["grid"] == (16, 2)
    assert plan["threads"] == 640 and plan["weights_per_lane"] == 30
    # K8: 16 lanes for each 4 units (10 warps), 5 rows of each gate a lane,
    # all in registers; at H = 128 one row of each gate in shared memory
    bwd = K.gru_bwd_plan(16, 80, 2)
    assert bwd["grid"] == (16, 2) and bwd["threads"] == 320
    assert (bwd["rows_per_lane"], bwd["reg_rows"]) == (5, 5)
    for H in range(1, K.GRU_MAX_H + 1):
        bwd = K.gru_bwd_plan(16, H, 2)
        assert bwd["threads"] <= 1024 and bwd["threads"] % 32 == 0
        assert bwd["threads"] >= 16 * -(-H // 4)
        assert 16 * bwd["rows_per_lane"] >= H and bwd["smem_bytes"] <= 48 * 1024
    assert K.gru_bwd_plan(16, 128, 2)["reg_rows"] == 7


@pytest.mark.parametrize("plan,H", [("lstm", K.LSTM_MAX_H + 4), ("lstm", 258), ("lstm", 0),
                                    ("gru", K.GRU_MAX_H + 1), ("gru", 0)])
def test_plans_raise_outside_their_h_range(plan, H):
    with pytest.raises(ValueError):
        K.lstm_plan(16, H, 2, 15) if plan == "lstm" else K.gru_plan(16, H, 2)


def test_lstm_plan_raises_on_unknown_rows():
    with pytest.raises(ValueError):
        K.lstm_plan(16, 256, 2, 15, rows=3)


def test_wrappers_count_no_launch_on_cpu():
    """On CPU tensors the wrappers take the plain version: no kernel launch
    is counted."""
    from semi_tts_tpu_torch import kernels

    wrappers = (K.lstm_rec, K.gru_rec, K.bilstm_rec, K.bigru_rec)
    before = kernels.launch_counts(), [w.launches for w in wrappers]
    P.lstm_rec(False, torch.zeros(8, 2), torch.zeros(3, 1, 8))
    P.gru_rec(True, torch.zeros(6, 2), torch.zeros(6), torch.zeros(3, 1, 6))
    K.bilstm_rec(torch.zeros(8, 2), torch.zeros(8, 2), torch.zeros(3, 1, 8), torch.zeros(3, 1, 8))
    K.bigru_rec(torch.zeros(6, 2), torch.zeros(6, 2), torch.zeros(6), torch.zeros(6),
                torch.zeros(3, 1, 6), torch.zeros(3, 1, 6))
    assert (kernels.launch_counts(), [w.launches for w in wrappers]) == before


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_backward_matches_jax_vjp(reverse):
    """The K7 plain recurrence inside the autograd Function: dW_hh and
    dx_proj of one direction against ``jax.vjp`` of `_lstm_rec`."""
    rng = np.random.RandomState(10 + reverse)
    T, B, H = 7, 3, 8
    x_proj = (0.5 * rng.randn(T, B, 4 * H)).astype(np.float32)
    w_hh = (0.3 * rng.randn(4 * H, H)).astype(np.float32)
    g_hs = rng.randn(T, B, H).astype(np.float32)
    _, vjp = jax.vjp(lambda w, x: J._lstm_rec(reverse, w, x), jnp.asarray(w_hh),
                     jnp.asarray(x_proj))
    want_w, want_x = vjp(jnp.asarray(g_hs))
    w, x = _t(w_hh).requires_grad_(True), _t(x_proj).requires_grad_(True)
    if reverse:  # the reversed direction alone: the forward slot gets a zero-length twin
        hs = P.lstm_rec_fn(_t(w_hh), w, _t(x_proj), x)[..., H:]
    else:
        hs = P.lstm_rec_fn(w, None, x, None)
    hs.backward(_t(g_hs))
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want_w), rtol=0, atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_x), rtol=0, atol=ATOL)


@pytest.mark.parametrize("T,B,H", [(6, 2, 8), (1, 3, 4)])
def test_lstm_function_matches_autograd_through_plain(T, B, H):
    """Both directions through `lstm_rec_fn` (K1 forward, K7 backward) equal
    autograd through `lstm_rec_plain`, gradients of W_hh and x_proj."""
    rng = np.random.RandomState(T)
    ws = [(0.3 * rng.randn(4 * H, H)).astype(np.float32) for _ in range(2)]
    xs = [(0.5 * rng.randn(T, B, 4 * H)).astype(np.float32) for _ in range(2)]
    g = _t(rng.randn(T, B, 2 * H).astype(np.float32))
    grads = []
    for use_fn in (True, False):
        leaves = [_t(a).requires_grad_(True) for a in ws + xs]
        if use_fn:
            hs = P.lstm_rec_fn(*leaves)
        else:
            hs = torch.cat([K.lstm_rec_plain(False, leaves[0], leaves[2]),
                            K.lstm_rec_plain(True, leaves[1], leaves[3])], -1)
        hs.backward(g)
        grads.append([leaf.grad.numpy() for leaf in leaves])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_multi_lstm_grad_matches_jax():
    """A 2-layer BiLSTM in train mode, dropout 0: input and weight
    gradients of sum(out * probe) against JAX."""
    rng = np.random.RandomState(12)
    B, T, D, H = 2, 6, 5, 4
    params = J.multi_lstm_init(jax.random.PRNGKey(3), D, H, 2, True)
    xs = rng.randn(B, T, D).astype(np.float32)
    probe = rng.randn(B, T, 2 * H).astype(np.float32)
    f = lambda p, x: jnp.sum(J.multi_lstm(p, x, dropout=0.0, train=True) * probe)
    want_p, want_x = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(xs))
    layers = P.multi_lstm_init(D, H, 2, True, generator=torch.Generator())
    load_jax_params(layers, jax.tree_util.tree_map(np.asarray, params), {})
    x = _t(xs).requires_grad_(True)
    (P.multi_lstm(layers, x, dropout=0.0, train=True) * _t(probe)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_x), rtol=0, atol=ATOL)
    for li in range(2):
        for d in ("fwd", "bwd"):
            for name in ("w_ih", "w_hh", "b_ih"):
                got = getattr(layers[li][d], name).grad.numpy()
                np.testing.assert_allclose(got, np.asarray(want_p[li][d][name]), rtol=0,
                                           atol=ATOL, err_msg=f"{li}/{d}/{name}")


def test_multi_lstm_inter_layer_dropout():
    """Train mode drops units of every layer's output but the last, at the
    configured rate, scaled by 1/(1-p); eval mode and dropout 0 draw
    nothing."""
    B, T, D, H = 8, 40, 6, 16
    layers = P.multi_lstm_init(D, H, 2, True, generator=torch.Generator().manual_seed(0))
    xs = torch.randn(B, T, D, generator=torch.Generator().manual_seed(1))
    seen = []
    orig = P.drop

    def spy(h, rate, *, enabled=True, generator=None):
        out = orig(h, rate, enabled=enabled, generator=generator)
        seen.append((h.detach(), out.detach(), enabled, rate))
        return out

    P.drop = spy
    try:
        with torch.no_grad():
            P.multi_lstm(layers, xs, dropout=0.3, train=True,
                         generator=torch.Generator().manual_seed(2))
            base = P.multi_lstm(layers, xs)
            again = P.multi_lstm(layers, xs, dropout=0.3, train=False)
    finally:
        P.drop = orig
    assert len(seen) == 3  # one between the two layers, per call
    h, out, enabled, rate = seen[0]
    assert enabled and rate == 0.3
    kept = out != 0
    assert abs(1.0 - kept.float().mean().item() - 0.3) < 0.02
    torch.testing.assert_close(out[kept], h[kept] / 0.7)
    assert not seen[1][2] and torch.equal(base, again)


@pytest.mark.parametrize("B,ndir,max_clusters,rows,clusters", [
    (8, 2, 15, 2, 8), (8, 2, 16, 1, 16), (16, 2, 15, 4, 8), (5, 1, 15, 1, 5), (64, 2, 4, 8, 16)])
def test_lstm_bwd_plan(B, ndir, max_clusters, rows, clusters):
    """K7 at the ASR shapes (H=256): the fewest rows per cluster that let
    every cluster run at once (8 rows when none does)."""
    plan = K.lstm_bwd_plan(B, 256, ndir, max_clusters)
    assert (plan["cluster"], plan["rows"], plan["clusters"]) == (8, rows, clusters)
    assert plan["threads"] == 512 and plan["units_per_cta"] == 32
    assert plan["grid"] == (8 * -(-B // rows), ndir)
    # the CTA's 128 gate rows over 8 lanes: 4 chunks of 4 rows, all in
    # registers up to 2 rows per cluster
    assert plan["chunks"] == 4 and plan["reg_chunks"] == (4 if rows <= 2 else 3 if rows == 4 else 2)
    w_smem = (plan["chunks"] - plan["reg_chunks"]) * 128 * 256 // 4 * 4
    assert w_smem < plan["smem_bytes"] <= K.SMEM_PER_BLOCK


@pytest.mark.parametrize("H", [4, 12, 80, 132, 200, 256, K.LSTM_MAX_H])
def test_lstm_bwd_plan_fits_shared_memory(H):
    for rows in K.LSTM_ROWS:
        plan = K.lstm_bwd_plan(16, H, 2, 15, rows)
        assert plan["smem_bytes"] <= K.SMEM_PER_BLOCK
        assert plan["units_per_cta"] * plan["cluster"] >= H
        # every column quad has its 8 lanes, every (row, unit) a thread
        assert plan["threads"] <= 1024 and plan["threads"] % 32 == 0
        assert plan["threads"] >= max(2 * H, rows * plan["units_per_cta"])
        assert 32 * plan["chunks"] >= 4 * plan["units_per_cta"]


@pytest.mark.parametrize("H,rows", [(K.LSTM_MAX_H + 4, None), (258, None), (0, None), (256, 3)])
def test_lstm_bwd_plan_raises(H, rows):
    with pytest.raises(ValueError):
        K.lstm_bwd_plan(8, H, 2, 15, rows)


def test_training_wrappers_count_no_launch_on_cpu():
    before = (K.bilstm_rec_cs.launches, K.bilstm_rec_bwd.launches)
    w = torch.zeros(8, 2, requires_grad=True)
    x = torch.zeros(3, 1, 8, requires_grad=True)
    P.lstm_rec_fn(w, w, x, x).sum().backward()
    assert (K.bilstm_rec_cs.launches, K.bilstm_rec_bwd.launches) == before


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_rec_bwd_plain_matches_jax(reverse):
    """One direction of K8's plain recurrence, between the recomputed
    coefficients and the dW_hh/db_hh/dx_proj products, against JAX
    `_gru_rec_bwd` on the residuals of `_gru_rec_fwd`."""
    rng = np.random.RandomState(20 + reverse)
    T, B, H = 9, 3, 10
    x_proj = (0.5 * rng.randn(T, B, 3 * H)).astype(np.float32)
    w_hh = (0.3 * rng.randn(3 * H, H)).astype(np.float32)
    b_hh = (0.3 * rng.randn(3 * H)).astype(np.float32)
    g_hs = rng.randn(T, B, H).astype(np.float32)
    hs, res = J._gru_rec_fwd(reverse, jnp.asarray(w_hh), jnp.asarray(b_hh), jnp.asarray(x_proj))
    want = J._gru_rec_bwd(reverse, res, jnp.asarray(g_hs))
    h_prev, z, coef_h, coef_x = P.gru_bwd_coefficients(reverse, _t(w_hh), _t(b_hh), _t(x_proj),
                                                       _t(hs))
    dh2 = K.gru_rec_bwd_plain(reverse, _t(w_hh), z, coef_h, _t(g_hs)).repeat(1, 1, 3)
    got = ((coef_h * dh2).reshape(-1, 3 * H).T @ h_prev.reshape(-1, H),
           (coef_h * dh2).sum((0, 1)), coef_x * dh2)
    for g, w, what in zip(got, want, ("dw_hh", "db_hh", "dx_proj")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL, err_msg=what)


def test_bigru_grad_matches_jax():
    """`bigru` under autograd (`_GRURec`: K2 forward, K8 backward, plain on
    the CPU): input and every weight gradient of sum(out * probe) against
    ``jax.grad`` of JAX `bigru`."""
    rng = np.random.RandomState(13)
    B, T, D = 3, 11, 6
    params = J.bigru_init(jax.random.PRNGKey(7), D, D)
    xs = rng.randn(B, T, D).astype(np.float32)
    probe = rng.randn(B, T, 2 * D).astype(np.float32)
    want_p, want_x = jax.grad(lambda p, x: jnp.sum(J.bigru(p, x) * probe),
                              argnums=(0, 1))(params, jnp.asarray(xs))
    gru = torch.nn.ModuleDict({"fwd": P.GRUParams(D, D), "bwd": P.GRUParams(D, D)})
    load_jax_params(gru, jax.tree_util.tree_map(np.asarray, params), {})
    x = _t(xs).requires_grad_(True)
    before = K.bigru_rec_bwd.launches
    (P.bigru(gru, x) * _t(probe)).sum().backward()
    assert K.bigru_rec_bwd.launches == before
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_x), rtol=0, atol=ATOL)
    for d in ("fwd", "bwd"):
        for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
            np.testing.assert_allclose(getattr(gru[d], name).grad.numpy(),
                                       np.asarray(want_p[d][name]), rtol=0, atol=ATOL,
                                       err_msg=f"{d}/{name}")


@pytest.mark.parametrize("T,B,H", [(7, 2, 8), (1, 3, 5)])
def test_gru_function_matches_autograd_through_plain(T, B, H):
    """Both directions through `gru_rec_fn` equal autograd through
    `gru_rec_plain`: gradients of W_hh, b_hh and x_proj."""
    rng = np.random.RandomState(30 + T)
    arrays = ([(0.3 * rng.randn(3 * H, H)).astype(np.float32) for _ in range(2)]
              + [(0.3 * rng.randn(3 * H)).astype(np.float32) for _ in range(2)]
              + [(0.5 * rng.randn(T, B, 3 * H)).astype(np.float32) for _ in range(2)])
    g = _t(rng.randn(T, B, 2 * H).astype(np.float32))
    grads = []
    for use_fn in (True, False):
        leaves = [_t(a).requires_grad_(True) for a in arrays]
        if use_fn:
            hs = P.gru_rec_fn(*leaves)
        else:
            hs = torch.cat([K.gru_rec_plain(False, leaves[0], leaves[2], leaves[4]),
                            K.gru_rec_plain(True, leaves[1], leaves[3], leaves[5])], -1)
        hs.backward(g)
        grads.append([leaf.grad.numpy() for leaf in leaves])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _k7_lane_scatter(chains):
    """numpy replay of K7's ``lane_scatter`` over the 8 lanes of a group:
    ``chains`` (8, 4R) float32 -> (values, entries), each lane's kept
    values and the flat (row, column) entries they stand for."""
    n = chains.shape[1]
    vals = chains.copy()
    idx = np.tile(np.arange(n), (8, 1))
    for o in (4, 2, 1):
        new_v, new_i = vals.copy(), idx.copy()
        for g in range(8):
            p, hi = g ^ o, bool(g & o)
            if n >= 2:
                half = n // 2
                for k in range(half):
                    keep = k + half if hi else k
                    send = k if (p & o) else k + half  # what the partner sends
                    assert idx[p][send] == idx[g][keep]
                    new_v[g][k] = vals[g][keep] + vals[p][send]
                    new_i[g][k] = idx[g][keep]
            else:
                new_v[g][0] = vals[g][0] + vals[p][0]
        vals, idx = new_v, new_i
        n = max(n // 2, 1)
    return vals[:, :n], idx[:, :n]


def _k7_tree(c):
    """The sum of the 8 lanes' chains that every lane holding an entry has."""
    return ((c[0] + c[4]) + (c[2] + c[6])) + ((c[1] + c[5]) + (c[3] + c[7]))


@pytest.mark.parametrize("rows", K.LSTM_ROWS)
def test_k7_lane_scatter_leaves_each_sum_in_one_sender(rows):
    """K7's shuffle tree: lane g ends with the flat entries g*N/8 .. (N = 4R
    >= 8) or entry g // 2 (R = 1), each equal, bit for bit, to the fixed tree
    of the 8 chains; the lanes that send (all, or the even ones at R = 1)
    cover every (row, column) entry once."""
    rng = np.random.RandomState(rows)
    chains = rng.randn(8, 4 * rows).astype(np.float32)
    vals, idx = _k7_lane_scatter(chains)
    nv = max(4 * rows // 8, 1)
    assert vals.shape == (8, nv)
    sent = []
    for g in range(8):
        first = g * nv if 4 * rows >= 8 else g // 2
        assert list(idx[g]) == list(range(first, first + nv))
        np.testing.assert_array_equal(vals[g], _k7_tree(chains[:, idx[g]]))
        if rows > 1 or g % 2 == 0:
            sent += list(idx[g])
    assert sorted(sent) == list(range(4 * rows))


@pytest.mark.parametrize("H", [4, 12, 40, 80, 256, K.LSTM_MAX_H])
def test_k7_exchange_fills_each_owner_once(H):
    """A producer CTA's sums for an owner fill the owner's slot of that
    producer once, R * owned units; the owner's own lanes among the senders
    number owned / 4 * (4 at R = 1, else 8) a pass of phase B (two passes of
    4 rows at R = 8 past 256 units), the arrivals its mbarrier counts beside
    its peers' st.async bytes. Only CTAs that own units send (the rest hold
    zero rows of W_hh), and no sum goes to a CTA past them."""
    for rows in K.LSTM_ROWS:
        plan = K.lstm_bwd_plan(16, H, 2, 15, rows)
        U = plan["units_per_cta"]
        passes = 2 if rows == 8 and plan["chunks"] >= 5 else 1  # phase B's row passes
        rp = rows // passes
        nv = max(4 * rp // 8, 1)
        got, lanes = {}, {}
        for tid in range(plan["threads"]):
            g, kq = tid % 8, tid // 8
            if kq >= H // 4 or (rp == 1 and g % 2):
                continue
            e = g * nv if 4 * rp >= 8 else g // 2
            k = 4 * kq + e % 4
            for p in range(passes):
                lanes[k // U] = lanes.get(k // U, 0) + 1
                for v in range(nv):
                    slot = (p * rp + e // 4, k % U + v)
                    assert slot not in got.setdefault(k // U, set())
                    got[k // U].add(slot)
        assert max(got) == -(-H // U) - 1
        for owner in range(8):
            owned = min(max(H - owner * U, 0), U)
            assert len(got.get(owner, ())) == rows * owned
            assert lanes.get(owner, 0) == owned // 4 * (4 if rp == 1 else 8) * passes


def _k7_replay(reverse, w_hh, gates, cs, g_hs):
    """numpy replay of K7's arithmetic, one direction: the products that do
    not wait for dh_rec, then per step each CTA's lanes' chains over their
    gate rows 4(8i + g) .. + 3 (an FMA as a float64 product and sum rounded to
    float32), the fixed shuffle tree, and the 8 slots summed in rank order."""
    f32 = np.float32
    T, B, H4 = gates.shape
    H = H4 // 4
    plan = K.lstm_bwd_plan(B, H, 1, 16, 1)
    U, nch = plan["units_per_cta"], plan["chunks"]
    w_p = np.zeros((8, 32 * nch, H), f32)  # each CTA's gate rows q*U + u, padded
    for rank in range(8):
        for p in range(4 * U):
            q, j = p // U, rank * U + p % U
            if j < H:
                w_p[rank, p] = w_hh[q * H + j]
    lane_rows = [[4 * (8 * i + g) + m for i in range(nch) for m in range(4)] for g in range(8)]
    sig = lambda x: f32(1) / (f32(1) + np.exp(-x))
    dh_rec, dc_rec = np.zeros((B, H), f32), np.zeros((B, H), f32)
    out = np.zeros_like(gates)
    for s in range(T):
        t = s if reverse else T - 1 - s
        tp = t + 1 if reverse else t - 1
        gi, gf, gg, go = (gates[t][:, q * H:(q + 1) * H] for q in range(4))
        c_prev = cs[tp] if 0 <= tp < T else np.zeros((B, H), f32)
        i, f, g_, o = sig(gi), sig(gf), np.tanh(gg), sig(go)
        tc = np.tanh(cs[t])
        dh = g_hs[t] + dh_rec
        dc = dc_rec + dh * (o * (f32(1) - tc * tc))
        dc_rec = dc * f
        dg = [dc * (g_ * i * (f32(1) - i)), dc * (c_prev * f * (f32(1) - f)),
              dc * (i * (f32(1) - g_ * g_)), dh * (tc * o * (f32(1) - o))]
        out[t] = np.concatenate(dg, -1)
        slots = []
        for rank in range(8):
            dg_p = np.zeros((B, 32 * nch), f32)
            for p in range(4 * U):
                q, j = p // U, rank * U + p % U
                if j < H:
                    dg_p[:, p] = dg[q][:, j]
            chains = np.zeros((8, B, H), f32)
            for g in range(8):
                for p in lane_rows[g]:
                    chains[g] = (chains[g].astype(np.float64) + dg_p[:, p, None].astype(np.float64)
                                 * w_p[rank, p].astype(np.float64)).astype(f32)
            slots.append(_k7_tree(chains))
        dh_rec = np.zeros((B, H), f32)
        for part in slots[:-(-H // U)]:  # the CTAs that own units
            dh_rec = dh_rec + part
    return out


@pytest.mark.parametrize("T,B,H,reverse", [(5, 3, 8, False), (6, 2, 40, True), (4, 3, 80, False)])
def test_k7_replay_matches_plain(T, B, H, reverse):
    """K7's reduction order (lane chains, shuffle tree, slots in rank order,
    replayed in numpy) computes `lstm_rec_bwd_plain`'s gate gradients to
    1e-5: fp32 on both sides, only the order of the sums differs."""
    rng = np.random.RandomState(40 + H)
    w_hh = rng.uniform(-H ** -0.5, H ** -0.5, (4 * H, H)).astype(np.float32)
    gates = rng.randn(T, B, 4 * H).astype(np.float32)
    cs = (0.5 * rng.randn(T, B, H)).astype(np.float32)
    g_hs = rng.randn(T, B, H).astype(np.float32)
    want = K.lstm_rec_bwd_plain(reverse, _t(w_hh), _t(gates), _t(cs), _t(g_hs)).numpy()
    np.testing.assert_allclose(_k7_replay(reverse, w_hh, gates, cs, g_hs), want, rtol=0,
                               atol=ATOL)
