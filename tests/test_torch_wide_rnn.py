"""The recurrences past the narrow kernels' plans (`semi_tts_tpu_torch/kernels/rnn.py`
`lstm_route`/`gru_route`, `wide_plan`; the wide routes K1w, K7w, K2w, K8w of
`csrc/rnn_wide.cu`) against `semi_tts_tpu.ops.rnn` and `semi_tts_tpu.models.lm`.

On the CPU the wrappers run their plain versions, so these hold the plain
recurrences and the autograd functions around them at widths the narrow
kernels do not take (H=258, not a multiple of 4; H=300 and RNNLM's 512,
past 288) to the JAX package: forward and VJP at 1e-5 (fp32 on both sides,
only the summation order of the step products differs), RNNLM's loss and
gradients at 1e-4 (the tolerances of tests/test_torch_lm.py)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_tts_tpu.models import lm as JL
from semi_tts_tpu.ops import rnn as J
from semi_tts_tpu_torch import kernels
from semi_tts_tpu_torch.bridge import _flatten, to_jax_params
from semi_tts_tpu_torch.kernels import rnn as K
from semi_tts_tpu_torch.models import lm as PL
from semi_tts_tpu_torch.ops import rnn as P

ATOL = 1e-5
LM_RTOL, LM_ATOL = 1e-4, 1e-6
H100_SMS = 132
# the JAX recurrences, jitted (a compile is cheaper than their eager scans)
LSTM_FWD, LSTM_BWD, GRU_FWD, GRU_BWD = (jax.jit(f, static_argnums=0) for f in (
    J._lstm_rec_fwd, J._lstm_rec_bwd, J._gru_rec_fwd, J._gru_rec_bwd))


@pytest.mark.parametrize("H,route", [(4, "narrow"), (256, "narrow"), (258, "wide"),
                                     (288, "narrow"), (292, "wide"), (512, "wide"),
                                     (1024, "wide")])
def test_lstm_route(H, route):
    """K1/K7 where their plans fit (4 <= H <= 288, H % 4 == 0), else K1w/K7w."""
    assert K.lstm_route(H) == route
    if route == "narrow":
        K.lstm_plan(8, H, 2, 15)
        K.lstm_bwd_plan(8, H, 2, 15)
    else:
        with pytest.raises(ValueError):
            K.lstm_plan(8, H, 2, 15)


@pytest.mark.parametrize("H,route", [(80, "narrow"), (128, "narrow"), (129, "wide"),
                                     (512, "wide")])
def test_gru_route(H, route):
    """K2/K8 at H <= 128, else K2w/K8w."""
    assert K.gru_route(H) == route
    if route == "wide":
        with pytest.raises(ValueError):
            K.gru_plan(8, H, 2)


@pytest.mark.parametrize("kernel", sorted(K.WIDE_GATES))
def test_wide_plans_fit_the_card(kernel):
    """Every wide plan at widths from 1 to 4,096 units, 1 to 64 rows and
    either number of directions fits an H100: at most one CTA an SM, the
    shared memory a block may use, its threads; its CTAs own every unit;
    the staged chunk and the rows kept in shared memory within their
    bounds. RNNLM's and the ASR's shapes keep all of W_hh on chip; H=0 and
    a staged row past shared memory raise."""
    fwd = not kernel.endswith("_bwd")
    G = K.WIDE_GATES[kernel]
    for H in (1, 7, 129, 258, 292, 300, 512, 1000, 1024, 2048, 4096):
        for B in (1, 5, 8, 64):
            for ndir in (1, 2):
                p = K.wide_plan(kernel, B, H, ndir, H100_SMS)
                assert p["ctas"] == p["grid"][0] * ndir <= H100_SMS
                U = p["units_per_cta"]
                assert p["grid"][0] * U >= H > (p["grid"][0] - 1) * U
                assert p["smem_bytes"] <= K.SMEM_PER_BLOCK and p["threads"] <= 1024
                assert 1 <= p["chunk"] <= min(K.WIDE_CHUNK, B)
                assert 0 <= p["rows_smem"] <= p["rows"]
                assert p["rows"] == (G if fwd else 1) * p["units_per_cta"]
                assert p["k"] == (H if fwd else G * H)
    for H, ndir in ((512, 1), (512, 2)):
        p = K.wide_plan(kernel, 8, H, ndir, H100_SMS)
        assert p["rows_smem"] == p["rows"] and p["chunk"] == 8
    for H in (0, 60000):  # no unit; a staged row of 60,000 values or more
        with pytest.raises(ValueError):
            K.wide_plan(kernel, 8, H, 1, H100_SMS)


def _np(t):
    return np.asarray(t.detach() if torch.is_tensor(t) else t)


def _lstm_case(rng, T, B, H):
    x = [(0.5 * rng.randn(T, B, 4 * H)).astype(np.float32) for _ in range(2)]
    w = [(rng.randn(4 * H, H) / np.sqrt(H)).astype(np.float32) for _ in range(2)]
    return w, x


@pytest.mark.parametrize("H", [258, 300])
def test_lstm_plain_matches_jax_fwd_and_bwd(H):
    """Both directions (the second reversed) through `_LSTMRec` on the CPU
    (K1's and K7's plain versions) against `_lstm_rec_fwd` and
    `_lstm_rec_bwd`: hs, cs, and dW_hh and dx_proj of a seeded cotangent."""
    rng = np.random.RandomState(H)
    T, B = 5, 2
    w, x = _lstm_case(rng, T, B, H)
    g = rng.randn(T, B, 2 * H).astype(np.float32)
    tw = [torch.from_numpy(a).requires_grad_(True) for a in w]
    tx = [torch.from_numpy(a).requires_grad_(True) for a in x]
    hs = P.lstm_rec_fn(tw[0], tw[1], tx[0], tx[1])
    grads = torch.autograd.grad(hs, tw + tx, torch.from_numpy(g))
    hs_c, cs_c = K.bilstm_rec_cs_plain(*[t.detach() for t in tw + tx])
    for k, reverse in enumerate((False, True)):
        want_hs, res = LSTM_FWD(reverse, jnp.asarray(w[k]), jnp.asarray(x[k]))
        sl = slice(k * H, (k + 1) * H)
        np.testing.assert_allclose(_np(hs[..., sl]), want_hs, rtol=0, atol=ATOL)
        np.testing.assert_allclose(_np(hs_c[..., sl]), want_hs, rtol=0, atol=ATOL)
        np.testing.assert_allclose(_np(cs_c[..., sl]), res[3], rtol=0, atol=ATOL)
        dw, dx = LSTM_BWD(reverse, res, jnp.asarray(g[..., sl]))
        np.testing.assert_allclose(_np(grads[k]), dw, rtol=0, atol=ATOL)
        np.testing.assert_allclose(_np(grads[2 + k]), dx, rtol=0, atol=ATOL)


@pytest.mark.parametrize("H", [258, 300])
def test_gru_plain_matches_jax_fwd_and_bwd(H):
    """Both directions through `_GRURec` on the CPU (K2's and K8's plain
    versions) against `_gru_rec_fwd` and `_gru_rec_bwd`: hs, and dW_hh,
    db_hh and dx_proj of a seeded cotangent."""
    rng = np.random.RandomState(H + 1)
    T, B = 5, 2
    x = [(0.5 * rng.randn(T, B, 3 * H)).astype(np.float32) for _ in range(2)]
    w = [(rng.randn(3 * H, H) / np.sqrt(H)).astype(np.float32) for _ in range(2)]
    b = [(0.1 * rng.randn(3 * H)).astype(np.float32) for _ in range(2)]
    g = rng.randn(T, B, 2 * H).astype(np.float32)
    tw, tb, tx = ([torch.from_numpy(a).requires_grad_(True) for a in arrs] for arrs in (w, b, x))
    hs = P.gru_rec_fn(tw[0], tw[1], tb[0], tb[1], tx[0], tx[1])
    grads = torch.autograd.grad(hs, tw + tb + tx, torch.from_numpy(g))
    for k, reverse in enumerate((False, True)):
        want_hs, res = GRU_FWD(reverse, *map(jnp.asarray, (w[k], b[k], x[k])))
        sl = slice(k * H, (k + 1) * H)
        np.testing.assert_allclose(_np(hs[..., sl]), want_hs, rtol=0, atol=ATOL)
        dw, db, dx = GRU_BWD(reverse, res, jnp.asarray(g[..., sl]))
        for got, want in ((grads[k], dw), (grads[2 + k], db), (grads[4 + k], dx)):
            np.testing.assert_allclose(_np(got), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnnlm_default_width_matches_jax(cell):
    """RNNLM at its default width (512 units, 2 layers), the width past
    the narrow kernels that the wide routes exist for: the masked
    next-token NLL and every gradient against JAX's `rnnlm_loss` on the same
    weights (vocab 12, T=6, B=2)."""
    V = 12
    m = PL.RNNLM(V, 6, module=cell, generator=torch.Generator().manual_seed(3))
    assert m.rnn[0].w_hh.shape[1] == 512
    params, _ = to_jax_params(m)
    rng = np.random.RandomState(4)
    text = rng.randint(3, V, size=(2, 7)).astype(np.int64)
    text[1, 5:] = 0
    tlen = (text != 0).sum(-1)
    args = (torch.from_numpy(text), torch.from_numpy(tlen))
    names, ps = zip(*m.named_parameters())
    loss = PL.rnnlm_loss(m, *args)
    got = torch.autograd.grad(loss, ps)
    jargs = (jnp.asarray(text), jnp.asarray(tlen))
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: JL.rnnlm_loss(p, None, *jargs, module=cell)))(params)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LM_RTOL)
    want = _flatten(jax.tree_util.tree_map(np.asarray, want))
    for n, gr in zip(names, got):
        w = want[n.replace(".", "/")]
        np.testing.assert_allclose(_np(gr), w, rtol=LM_RTOL, atol=LM_ATOL, err_msg=n)


def test_wide_wrappers_count_no_launch_on_cpu():
    """At wide widths the wrappers take their plain versions on CPU tensors
    and count no launch, narrow or wide."""
    before = kernels.launch_counts()
    T, B, H = 3, 2, 258
    w, x = (torch.zeros(4 * H, H), torch.zeros(4 * H, H)), (torch.zeros(T, B, 4 * H),) * 2
    K.lstm_rec(False, w[0], x[0])
    K.bilstm_rec(*w, *x)
    K.bilstm_rec_cs(w[0], None, x[0], None)
    K.bilstm_rec_bwd(*w, *x, torch.zeros(T, B, 2 * H), torch.zeros(T, B, 2 * H))
    Hg = 129
    wg, bg = torch.zeros(3 * Hg, Hg), torch.zeros(3 * Hg)
    xg = torch.zeros(T, B, 3 * Hg)
    K.gru_rec(True, wg, bg, xg)
    K.bigru_rec(wg, wg, bg, bg, xg, xg)
    K.bigru_rec_bwd(wg, None, torch.zeros(T, B, Hg), None, xg, None, torch.zeros(T, B, Hg))
    assert kernels.launch_counts() == before
    assert all(w.launches == 0 for w in kernels.WIDE)


# (kernel, B, H, ndir, the card's co-resident clusters of 8 at the plan, the
# design, the plan's CTAs a direction and its partials' batch rows at a
# time): K7w's and K8w's rows of chip_smoke.py (RNNLM's and the ASR's shapes,
# H=1024, B=5 at H=292 and 258, the GRU's 129; B=64, whose partials (2, B,
# H) take several chunks), a tiny H, B=256; G*U rows of W_hh past shared
# memory (1,024 units in both directions) and no cluster co-resident take
# the first design
WIDE_BWD_PLANS = [
    ("lstm_bwd", 8, 512, 1, 15, "cluster", 104, 8), ("lstm_bwd", 8, 512, 2, 15, "cluster", 56, 8),
    ("lstm_bwd", 8, 1024, 1, 15, "cluster", 120, 8), ("lstm_bwd", 5, 292, 2, 16, "cluster", 64, 5),
    ("lstm_bwd", 5, 258, 2, 15, "cluster", 56, 5), ("lstm_bwd", 1, 6, 2, 15, "cluster", 8, 1),
    ("lstm_bwd", 64, 512, 2, 15, "cluster", 56, 32),
    ("lstm_bwd", 256, 512, 2, 15, "cluster", 56, 16),
    ("lstm_bwd", 8, 1024, 2, 15, "grid", 64, None), ("lstm_bwd", 8, 512, 2, 0, "grid", 64, None),
    ("gru_bwd", 8, 512, 1, 15, "cluster", 104, 8), ("gru_bwd", 8, 1024, 1, 15, "cluster", 120, 8),
    ("gru_bwd", 5, 129, 2, 15, "cluster", 48, 5), ("gru_bwd", 64, 512, 2, 15, "cluster", 56, 32),
    ("gru_bwd", 8, 1024, 2, 15, "grid", 64, None), ("gru_bwd", 8, 512, 1, 0, "grid", 128, None)]


@pytest.mark.parametrize("kernel,B,H,ndir,fit,design,ctas,rows", WIDE_BWD_PLANS)
def test_wide_bwd_plan_takes_the_cluster_design_where_it_fits(kernel, B, H, ndir, fit, design,
                                                              ctas, rows):
    """K7w's and K8w's plan: the cluster design where its CTAs hold their
    G*U gate rows of W_hh and the partials of at least 8 batch rows (2,
    rows, H) in shared memory and its clusters of 8 fit the card at once
    (the most CTAs up to the SMs a direction, U = ceil(H / N), the fewest
    multiple of 8 CTAs that hold H; all B rows at a time where they fit,
    else the most multiple of 8 that do); else the first design's plan,
    unchanged."""
    G = K.WIDE_GATES[kernel]
    plan = K.wide_bwd_plan(B, H, ndir, H100_SMS, lambda *a: fit, kernel)
    assert plan["design"] == design and plan["grid"] == (ctas, ndir)
    assert plan.get("batch_rows") == rows
    U = plan["units_per_cta"]
    assert ctas * U >= H and plan["threads"] == 256 and plan["smem_bytes"] <= K.SMEM_PER_BLOCK
    if design == "grid":
        assert plan == dict(K.wide_plan(kernel, B, H, ndir, H100_SMS), design="grid")
        return
    assert ctas % K.WIDE_CLUSTER == 0 and ctas - K.WIDE_CLUSTER < -(-H // U) <= ctas
    assert ndir * ctas // 8 <= fit and ctas * ndir <= H100_SMS
    assert plan["rows_smem"] == plan["rows"] == G * U
    assert plan["smem_bytes"] == K._cluster_smem(G, B, H, U, rows) >= K.WIDE_ONE_CTA_SMEM
    assert rows == B or (rows % K.WIDE_CHUNK == 0 and K._cluster_smem(
        G, B, H, U, rows + K.WIDE_CHUNK) > K.SMEM_PER_BLOCK)
    assert plan["pub_floats"] == 2 * ndir * (ctas // 8) * B * H
    assert plan["flags"] == ndir * ctas


# (B, H, ndir, co-resident clusters, the design, CTAs a direction): K1w's row
# of chip_smoke.py (as K7w's), a tiny H; B=64 at 1,024 units, B=256 and 1,024
# units in both directions past shared memory, and no cluster co-resident
# take the first design. K2w's (`gru`): its row's shapes, with U a multiple
# of 4 (RNNLM-GRU's 512 units: 64 CTAs of 8, not 104 of 5; 1,024 units: 88
# of 12; 129: 40 of 4, the last 7 past the units), B=64, and the first
# design at 1,024 units in both directions and with no cluster co-resident.
WIDE_FWD_PLANS = [(8, 512, 1, 15, "cluster", 104), (8, 512, 2, 15, "cluster", 56),
                  (8, 1024, 1, 15, "cluster", 120), (5, 292, 2, 16, "cluster", 64),
                  (5, 258, 2, 15, "cluster", 56), (64, 512, 2, 15, "cluster", 56),
                  (1, 6, 1, 15, "cluster", 8), (64, 1024, 1, 15, "grid", 128),
                  (256, 512, 2, 15, "grid", 64), (8, 1024, 2, 15, "grid", 64),
                  (8, 512, 2, 0, "grid", 64)]
WIDE_GRU_FWD_PLANS = [(8, 512, 1, 15, "cluster", 64), (8, 1024, 1, 15, "cluster", 88),
                      (5, 129, 2, 16, "cluster", 40), (64, 512, 2, 15, "cluster", 48),
                      (1, 6, 1, 15, "cluster", 8), (8, 1024, 2, 15, "grid", 64),
                      (8, 512, 1, 0, "grid", 128)]


@pytest.mark.parametrize("kernel,B,H,ndir,fit,design,ctas", [
    pytest.param("lstm", *c, id="-".join(map(str, c))) for c in WIDE_FWD_PLANS] + [
    pytest.param("gru", *c, id="gru-" + "-".join(map(str, c))) for c in WIDE_GRU_FWD_PLANS])
def test_wide_fwd_plan_takes_the_cluster_design_where_it_fits(kernel, B, H, ndir, fit, design,
                                                              ctas):
    """K1w's and K2w's plan: the cluster design where a CTA's G*U gate rows
    of W_hh and its buffers fit shared memory and its clusters of 8 fit the
    card at once (N and U as K7w's, the GRU's U a multiple of 4); else the
    first design's plan, unchanged."""
    G = K.WIDE_GATES[kernel]
    plan = K.wide_fwd_plan(B, H, ndir, H100_SMS, lambda *a: fit, kernel)
    assert plan["design"] == design and plan["grid"] == (ctas, ndir)
    U = plan["units_per_cta"]
    assert ctas * U >= H and plan["threads"] == 256 and plan["smem_bytes"] <= K.SMEM_PER_BLOCK
    if design == "grid":
        assert plan == dict(K.wide_plan(kernel, B, H, ndir, H100_SMS), design="grid")
        return
    assert ctas % K.WIDE_CLUSTER == 0 and ctas - K.WIDE_CLUSTER < -(-H // U) <= ctas
    assert ndir * ctas // 8 <= fit and ctas * ndir <= H100_SMS
    assert plan["rows_smem"] == plan["rows"] == G * U and G * U % 4 == 0
    assert plan["smem_bytes"] == K._fwd_cluster_smem(G, B, H, U) >= K.WIDE_ONE_CTA_SMEM
    assert plan["words"] == 2 * ndir * B * H


def _k7w_cluster_replay(reverse, w_hh, gates, cs, g_hs, ctas, U):
    """K7w's cluster design (`csrc/rnn_wide.cu` `lstm_wide_bwd_cluster_kernel`)
    in torch, one direction: at each step phase A (the gate gradients of
    every unit, as the plain version), then each CTA p's partial dh_rec over
    all H units from its own 4U gate rows of W_hh in order (g, u) (rows of
    units past H add 0), then each cluster's sums of its 8 CTAs' partials in
    rank order, then dh_rec the clusters' sums in cluster order. Returns the
    gate gradients (T, B, 4H)."""
    T, B, H4 = gates.shape
    H = H4 // 4
    ia, fa, ga, oa = gates.split(H, dim=-1)
    ia, fa, ga, oa = torch.sigmoid(ia), torch.sigmoid(fa), torch.tanh(ga), torch.sigmoid(oa)
    tc = torch.tanh(cs)
    c_prev = K.shift_prev(cs, reverse)
    dh_rec, dc_rec = gates.new_zeros((B, H)), gates.new_zeros((B, H))
    out = gates.new_empty((T, B, H4))
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        i, f, g, o = ia[t], fa[t], ga[t], oa[t]
        dh = g_hs[t] + dh_rec
        dc = dc_rec + dh * o * (1.0 - tc[t] * tc[t])
        dg = torch.cat([dc * g * i * (1.0 - i), dc * c_prev[t] * f * (1.0 - f),
                        dc * i * (1.0 - g * g), dh * tc[t] * o * (1.0 - o)], dim=-1)
        out[t] = dg
        parts = []
        for p in range(ctas):
            acc = gates.new_zeros((B, H))
            for gate in range(4):
                for u in range(max(0, min(U, H - p * U))):
                    r = gate * H + p * U + u
                    acc = acc + dg[:, r, None] * w_hh[r]
            parts.append(acc)
        sums = []
        for c in range(ctas // K.WIDE_CLUSTER):
            acc = gates.new_zeros((B, H))
            for q in range(K.WIDE_CLUSTER):
                acc = acc + parts[c * K.WIDE_CLUSTER + q]
            sums.append(acc)
        dh_rec = gates.new_zeros((B, H))
        for s in sums:
            dh_rec = dh_rec + s
        dc_rec = dc * f
    return out


@pytest.mark.parametrize("H,reverse", [(258, False), (300, True)])
def test_k7w_cluster_replay_matches_plain_and_jax(H, reverse):
    """The cluster design's reduction order (`_k7w_cluster_replay`, at the
    plan's CTAs and units for B=2 on a card that fits 2 clusters: 16 CTAs
    in two clusters, the last CTA holding fewer units) gives the gate
    gradients of K7's plain version and of JAX's `_lstm_rec_bwd` within
    ATOL."""
    rng = np.random.RandomState(H + 7)
    T, B = 5, 2
    w, x = _lstm_case(rng, T, B, H)
    plan = K.wide_bwd_plan(B, H, 1, 16, lambda *a: 2, "lstm_bwd")
    assert plan["design"] == "cluster" and plan["grid"] == (16, 1)
    ctas, U = plan["grid"][0], plan["units_per_cta"]
    assert (ctas - 1) * U < H < ctas * U
    _, res = LSTM_FWD(reverse, jnp.asarray(w[0]), jnp.asarray(x[0]))
    g = rng.randn(T, B, H).astype(np.float32)
    _, want_dx = LSTM_BWD(reverse, res, jnp.asarray(g))
    t = torch.from_numpy
    hs, cs = t(np.asarray(res[2])), t(np.asarray(res[3]))
    gates = t(x[0]) + K.shift_prev(hs, reverse) @ t(w[0]).T  # the recomputed pre-activations
    with torch.no_grad():
        got = _k7w_cluster_replay(reverse, t(w[0]), gates, cs, t(g), ctas, U)
        plain = K.lstm_rec_bwd_plain(reverse, t(w[0]), gates, cs, t(g))
    np.testing.assert_allclose(_np(got), _np(plain), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_np(got), want_dx, rtol=0, atol=ATOL)


def _k1w_cluster_replay(reverse, w_hh, x_proj, ctas, U):
    """K1w's cluster design (`csrc/rnn_wide.cu` `lstm_wide_fwd_cluster_kernel`)
    in torch, one direction: at each step the gate pre-activations of
    cluster c's units (columns k0 = 8cU .. k0 + kc of h its own) as the
    kernel sums them: slice s of S (S = min(256 // U, 64): a thread a tile
    of 4 gate rows and a slice of the columns) of the own
    columns, then slice s of the other columns from k0 + kc on (mod H), each
    slice's partial in order, the slices' partials in slice order, added to
    x_proj; then the cell as the plain version. Returns (hs, cs)."""
    T, B, H4 = x_proj.shape
    H = H4 // 4
    S = min(256 // U, 64)
    h, c = x_proj.new_zeros((B, H)), x_proj.new_zeros((B, H))
    hs, cs = x_proj.new_empty((T, B, H)), x_proj.new_empty((T, B, H))
    for step, t in enumerate(range(T - 1, -1, -1) if reverse else range(T)):
        pre = x_proj.new_empty((B, H4))
        for cl in range(ctas // K.WIDE_CLUSTER):
            k0 = cl * K.WIDE_CLUSTER * U
            kc = min(K.WIDE_CLUSTER * U, H - k0)
            ko = H - kc
            units = torch.arange(k0, k0 + kc)
            rows = torch.cat([g * H + units for g in range(4)])
            cols = torch.cat([units, (k0 + kc + torch.arange(ko)) % H])
            w, hp = w_hh[rows][:, cols], h[:, cols]
            acc = x_proj.new_zeros((B, len(rows)))
            if step > 0:
                for s in range(S):
                    own = slice(kc * s // S, kc * (s + 1) // S)
                    oth = slice(kc + ko * s // S, kc + ko * (s + 1) // S)
                    acc = acc + (hp[:, own] @ w[:, own].T + hp[:, oth] @ w[:, oth].T)
            pre[:, rows] = x_proj[t][:, rows] + acc
        i, f, g, o = pre.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs[t], cs[t] = h, c
    return hs, cs


def _k2w_cluster_replay(reverse, w_hh, b_hh, x_proj, ctas, U):
    """K2w's cluster design (`csrc/rnn_wide.cu` `gru_wide_fwd_cluster_kernel`:
    K1w's at three gates) in torch, one direction: at each step the hidden
    products of cluster c's 3 x 8U gate rows as the kernel sums them (slice
    s of S = min(256 // (3U/4), 64) of the own columns, then of the other
    columns from k0 + kc on (mod H), the slices' partials in slice order);
    then the cell: r and z from (x_proj + b_h) + the product, n from x_n +
    r * (the product + b_hn), h = (1 - z) n + z h. Returns hs (T, B, H)."""
    T, B, H3 = x_proj.shape
    H = H3 // 3
    S = min(256 // (3 * U // 4), 64)
    h = x_proj.new_zeros((B, H))
    hs = x_proj.new_empty((T, B, H))
    for step, t in enumerate(range(T - 1, -1, -1) if reverse else range(T)):
        hp = x_proj.new_zeros((B, H3))
        for cl in range(ctas // K.WIDE_CLUSTER):
            k0 = cl * K.WIDE_CLUSTER * U
            if k0 >= H:
                continue
            kc = min(K.WIDE_CLUSTER * U, H - k0)
            ko = H - kc
            units = torch.arange(k0, k0 + kc)
            rows = torch.cat([g * H + units for g in range(3)])
            cols = torch.cat([units, (k0 + kc + torch.arange(ko)) % H])
            w, hc = w_hh[rows][:, cols], h[:, cols]
            acc = x_proj.new_zeros((B, len(rows)))
            if step > 0:
                for s in range(S):
                    own = slice(kc * s // S, kc * (s + 1) // S)
                    oth = slice(kc + ko * s // S, kc + ko * (s + 1) // S)
                    acc = acc + (hc[:, own] @ w[:, own].T + hc[:, oth] @ w[:, oth].T)
            hp[:, rows] = acc
        xr, xz, xn = x_proj[t].split(H, dim=-1)
        br, bz, bn = b_hh.split(H)
        hr, hz, hn = hp.split(H, dim=-1)
        r = torch.sigmoid(xr + br + hr)
        z = torch.sigmoid(xz + bz + hz)
        n = torch.tanh(xn + r * (hn + bn))
        h = (1.0 - z) * n + z * h
        hs[t] = h
    return hs


def _k8w_cluster_replay(reverse, w_hh, z, coef_h, g_hs, ctas, U):
    """K8w's cluster design (`gru_wide_bwd_cluster_kernel`: K7w's at three
    gates) in torch, one direction: at each step dh2 = g_hs + dh_rec, then
    each CTA p's partial over all H units from its own 3U gate rows of W_hh
    in order (g, u) times coef_h * [dh2, dh2, dh2], each cluster's sums of
    its 8 CTAs' partials in rank order, the clusters' sums in cluster order,
    plus dh2 * z: dh_rec. Returns dh2 (T, B, H)."""
    T, B, H = z.shape
    dh_rec = z.new_zeros((B, H))
    out = z.new_empty((T, B, H))
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        d = g_hs[t] + dh_rec
        out[t] = d
        v = coef_h[t] * d.repeat(1, 3)
        parts = []
        for p in range(ctas):
            acc = z.new_zeros((B, H))
            for gate in range(3):
                for u in range(max(0, min(U, H - p * U))):
                    r = gate * H + p * U + u
                    acc = acc + v[:, r, None] * w_hh[r]
            parts.append(acc)
        dh_rec = z.new_zeros((B, H))
        for cl in range(ctas // K.WIDE_CLUSTER):
            acc = z.new_zeros((B, H))
            for q in range(K.WIDE_CLUSTER):
                acc = acc + parts[cl * K.WIDE_CLUSTER + q]
            dh_rec = dh_rec + acc
        dh_rec = dh_rec + d * z[t]
    return out


@pytest.mark.parametrize("cell,H,reverse", [("lstm", 258, False), ("lstm", 300, True),
                                            ("gru", 258, True), ("gru", 300, False),
                                            ("gru_fwd", 258, False), ("gru_fwd", 300, True)])
def test_k1w_k8w_cluster_replays_match_plain_and_jax(cell, H, reverse):
    """The cluster designs' summation orders (`_k1w_cluster_replay`,
    `_k8w_cluster_replay`, `_k2w_cluster_replay`, at the plan's CTAs and
    units for B=2 on a card of 16 SMs that fits 2 clusters: 16 CTAs in two
    clusters, the last CTA holding fewer units, or, K2w's units a multiple
    of 4, none) give K1w's hs and cs, K8w's dh2 and K2w's hs as the plain
    versions do, and hs and cs of JAX's `_lstm_rec_fwd`, dx_proj of JAX's
    `_gru_rec_bwd` (coef_x * dh2) and hs of JAX's `_gru_rec_fwd`, within
    ATOL."""
    rng = np.random.RandomState(H + 11 + (cell == "gru") + 2 * (cell == "gru_fwd"))
    T, B = 5, 2
    t = torch.from_numpy
    if cell == "gru_fwd":
        x = (0.5 * rng.randn(T, B, 3 * H)).astype(np.float32)
        w = (rng.randn(3 * H, H) / np.sqrt(H)).astype(np.float32)
        b = (0.1 * rng.randn(3 * H)).astype(np.float32)
        plan = K.wide_fwd_plan(B, H, 1, 16, lambda *a: 2, "gru")
        ctas, U = plan["grid"][0], plan["units_per_cta"]
        assert plan["design"] == "cluster" and plan["grid"] == (16, 1) and U % 4 == 0
        assert ctas - K.WIDE_CLUSTER < -(-H // U) <= ctas
        want_hs, _ = GRU_FWD(reverse, *map(jnp.asarray, (w, b, x)))
        with torch.no_grad():
            got = _k2w_cluster_replay(reverse, t(w), t(b), t(x), ctas, U)
            plain = K.gru_rec_plain(reverse, t(w), t(b), t(x))
        np.testing.assert_allclose(_np(got), _np(plain), rtol=0, atol=ATOL)
        np.testing.assert_allclose(_np(got), np.asarray(want_hs), rtol=0, atol=ATOL)
        return
    if cell == "lstm":
        w, x = _lstm_case(rng, T, B, H)
        plan = K.wide_fwd_plan(B, H, 1, 16, lambda *a: 2)
        ctas, U = plan["grid"][0], plan["units_per_cta"]
        want_hs, res = LSTM_FWD(reverse, jnp.asarray(w[0]), jnp.asarray(x[0]))
        with torch.no_grad():
            got = _k1w_cluster_replay(reverse, t(w[0]), t(x[0]), ctas, U)
            plain = K.lstm_rec_cs_plain(reverse, t(w[0]), t(x[0]))
        want = (want_hs, res[3])
    else:
        x = (0.5 * rng.randn(T, B, 3 * H)).astype(np.float32)
        w = (rng.randn(3 * H, H) / np.sqrt(H)).astype(np.float32)
        b = (0.1 * rng.randn(3 * H)).astype(np.float32)
        g = rng.randn(T, B, H).astype(np.float32)
        plan = K.wide_bwd_plan(B, H, 1, 16, lambda *a: 2, "gru_bwd")
        ctas, U = plan["grid"][0], plan["units_per_cta"]
        _, res = GRU_FWD(reverse, *map(jnp.asarray, (w, b, x)))
        _, _, want_dx = GRU_BWD(reverse, res, jnp.asarray(g))
        with torch.no_grad():
            _, z, coef_h, coef_x = P.gru_bwd_coefficients(reverse, t(w), t(b), t(x),
                                                          t(np.asarray(res[3])))
            dh2 = _k8w_cluster_replay(reverse, t(w), z, coef_h, t(g), ctas, U)
            plain = K.gru_rec_bwd_plain(reverse, t(w), z, coef_h, t(g))
        got, want = (dh2, coef_x * dh2.repeat(1, 1, 3)), (None, want_dx)
    assert plan["design"] == "cluster" and plan["grid"] == (16, 1)
    assert (ctas - 1) * U < H < ctas * U
    for o, p_, j in zip(got, plain if cell == "lstm" else (plain, None), want):
        if p_ is not None:
            np.testing.assert_allclose(_np(o), _np(p_), rtol=0, atol=ATOL)
        if j is not None:
            np.testing.assert_allclose(_np(o), np.asarray(j), rtol=0, atol=ATOL)
