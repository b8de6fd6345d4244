"""The port's attention step (`semi_tts_tpu_torch/models/attention.py`,
kernel K3 via its plain version on the CPU) against
`semi_tts_tpu.models.attention`."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_tts_tpu.models import attention as J
from semi_tts_tpu_torch.bridge import load_jax_params
from semi_tts_tpu_torch.kernels.attention import attention_step_plain
from semi_tts_tpu_torch.models import attention as P

ATOL = 1e-5  # fp32 on both sides; only summation orders differ


def _setup(use_summed_weights=True, loc_aware=True, seed=0, L=13, D=10, A=8):
    B, Q, F, K = 3, 12, 4, 7  # L not a multiple of 32 by default
    params = J.attention_init(jax.random.PRNGKey(seed), Q, D, A, F, K, loc_aware=loc_aware,
                              use_summed_weights=use_summed_weights)
    params = jax.tree_util.tree_map(np.asarray, params)
    attn = P.Attention(Q, D, A, F, K, loc_aware=loc_aware,
                       use_summed_weights=use_summed_weights, generator=torch.Generator())
    load_jax_params(attn, params, {})
    rng = np.random.RandomState(seed)
    C = 2 if use_summed_weights else 1
    query = rng.randn(B, Q).astype(np.float32)
    memory = rng.randn(B, L, D).astype(np.float32)
    hist = np.abs(rng.rand(B, C, L)).astype(np.float32)
    lengths = np.array([L, 5, 9])
    mask = np.arange(L)[None, :] >= lengths[:, None]
    return params, attn, query, memory, hist, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("use_summed_weights", [True, False])
def test_attention_step_matches_jax(masked, use_summed_weights):
    params, attn, query, memory, hist, mask = _setup(use_summed_weights)
    pm_j = J.process_memory(params, jnp.asarray(memory))
    ctx_j, w_j = J.attention_step(params, jnp.asarray(query), jnp.asarray(memory), pm_j,
                                  jnp.asarray(hist), mask=jnp.asarray(mask) if masked else None)
    with torch.no_grad():
        mem_t = torch.from_numpy(memory)
        pm_t = P.process_memory(attn, mem_t)
        ctx_p, w_p = P.attention_step(attn, torch.from_numpy(query), mem_t, pm_t,
                                      torch.from_numpy(hist),
                                      mask=torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(pm_t.numpy(), np.asarray(pm_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ctx_p.numpy(), np.asarray(ctx_j), rtol=0, atol=ATOL)
    if masked:
        assert np.all(w_p.numpy()[mask] == 0.0)


def test_attention_step_without_location_matches_jax():
    params, attn, query, memory, hist, _ = _setup(loc_aware=False, seed=1)
    pm_j = J.process_memory(params, jnp.asarray(memory))
    ctx_j, w_j = J.attention_step(params, jnp.asarray(query), jnp.asarray(memory), pm_j,
                                  jnp.asarray(hist))
    with torch.no_grad():
        mem_t = torch.from_numpy(memory)
        ctx_p, w_p = P.attention_step(attn, torch.from_numpy(query), mem_t,
                                      P.process_memory(attn, mem_t), torch.from_numpy(hist))
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ctx_p.numpy(), np.asarray(ctx_j), rtol=0, atol=ATOL)


def test_kernel_wrapper_takes_plain_version_on_cpu():
    """The K3 wrapper on CPU tensors returns exactly its plain version and
    counts no launch."""
    from semi_tts_tpu_torch.kernels import attention as k3

    _, attn, query, memory, hist, mask = _setup()
    with torch.no_grad():
        mem_t = torch.from_numpy(memory)
        pm = P.process_memory(attn, mem_t)
        pq = query @ attn.query_layer.w.numpy().T
        args = (torch.from_numpy(pq), pm, mem_t, torch.from_numpy(hist), attn.loc_conv.w,
                attn.loc_linear.w, attn.v.w.reshape(-1), torch.from_numpy(mask))
        before = k3.attention_step.launches
        got = k3.attention_step(*args)
        want = attention_step_plain(*args)
    assert k3.attention_step.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


FLAGSHIP = dict(B=16, L=32, A=256, D=512, C=2, F_=32, K=31)  # decoder attention, B=16 serving


def test_attention_plan_flagship():
    """One cluster of 8 CTAs per batch row: 128 CTAs at B=16, 32 attention and
    64 context columns each, memory staged in shared memory."""
    from semi_tts_tpu_torch.kernels import attention as k3, build

    plan = k3.attention_plan(**FLAGSHIP)
    assert plan["cluster"] == 8 and plan["grid"] == (128,) and plan["threads"] == 256
    assert (plan["a_per_cta"], plan["d_per_cta"]) == (32, 64)
    assert plan["stage_memory"] and plan["loc_tile"] == 32
    assert plan["smem_bytes"] <= build.SMEM_PER_BLOCK


@pytest.mark.parametrize("L", [1, 45, 1000, 1024])
def test_attention_plan_fits_up_to_1024_positions(L):
    from semi_tts_tpu_torch.kernels import attention as k3, build

    plan = k3.attention_plan(**{**FLAGSHIP, "L": L})
    assert plan["smem_bytes"] <= build.SMEM_PER_BLOCK
    assert plan["loc_tile"] == min(L, k3.LOC_TILE)
    # memory is read from L2 once its slice (L x 64 floats) no longer fits
    assert plan["stage_memory"] == (L <= 299)


@pytest.mark.parametrize("change", [dict(A=260), dict(D=516), dict(A=4), dict(A=32_000),
                                    dict(L=0), dict(L=4096)])
def test_attention_plan_raises_outside_its_shapes(change):
    """L < 1 and widths where not one position fits a CTA's shared memory
    (A=32,000: a split CTA's pq, v and one position's processed memory alone
    are 384 KB) raise; A and D not divisible by the cluster (A=260, D=516,
    A=4) do not: CTA r takes ceil(A/8) and ceil(D/8) columns, cut at A and
    D; nor does a long memory (L=4,096): it takes the split route."""
    from semi_tts_tpu_torch.kernels import attention as k3

    if change.get("A") in (260, 4) or "D" in change:
        plan = k3.attention_plan(**{**FLAGSHIP, **change})
        A, D = change.get("A", FLAGSHIP["A"]), change.get("D", FLAGSHIP["D"])
        assert (plan["a_per_cta"], plan["d_per_cta"]) == (-(-A // 8), -(-D // 8))
        assert plan["chunks"] == 0 and plan["grid"] == (128,)
        return
    if change.get("L") == 4096:
        plan = k3.attention_plan(**{**FLAGSHIP, **change})
        span = min(k3.SPLIT_SPAN, plan["span"])
        assert plan["span"] == span and plan["chunk"] == 8 * span
        assert plan["chunks"] == -(-4096 // (8 * span)) and plan["grid"] == (8 * plan["chunks"], 16)
        return
    with pytest.raises(ValueError):
        k3.attention_plan(**{**FLAGSHIP, **change})


# (B, L, widths) of the split route: past the 1,187 positions one cluster
# holds at flagship widths; the 30 s speech-first step's memory (B=2); a
# ragged serving batch; location-free; loc_lin of A=1024, F=64
SPLIT = [(1, 1188, {}), (1, 1501, {}), (2, 1400, {}), (16, 1500, {}), (1, 8000, {}),
         (1, 2000, dict(F_=0, K=1)), (1, 1500, dict(A=1024, F_=64)), (3, 100_000, {})]


@pytest.mark.parametrize("B,L,widths", SPLIT)
def test_attention_plan_splits_past_one_cluster(B, L, widths):
    """Past the single-cluster fit, the plan splits a row into chunks of
    CLUSTER x ``span`` positions, a CTA ``span`` of them: at most SPLIT_SPAN
    where the batch's chunks then fit SPLIT_CLUSTERS clusters, else at most
    SPLIT_SPAN_WAVES, and what one CTA holds (loc_lin whole where it fits,
    else in tiles of ``lin_rows``), at least SPLIT_CLUSTERS // B chunks (of at least
    SPLIT_MIN_SPAN positions a CTA) so that B=1 fills the card; every CTA's
    shared memory fits; the wrapper's scratch holds the chunks' statistics
    and contexts; the plan one cluster a row takes is unchanged below. K9
    plans the same lengths within a block's shared memory."""
    from semi_tts_tpu_torch.kernels import attention as k3, build

    shape = {**FLAGSHIP, **widths, "B": B, "L": L}
    plan = k3.attention_plan(**shape)
    span, chunks = plan["span"], plan["chunks"]
    assert plan["chunk"] == 8 * span and chunks >= 2 and 8 * span * (chunks - 1) < L <= 8 * span * chunks
    assert plan["grid"] == (8 * chunks, B) and plan["smem_bytes"] <= build.SMEM_PER_BLOCK
    assert plan["threads"] <= 1024
    bwd = k3.attention_bwd_plan(**shape)   # K9 at the same length
    assert bwd["smem_bytes"] <= build.SMEM_PER_BLOCK and bwd["threads"] <= 1024
    assert plan["scratch_floats"] == B * chunks * (2 + shape["D"])
    A, F_ = shape["A"], shape["F_"]
    rows = plan["lin_rows"]
    assert (rows == 0) if not F_ else (rows == A or (rows % 32 == 0 and 32 <= rows < A))
    assert plan["smem_bytes"] == k3._split_smem(span, A, shape["D"], shape["C"], F_, shape["K"],
                                                plan["stage_memory"], rows)
    fits = lambda n, r: k3._split_smem(n, A, shape["D"], shape["C"], F_, shape["K"], False,
                                       r) <= build.SMEM_PER_BLOCK
    most = k3._most(lambda n: fits(n, A if fits(1, A) else min(A, 32)))
    one_wave = B * -(-L // (8 * min(most, k3.SPLIT_SPAN))) <= k3.SPLIT_CLUSTERS
    top = min(most, k3.SPLIT_SPAN if one_wave else k3.SPLIT_SPAN_WAVES)
    assert span <= top
    assert chunks == -(-L // (8 * -(-L // (8 * max(-(-L // (8 * top)),
                                                  min(k3.SPLIT_CLUSTERS // B,
                                                      -(-L // (8 * k3.SPLIT_MIN_SPAN))))))))
    Ac, Dc = A // 8, shape["D"] // 8
    one_cluster = k3._most_positions(Ac, Dc, shape["C"], F_, shape["K"], False)
    one = k3.attention_plan(**{**shape, "L": one_cluster})
    assert one["chunks"] == 0 and one["grid"] == (8 * B,) and one["chunk"] == one_cluster


def test_attention_plan_location_free():
    """loc_aware: false plans with F = 0: no location tiles, less shared memory."""
    from semi_tts_tpu_torch.kernels import attention as k3

    plan = k3.attention_plan(**{**FLAGSHIP, "F_": 0, "K": 1})
    assert plan["loc_tile"] == 0 and plan["grid"] == (128,)
    assert plan["smem_bytes"] < k3.attention_plan(**FLAGSHIP)["smem_bytes"]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("use_summed_weights,loc_aware", [(True, True), (False, True), (True, False)])
def test_attention_step_backward_matches_jax_grad(masked, use_summed_weights, loc_aware):
    """`_AttentionStep` (K9's plain version on the CPU) under autograd: the
    gradients of sum(context * gc) + sum(weights * gw) with respect to the
    query, memory, processed memory, history and every weight, against
    ``jax.grad`` of `attention_step`."""
    params, attn, query, memory, hist, mask = _setup(use_summed_weights, loc_aware, seed=2)
    rng = np.random.RandomState(7)
    pm = rng.randn(*memory.shape[:2], 8).astype(np.float32)
    gc = rng.randn(memory.shape[0], memory.shape[2]).astype(np.float32)
    gw = rng.randn(*memory.shape[:2]).astype(np.float32)
    m = jnp.asarray(mask) if masked else None

    def f(p, q, mem, pm_, h):
        ctx, w = J.attention_step(p, q, mem, pm_, h, mask=m)
        return jnp.sum(ctx * gc) + jnp.sum(w * gw)

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(params, *map(jnp.asarray, (query, memory, pm, hist)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (query, memory, pm, hist)]
    ctx, w = P.attention_step(attn, leaves[0], leaves[1], leaves[2], leaves[3],
                              mask=torch.from_numpy(mask) if masked else None)
    names = ["query_layer", "v"] + (["loc_conv", "loc_linear"] if loc_aware else [])
    weights = [getattr(attn, n).w for n in names]
    got = torch.autograd.grad((ctx * torch.from_numpy(gc)).sum() + (w * torch.from_numpy(gw)).sum(),
                              leaves + weights, allow_unused=True)
    for g, wt, what in zip(got, want[1:], ("query", "memory", "processed_memory", "hist")):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=0, atol=ATOL, err_msg=what)
    for g, n in zip(got[4:], names):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[0][n]["w"]), rtol=0, atol=ATOL,
                                   err_msg=n)
    if masked:
        assert np.all(got[1].numpy()[mask] == 0.0) and np.all(got[2].numpy()[mask] == 0.0)


@pytest.mark.parametrize("loc_aware", [True, False])
def test_attention_step_bwd_plain_matches_autograd(loc_aware):
    """K9's plain version (closed form) equals autograd through K3's plain
    version, every output, with a mask."""
    from semi_tts_tpu_torch.kernels import attention as k3

    _, attn, query, memory, hist, mask = _setup(loc_aware=loc_aware, seed=3)
    rng = np.random.RandomState(8)
    B, L, _ = memory.shape
    ins = [torch.from_numpy(a).requires_grad_(True)
           for a in (rng.randn(B, 8).astype(np.float32), rng.randn(B, L, 8).astype(np.float32),
                     memory, hist)]
    wts = [attn.loc_conv.w, attn.loc_linear.w] if loc_aware else [None, None]
    args = ins + wts + [attn.v.w.reshape(-1)]
    ctx, w = k3.attention_step_plain(*args, torch.from_numpy(mask))
    gc, gw = torch.randn(ctx.shape), torch.randn(w.shape)
    leaves = ins + [a for a in wts if a is not None] + [attn.v.w]
    want = torch.autograd.grad((ctx * gc).sum() + (w * gw).sum(), leaves, allow_unused=True)
    before = k3.attention_step_bwd.launches
    got = k3.attention_step_bwd(*[a.detach() if a is not None else None for a in args],
                                w.detach(), ctx.detach(), gc, gw)
    assert k3.attention_step_bwd.launches == before
    got = [g for g in got if g is not None]
    for g, wt in zip(got, want):
        wt = torch.zeros_like(g) if wt is None else wt.reshape(g.shape)  # hist unused: F = 0
        torch.testing.assert_close(g, wt, rtol=0, atol=ATOL)


def test_attention_bwd_plan_flagship():
    """K9 at every (B, L) the train steps give it, flagship widths: a CTA of
    256 threads for each span of positions and batch row; the span the one
    of `SPANS` with the least (CTAs an SM) x (span + SPAN_COST), the smaller
    on a tie (4 at L=32, 20 at B=16 L=133, 12 at B=2 L=700); loc_lin in
    shared memory, two CTAs an SM up to spans of 20; one partials row a
    (row, span); up to the 1,187 positions K3 takes (the first L that K3
    refuses, K9 refuses too); outside its shapes it raises."""
    from semi_tts_tpu_torch.kernels import attention as k3

    shapes = {**FLAGSHIP, "B": 8}
    # (B, L): (span, spans): paired, text-first, speech-first, the 15.28 s
    # step, the longest memory K3 takes, and two more
    expect = {(8, 32): (4, 8), (16, 32): (4, 8), (16, 133): (20, 7), (2, 679): (12, 57),
              (2, 700): (12, 59), (2, 1187): (20, 60), (16, 280): (20, 14), (5, 1): (4, 1)}
    for (B_, L), (span, spans) in expect.items():
        plan = k3.attention_bwd_plan(**{**shapes, "B": B_, "L": L})
        assert (plan["span"], plan["spans"], plan["grid"]) == (span, spans, (spans, B_))
        assert plan["threads"] == 256 and plan["stage_lin"]
        cost = {P: -(-B_ * -(-L // P) // k3.SMS) * (P + k3.SPAN_COST) for P in k3.SPANS}
        assert cost[span] == min(cost.values()) and span == min(P for P in cost
                                                                if cost[P] == cost[span])
        # two CTAs an SM (228 KB, 1 KB of it reserved a CTA) up to spans of 20
        assert 2 * (plan["smem_bytes"] + 1024) <= 228 * 1024
        window = -(-2 * (span + 30) // 4) * 4
        assert plan["part_floats"] == B_ * spans * (1984 + 32 * 256 + 256 + 256 + window)
    free = k3.attention_bwd_plan(**{**shapes, "F_": 0, "K": 1})
    assert not free["stage_lin"] and free["span"] == 4 and free["part_floats"] == 8 * 8 * 512
    # past the single cluster K3 splits, and K9 takes the same lengths
    first_split = dict(L=1188)
    assert k3.attention_plan(**{**shapes, **first_split})["chunks"] == 10  # spans of 16 past a wave
    assert k3.attention_bwd_plan(**{**shapes, **first_split})["span"] == 28
    for change in (dict(A=260), dict(D=516)):  # any width: a thread a column, guarded
        assert k3.attention_bwd_plan(**{**shapes, **change})["span"] == 4
    for change in (dict(L=0), dict(A=0), dict(D=0)):
        with pytest.raises(ValueError):
            k3.attention_bwd_plan(**{**shapes, **change})


def _longest(plan, widths):
    """The largest L that ``plan`` takes at ``widths`` (0 if none)."""
    lo, hi = 0, 1 << 15
    while lo < hi:
        mid = (lo + hi + 1) // 2
        try:
            plan(1, mid, *widths)
            lo = mid
        except ValueError:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("A,D,C,F_,K", [(256, 512, 2, 32, 31), (8, 16, 2, 4, 7), (8, 8, 1, 64, 31),
                                         (32, 64, 2, 64, 31), (1024, 512, 1, 0, 1),
                                         (4096, 8, 2, 64, 31), (2048, 4096, 2, 8, 7)])
def test_attention_bwd_plan_takes_every_length_k3_takes(A, D, C, F_, K):
    """K9 takes every memory length K3 takes, at the flagship's widths, the
    tests' and others down to one attention column a CTA: both take every
    L up to the search's top (2^15; K3 splitting a row into chunks past one
    cluster), with shared memory that fits a block at the top; K9's does
    not grow with L (a span of positions, the row's weights read from L2),
    and where loc_lin does not fit it is read from L2 too."""
    from semi_tts_tpu_torch.kernels import attention as k3

    widths = (A, D, C, F_, K)
    k3_max = _longest(k3.attention_plan, widths)
    assert k3_max == 1 << 15 and _longest(k3.attention_bwd_plan, widths) == k3_max
    assert k3.attention_bwd_plan(1, k3_max, *widths)["smem_bytes"] <= k3.build.SMEM_PER_BLOCK
    assert k3.attention_plan(1, k3_max, *widths)["smem_bytes"] <= k3.build.SMEM_PER_BLOCK


def _k9_replay(pq, pm, memory, hist, loc_w, loc_lin, v, weights, context, d_context, d_weights,
               span):
    """K9's decomposition in torch, as csrc/attention.cu computes it: for
    each (row, span of ``span`` positions) its partials from that span's
    positions alone (s from the row's weights, d_weights and the forward's
    context; the location features over the history window; d_attn_hist
    over the window [l0 - pad, l0 + span + pad), the halo), then the fixed-
    order sums: the weight gradients over every (row, span), d_pq over a
    row's spans, d_attn_hist over the spans whose window holds the
    position. Returns what `attention_step_bwd_plain` returns."""
    B, L, A = pm.shape
    n_filt, C, K = loc_w.shape
    pad, P = (K - 1) // 2, span
    S, W = -(-L // P), P + K - 1
    grow = lambda t: torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, S * P - L))
    pm_p, mem_p, w_p, dwt_p = grow(pm), grow(memory), grow(weights), grow(d_weights)
    hp = torch.nn.functional.pad(hist, (pad, pad + S * P - L))     # hp[..., i]: position i - pad
    s = (weights * d_weights).sum(1) + (context * d_context).sum(1)
    d_pm = torch.zeros(B, S * P, A)
    sums = {"lw": 0.0, "ll": 0.0, "v": 0.0}
    d_pq, d_hist = torch.zeros(B, A), torch.zeros(B, C, L)
    for b in range(B):
        for sp in range(S):
            rows = slice(sp * P, sp * P + P)
            win = hp[b, :, sp * P:sp * P + W]                          # (C, W)
            de = w_p[b, rows] * (dwt_p[b, rows] + mem_p[b, rows] @ d_context[b] - s[b])
            unf = win.unfold(1, P, 1)                                  # (C, K, P): win[c, k + l]
            locf = torch.einsum("fck,ckl->lf", loc_w, unf)             # (P, F)
            th = torch.tanh((pq[b] + locf @ loc_lin.T) + pm_p[b, rows])
            dp = de[:, None] * v * (1.0 - th * th)
            d_pm[b, rows] = dp
            d_loc = dp @ loc_lin                                       # (P, F)
            ext = torch.zeros(C, W)                                    # d_attn_hist over the window
            for l in range(P):
                ext[:, l:l + K] += torch.einsum("fck,f->ck", loc_w, d_loc[l])
            sums["lw"] = sums["lw"] + torch.einsum("lf,ckl->fck", d_loc, unf)
            sums["ll"] = sums["ll"] + dp.T @ locf
            sums["v"] = sums["v"] + (de[:, None] * th).sum(0)
            d_pq[b] += dp.sum(0)
            for j in range(W):
                x = sp * P - pad + j
                if 0 <= x < L:
                    d_hist[b, :, x] += ext[:, j]
    d_memory = weights[:, :, None] * d_context[:, None, :]
    return d_pq, d_pm[:, :L], d_memory, d_hist, sums["lw"], sums["ll"], sums["v"]


# (L, masked, span): span None is the plan's (4 at these shapes); L=1,300 is
# past what one K3 cluster holds at flagship widths
K9_REPLAYS = ([(L, m, span) for span in (None, 20)
               for L, m in ((1, False), (5, False), (45, True), (133, False))]
              + [(1300, True, 20), (1300, True, 32)])


@pytest.mark.parametrize("L,masked,span", K9_REPLAYS)
def test_attention_bwd_decomposition_matches_plain_and_jax_grad(L, masked, span, monkeypatch):
    """The per-span decomposition K9 computes (`_k9_replay`, at the plan's
    span and at 20; at L=1,300 at 20 and 32) against `attention_step_bwd_plain` and, through
    `_AttentionStep` in place of the wrapper, against ``jax.grad`` of the JAX
    `attention_step`: every input and weight gradient within ATOL (fp32 on
    all sides; s = sum w d_weights + context . d_context differs from
    sum w dw only in rounding)."""
    from semi_tts_tpu_torch.kernels import attention as k3

    A, D = 16, 16  # the widths off the cluster's multiples: test_attention_step_at_odd_widths_*
    params, attn, query, memory, hist, mask = _setup(seed=4, L=L, D=D, A=A)
    B = memory.shape[0]
    span = span or k3.attention_bwd_plan(B, L, A, D, 2, 4, 7)["span"]
    rng = np.random.RandomState(9)
    pm = rng.randn(B, L, A).astype(np.float32)
    gc = rng.randn(B, D).astype(np.float32)
    gw = rng.randn(B, L).astype(np.float32)
    m = jnp.asarray(mask) if masked else None

    with torch.no_grad():
        pq = torch.from_numpy(query) @ attn.query_layer.w.T
        args = (pq, torch.from_numpy(pm), torch.from_numpy(memory), torch.from_numpy(hist),
                attn.loc_conv.w, attn.loc_linear.w, attn.v.w.reshape(-1))
        ctx, w = k3.attention_step_plain(*args, torch.from_numpy(mask) if masked else None)
        cot = (ctx, torch.from_numpy(gc), torch.from_numpy(gw))
        got = _k9_replay(*args, w, *cot, span)
        want = k3.attention_step_bwd_plain(*args, w, *cot)
    for g, wt, what in zip(got, want, ("d_pq", "d_pm", "d_memory", "d_hist", "d_loc_w",
                                       "d_loc_lin", "d_v")):
        np.testing.assert_allclose(g.numpy(), wt.numpy(), rtol=0, atol=ATOL, err_msg=what)

    def f(p, q, mem, pm_, h):
        c, wts = J.attention_step(p, q, mem, pm_, h, mask=m)
        return jnp.sum(c * gc) + jnp.sum(wts * gw)

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(params, *map(jnp.asarray, (query, memory, pm, hist)))
    monkeypatch.setattr(k3, "attention_step_bwd", lambda *a: _k9_replay(*a, span))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (query, memory, pm, hist)]
    c, wts = P.attention_step(attn, *leaves, mask=torch.from_numpy(mask) if masked else None)
    names = ["query_layer", "v", "loc_conv", "loc_linear"]
    got = torch.autograd.grad((c * torch.from_numpy(gc)).sum() + (wts * torch.from_numpy(gw)).sum(),
                              leaves + [getattr(attn, n).w for n in names])
    for g, wt, what in zip(got, want[1:], ("query", "memory", "processed_memory", "hist")):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=0, atol=ATOL, err_msg=what)
    for g, n in zip(got[4:], names):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[0][n]["w"]), rtol=0, atol=ATOL,
                                   err_msg=n)


def _k3_split_replay(pq, pm, memory, hist, loc_w, loc_lin, v, mask, span):
    """K3's split route in torch, as csrc/attention.cu `attention_split_kernel`
    computes it: the row in chunks of CLUSTER x ``span`` positions, CTA r of
    a chunk the ``span`` positions from (chunk x CLUSTER + r) x span (none
    past the row). Each CTA takes the energies of its own positions (the
    location conv over its history window, (K-1)/2 halo on either side, zero
    past the row), its maximum m_r, s_r = sum exp(e - m_r) and its
    unnormalised context (0 where every position is masked or there is
    none); the chunk's m_c = max m_r, s_c and context the CTAs' in rank
    order, each scaled by exp(m_r - m_c) (0 for a CTA whose positions are
    all masked); then the row's m = max m_c, s = sum s_c exp(m_c - m),
    weights = exp(e - m) / s and context = sum exp(m_c - m) ctx_c / s in
    chunk order. Returns (context, weights, stats (B, chunks, 2))."""
    from semi_tts_tpu_torch.kernels.attention import CLUSTER

    B, L, _ = pm.shape
    D = memory.shape[2]
    pad = (loc_w.shape[2] - 1) // 2 if loc_w is not None else 0
    ninf = torch.full((B,), float("-inf"))
    energies, stats, ctxs = [], [], []
    for c0 in range(0, L, CLUSTER * span):
        ms, ss, cs = [], [], []
        for r in range(CLUSTER):
            l0 = c0 + r * span
            n = max(0, min(span, L - l0))
            if n == 0:
                ms.append(ninf), ss.append(torch.zeros(B)), cs.append(torch.zeros(B, D))
                continue
            energy_in = pq[:, None, :]
            if loc_w is not None:
                x0, x1 = l0 - pad, l0 + n + pad
                win = torch.nn.functional.pad(hist[:, :, max(x0, 0):min(x1, L)],
                                              (max(-x0, 0), max(x1 - L, 0)))
                loc = torch.nn.functional.conv1d(win, loc_w)             # (B, F, n)
                energy_in = energy_in + loc.transpose(1, 2) @ loc_lin.T
            e = torch.tanh(energy_in + pm[:, l0:l0 + n]) @ v
            if mask is not None:
                e = e.masked_fill(mask[:, l0:l0 + n], float("-inf"))
            m = e.max(1).values
            p = torch.where((m == float("-inf"))[:, None], 0.0, torch.exp(e - m[:, None]))
            ms.append(m), ss.append(p.sum(1)), cs.append(torch.einsum("bl,bld->bd", p, memory[:, l0:l0 + n]))
            energies.append(e)
        m_c = torch.stack(ms, 1).max(1).values
        s_c, ctx_c = torch.zeros(B), torch.zeros(B, D)
        for m, s, ctx in zip(ms, ss, cs):                  # rank order
            scale = torch.where(m == float("-inf"), 0.0, torch.exp(m - m_c))
            s_c, ctx_c = s_c + scale * s, ctx_c + scale[:, None] * ctx
        stats.append(torch.stack([m_c, s_c], 1))
        ctxs.append(ctx_c)
    stats = torch.stack(stats, 1)
    m = stats[:, :, 0].max(1).values
    scale = torch.exp(stats[:, :, 0] - m[:, None])    # 0 for a masked chunk; NaN: a masked row
    s = (stats[:, :, 1] * scale).sum(1)
    weights = torch.exp(torch.cat(energies, 1) - m[:, None]) / s[:, None]
    context = (scale[:, :, None] * torch.stack(ctxs, 1)).sum(1) / s[:, None]
    return context, weights, stats


@pytest.mark.parametrize("chunk", [186, 101])  # positions a CTA: the plan's span at B=4 L=1,300; ragged
@pytest.mark.parametrize("loc_aware", [True, False])
def test_attention_split_replay_matches_plain_and_jax(loc_aware, chunk):
    """The split route's decomposition (`_k3_split_replay`: positions over a
    chunk's CTAs, the chunk's partials over the cluster in rank order, the
    row's in chunk order) at L=1,300 against K3's plain version and the JAX
    `attention_step` (fp32 on all sides: only summation orders differ, so
    ATOL): rows of length 1,300, 700 (its chunks past 700 wholly masked:
    they add 0) and 1 (one position left in the first CTA), and a row
    masked everywhere, which gives NaN as the plain version does (JAX is
    held on the others); with and without location features (F=0). Each
    parametrised ``chunk`` is a CTA's span here: the plan's at B=4 L=1,300
    (``chunk`` 186 stands for it), and 13, a ragged one (``chunk`` 101)."""
    from semi_tts_tpu_torch.kernels import attention as k3

    L = 1300
    params, attn, query, memory, hist, _ = _setup(loc_aware=loc_aware, seed=6, L=L, D=16, A=16)
    rng = np.random.RandomState(10)
    query, memory = (np.concatenate([a, rng.randn(1, *a.shape[1:]).astype(np.float32)])
                     for a in (query, memory))
    hist = np.concatenate([hist, np.abs(rng.rand(1, *hist.shape[1:])).astype(np.float32)])
    mask = np.arange(L)[None, :] >= np.array([L, 700, 1, 0])[:, None]
    plan = k3.attention_plan(4, L, **{k: FLAGSHIP[k] for k in ("A", "D", "C", "F_", "K")})
    span = plan["span"] if chunk == 186 else 13
    with torch.no_grad():
        mem_t = torch.from_numpy(memory)
        pm = P.process_memory(attn, mem_t)
        pq = torch.from_numpy(query) @ attn.query_layer.w.T
        args = (pq, pm, mem_t, torch.from_numpy(hist),
                attn.loc_conv.w if loc_aware else None, attn.loc_linear.w if loc_aware else None,
                attn.v.w.reshape(-1), torch.from_numpy(mask))
        ctx, w, stats = _k3_split_replay(*args, span)
        want_ctx, want_w = k3.attention_step_plain(*args)
    n_chunks = -(-L // (8 * span))
    assert stats.shape == (4, n_chunks, 2)
    dead = 700 // (8 * span) + 1                       # row 1's first chunk wholly past 700
    assert torch.isinf(stats[1, dead:, 0]).all() and (stats[1, dead:, 1] == 0).all()
    assert torch.isnan(ctx[3]).all() and torch.isnan(w[3]).all()
    assert torch.isnan(want_ctx[3]).all() and torch.isnan(want_w[3]).all()
    np.testing.assert_allclose(w[:3].numpy(), want_w[:3].numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ctx[:3].numpy(), want_ctx[:3].numpy(), rtol=0, atol=ATOL)
    assert np.all(w[:3].numpy()[mask[:3]] == 0.0)
    ctx_j, w_j = J.attention_step(params, jnp.asarray(query[:3]), jnp.asarray(memory[:3]),
                                  jnp.asarray(pm[:3].numpy()), jnp.asarray(hist[:3]),
                                  mask=jnp.asarray(mask[:3]))
    np.testing.assert_allclose(w[:3].numpy(), np.asarray(w_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ctx[:3].numpy(), np.asarray(ctx_j), rtol=0, atol=ATOL)


def test_attention_step_saves_k3_context_not_a_copy():
    """`_AttentionStep` keeps the context K3 returned (the tensor itself,
    B x D floats a step) for K9, beside the weights."""
    _, attn, query, memory, hist, mask = _setup(seed=5)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (query, memory, hist)]
    pm = P.process_memory(attn, leaves[1])
    ctx, w = P.attention_step(attn, leaves[0], leaves[1], pm, leaves[2],
                              mask=torch.from_numpy(mask))
    saved = ctx.grad_fn.saved_tensors
    assert saved[-2].data_ptr() == w.data_ptr() and saved[-1].data_ptr() == ctx.data_ptr()
    assert saved[-1].shape == ctx.shape == (3, 10)


# widths off the cluster's multiples, as a JAX config may give them
ODD_WIDTHS = [(100, 36), (1, 3)]


@pytest.mark.parametrize("L", [32, 5000])  # one cluster a row; the split route
@pytest.mark.parametrize("A,D", ODD_WIDTHS)
def test_attention_plans_take_widths_off_the_cluster(A, D, L):
    """K3 and K9 plan attention widths A and memory widths D that the
    cluster's 8 does not divide, on the single-cluster route (CTA r the
    ceil(A/8) and ceil(D/8) columns from r times those, cut at A and D: at
    A=1 seven CTAs own no attention column) and on the split route, every
    CTA's shared memory within a block's."""
    from semi_tts_tpu_torch.kernels import attention as k3, build

    shape = dict(B=4, L=L, A=A, D=D, C=2, F_=32, K=31)
    plan = k3.attention_plan(**shape)
    assert (plan["a_per_cta"], plan["d_per_cta"]) == (-(-A // 8), -(-D // 8))
    assert (plan["chunks"] > 0) == (L == 5000) and plan["smem_bytes"] <= build.SMEM_PER_BLOCK
    if plan["chunks"]:
        assert plan["scratch_floats"] == 4 * plan["chunks"] * (2 + D)
    bwd = k3.attention_bwd_plan(**shape)
    assert bwd["smem_bytes"] <= build.SMEM_PER_BLOCK and bwd["spans"] == -(-L // bwd["span"])


def _k3_replay(pq, pm, memory, hist, loc_w, loc_lin, v, mask):
    """K3's single-cluster route in torch, as csrc/attention.cu
    `attention_step_kernel` cuts the columns: CTA r of the row's cluster the
    ceil(A/8) attention and ceil(D/8) context columns from r times those, cut
    at A and D (none for a CTA past them). Each CTA's partial energies over
    its attention columns (0 where it owns none), summed in rank order in
    every CTA; the softmax; each CTA's context columns. Returns (context,
    weights, the CTAs' numbers of attention and context columns)."""
    from semi_tts_tpu_torch.kernels.attention import CLUSTER

    B, L, A = pm.shape
    D = memory.shape[2]
    Ac, Dc = -(-A // CLUSTER), -(-D // CLUSTER)
    energy_in = pq[:, None, :] + pm
    if loc_w is not None:
        loc = torch.nn.functional.conv1d(hist, loc_w, padding=(loc_w.shape[2] - 1) // 2)
        energy_in = energy_in + loc.transpose(1, 2) @ loc_lin.T
    e, ctx, owned = torch.zeros(B, L), [], []
    for r in range(CLUSTER):
        a0, a1 = min(A, r * Ac), min(A, r * Ac + Ac)
        e = e + torch.tanh(energy_in[:, :, a0:a1]) @ v[a0:a1]     # rank order
        owned.append((a1 - a0, min(D, r * Dc + Dc) - min(D, r * Dc)))
    if mask is not None:
        e = e.masked_fill(mask, float("-inf"))
    w = torch.softmax(e, 1)
    for r in range(CLUSTER):
        d0, d1 = min(D, r * Dc), min(D, r * Dc + Dc)
        ctx.append(torch.einsum("bl,bld->bd", w, memory[:, :, d0:d1]))
    return torch.cat(ctx, 1), w, owned


@pytest.mark.parametrize("A,D", ODD_WIDTHS)
def test_attention_step_at_odd_widths_replay_matches_plain_and_jax(A, D):
    """At widths the cluster does not divide, K3's uneven column slices
    (`_k3_replay`: at A=100, D=36 seven CTAs of 13 attention and 5 context
    columns and one of 9 and 1; at A=1, D=3 one CTA owns the attention
    column and three the context's) and the split route's decomposition
    (`_k3_split_replay`, its combine cut into the same context slices) give
    K3's plain version and JAX's `attention_step` on the same numpy-seeded
    inputs, within ATOL."""
    from semi_tts_tpu_torch.kernels import attention as k3

    params, attn, query, memory, hist, mask = _setup(seed=11, L=45, D=D, A=A)
    with torch.no_grad():
        mem_t = torch.from_numpy(memory)
        pm = P.process_memory(attn, mem_t)
        pq = torch.from_numpy(query) @ attn.query_layer.w.T
        args = (pq, pm, mem_t, torch.from_numpy(hist), attn.loc_conv.w, attn.loc_linear.w,
                attn.v.w.reshape(-1), torch.from_numpy(mask))
        ctx, w, owned = _k3_replay(*args)
        sctx, sw, _ = _k3_split_replay(*args, 4)
        want_ctx, want_w = k3.attention_step_plain(*args)
    Ac, Dc = -(-A // 8), -(-D // 8)
    assert [n for n, _ in owned] == [max(0, min(Ac, A - r * Ac)) for r in range(8)]
    assert sum(n for n, _ in owned) == A and sum(d for _, d in owned) == D
    ctx_j, w_j = J.attention_step(params, jnp.asarray(query), jnp.asarray(memory),
                                  jnp.asarray(pm.numpy()), jnp.asarray(hist),
                                  mask=jnp.asarray(mask))
    for c, wt in ((ctx, w), (sctx, sw)):
        np.testing.assert_allclose(wt.numpy(), want_w.numpy(), rtol=0, atol=ATOL)
        np.testing.assert_allclose(c.numpy(), want_ctx.numpy(), rtol=0, atol=ATOL)
        np.testing.assert_allclose(wt.numpy(), np.asarray(w_j), rtol=0, atol=ATOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(ctx_j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("A,D", ODD_WIDTHS)
def test_attention_step_at_odd_widths_gradient_matches_jax(A, D):
    """The attention step at widths the cluster does not divide, under
    autograd through `_AttentionStep` (K9's per-span decomposition,
    `_k9_replay`, in place of the wrapper): every input and weight gradient
    against ``jax.grad`` of JAX's `attention_step` on the same numpy-seeded
    inputs, within ATOL."""
    from semi_tts_tpu_torch.kernels import attention as k3

    params, attn, query, memory, hist, mask = _setup(seed=12, L=45, D=D, A=A)
    rng = np.random.RandomState(13)
    pm = rng.randn(*memory.shape[:2], A).astype(np.float32)
    gc = rng.randn(memory.shape[0], D).astype(np.float32)
    gw = rng.randn(*memory.shape[:2]).astype(np.float32)

    def f(p, q, mem, pm_, h):
        c, wts = J.attention_step(p, q, mem, pm_, h, mask=jnp.asarray(mask))
        return jnp.sum(c * gc) + jnp.sum(wts * gw)

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(params, *map(jnp.asarray, (query, memory, pm, hist)))
    span = k3.attention_bwd_plan(memory.shape[0], 45, A, D, 2, 4, 7)["span"]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (query, memory, pm, hist)]
    names = ["query_layer", "v", "loc_conv", "loc_linear"]
    real = k3.attention_step_bwd
    k3.attention_step_bwd = lambda *a: _k9_replay(*a, span)
    try:
        c, wts = P.attention_step(attn, *leaves, mask=torch.from_numpy(mask))
        got = torch.autograd.grad((c * torch.from_numpy(gc)).sum()
                                  + (wts * torch.from_numpy(gw)).sum(),
                                  leaves + [getattr(attn, n).w for n in names])
    finally:
        k3.attention_step_bwd = real
    for g, wt, what in zip(got, want[1:], ("query", "memory", "processed_memory", "hist")):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=0, atol=ATOL, err_msg=what)
    for g, n in zip(got[4:], names):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[0][n]["w"]), rtol=0, atol=ATOL,
                                   err_msg=n)
