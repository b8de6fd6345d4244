"""The port's CTC (`semi_tts_tpu_torch/ops/ctc.py`, kernel K6 through its
plain version on the CPU) against `semi_tts_tpu.ops.ctc.ctc_loss` (custom
VJP) and `torch.nn.functional.ctc_loss`, NLL and gradient, with every edge
of the JAX lattice: input lengths below T, target length 0, T = 1,
repeated labels and an impossible alignment."""

from __future__ import annotations

import functools

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


# --- K6's launch plan and its decomposition (csrc/ctc.cu), replayed in torch ---


@pytest.mark.parametrize("lo", range(3, 1025, 128))
def test_ctc_plan_fits_every_state_count(lo):
    """Every S from 3 to 1,024 gets chain warps and states a lane that hold
    it, and a ring that fits a block's shared memory, forward and backward."""
    for S in range(lo, min(lo + 128, 1025)):
        plan = K6.ctc_plan(8, 133, S)
        K, W = plan["states_per_lane"], plan["chain_warps"]
        assert K in K6.STATES_PER_LANE and 1 <= W <= K6.MAX_CHAIN_WARPS and 32 * K * W >= S
        assert plan["beta_threads"] <= 1024
        assert max(plan["alpha_smem_bytes"], plan["beta_smem_bytes"]) <= 232_448


def test_ctc_plan_raises_past_its_states():
    """Past 512 states the plan takes two states a lane, past 1,024
    (`MAX_STATES`) a cluster of CTAs a row (two, then four, then eight
    states a lane), past a cluster's states (49,152 at 16 CTAs, 24,576 at
    8) a chain of clusters a row at 2 states a lane, at any row count; it
    raises only for S < 1."""
    assert K6.ctc_plan(8, 133, 513)["states_per_lane"] == 2
    assert K6.ctc_plan(8, 133, 1024)["lattice"] == "shared"
    assert K6.ctc_plan(8, 133, 1025)["lattice"] == "cluster"
    assert K6.ctc_plan(8, 133, 4097)["states_per_lane"] == 2
    assert K6.ctc_plan(8, 133, 12289)["states_per_lane"] == 4
    assert K6.ctc_plan(8, 133, 24577)["states_per_lane"] == 8
    assert K6.ctc_plan(8, 133, 49152)["lattice"] == "cluster"
    assert K6.ctc_plan(8, 133, 49153)["lattice"] == "chain"
    assert K6.ctc_plan(8, 133, 24576, max_cluster=8)["lattice"] == "cluster"
    assert K6.ctc_plan(8, 133, 24577, max_cluster=8)["lattice"] == "chain"
    with pytest.raises(ValueError):
        K6.ctc_plan(8, 133, 0)
    assert K6.ctc_plan(1 << 17, 133, 49153)["sync_ints"] == 1 + (1 << 17) * 5


def _cluster_plan_fits(plan, S, max_cluster):
    """A cluster plan holds S in P slices of 32 K W states, none empty,
    within a cluster the card takes and a block's threads and shared
    memory (at 4 and 8 states a lane the forward's copy warp beside the
    chain's; the backward's ring of alphas beside its occupancies)."""
    K, W, P = plan["states_per_lane"], plan["chain_warps"], plan["cluster"]
    n = 32 * K * W
    assert K in K6.CLUSTER_STATES_PER_LANE and 1 <= W <= K6.MAX_CLUSTER_WARPS
    assert 2 <= P <= max_cluster <= K6.MAX_CLUSTER and P * n >= S > (P - 1) * n
    assert plan["non_portable"] == (P > K6.PORTABLE_CLUSTER)
    assert plan["grid"][0] == P * 2 and plan["chunk"] == min(K6.CHUNK, 16 // K)
    assert plan["alpha_threads"] == 32 * (W + (K >= 4)) <= 416
    assert plan["beta_threads"] == 32 * (W + K6.CONSUMER_WARPS) <= 640
    assert plan["beta_smem_bytes"] == (K6._beta_smem(K, W) + 4 * 32 * W * K6.DEPTH * K6.CHUNK
                                       + K6.EDGE_BYTES)
    assert max(plan["alpha_smem_bytes"], plan["beta_smem_bytes"]) <= 232_448


@pytest.mark.parametrize("lo", range(1025, 8194, 1024))
def test_ctc_plan_takes_every_state_count_past_1024(lo):
    """Every S from 1,025 to 8,193 (the shared-memory lattice's four and
    eight states a lane are gone: the cluster route beats them there) takes
    a cluster of P CTAs a row, each a slice of 32 K W states at two states a
    lane in the fewest warps that keep P within 16, no slice empty, P > 8
    only non-portable, its shared memory (the lattice, the rings, the sort's
    keys, the edge) within a block's."""
    for S in range(lo, min(lo + 1024, 8194)):
        plan = K6.ctc_plan(2, 700, S)
        assert plan["lattice"] == "cluster" and plan["states_per_lane"] == 2
        assert plan["chain_warps"] == -(-S // (16 * 64))
        _cluster_plan_fits(plan, S, 16)
    assert K6.ctc_plan(2, 700, 4095)["beta_smem_bytes"] == 43_344


@pytest.mark.parametrize("max_cluster", [16, 8])
def test_ctc_cluster_plan_holds_every_state_count(max_cluster):
    """Every S the cluster route takes, at a card's 16 CTAs a cluster and at
    the portable 8: a plan that holds S with no empty slice, K growing from
    two states a lane to four, then eight, where 12 warps no longer hold S
    in ``max_cluster`` CTAs; then the chained route."""
    for S in range(K6.MAX_STATES + 1, max_cluster * 3072 + 2):
        plan = K6.ctc_plan(2, 700, S, max_cluster)
        if S > max_cluster * 3072:
            assert plan["lattice"] == "chain"
            continue
        assert plan["states_per_lane"] == (2 if S <= max_cluster * 768 else
                                           4 if S <= max_cluster * 1536 else 8)
        _cluster_plan_fits(plan, S, max_cluster)


@pytest.mark.parametrize("S", [3, 65, 129, 513, 1023, 1024, 4097, 8193, 24576])
def test_ctc_plan_needs_no_more_memory_for_longer_inputs(S):
    """The ring holds chunks of steps (a cluster's edge ring, steps), so T
    from 1 to 5,000 needs no more shared memory than T = 1."""
    at_one = K6.ctc_plan(8, 1, S)
    for T in (1, 2, 8, 9, 133, 700, 4999, 5000):
        plan = K6.ctc_plan(8, T, S)
        assert plan["alpha_smem_bytes"] <= at_one["alpha_smem_bytes"]
        assert plan["beta_smem_bytes"] <= at_one["beta_smem_bytes"]


def _k6_replay(lp, targets, ilen, tlen, blank=0):
    """K6 as `csrc/ctc.cu` decomposes it, row by row in torch: thread L of
    the row's chain warps (K states a thread, W warps, from `ctc_plan`)
    holds states L*K .. L*K+K-1 and reads s-1 and s-2 (backward: s+1 and
    s+2 of x = beta + emission) past its own from the lattice of the last
    two steps, which has -inf guard cells below state 0 (above the last
    state); its emissions (and, backward, alphas) come in chunks of `chunk`
    steps (backward `beta_chunk`) loaded a chunk ahead; the occupancies go
    through a ring of `DEPTH` chunks; the class-sum warps cut each run of a
    class in the valid states sorted by (class, s) at every multiple of
    `SEG` sorted states, sum each (segment, step) (here in order of s, on
    the card by shuffles in a fixed order), then each (run, step) over its
    segments in order. Returns
    (alphas (T, B, S), nll (B,), the gradient of sum(nll) (B, T, C))."""
    B, T, C = lp.shape
    U = targets.shape[1]
    S = 2 * U + 1
    plan = K6.ctc_plan(B, T, S)
    if plan["lattice"] == "cluster":  # past MAX_STATES: the cluster route, at its plan's slices
        return _k6_device_replay(lp, targets, ilen, tlen, plan["states_per_lane"],
                                 32 * plan["chain_warps"], blank)
    K, W, D = plan["states_per_lane"], plan["chain_warps"], K6.DEPTH
    n = 32 * K * W
    NEG = torch.tensor(K6.NEG_INF)
    s = torch.arange(n).view(32 * W, K)     # (thread, j) -> state
    zf = torch.full((B, n + 2), blank, dtype=torch.long)
    zf[:, 1:2 * U:2] = targets.long()
    alphas = torch.full((T, B, S), float("nan"))
    nll = torch.empty(B)
    grad = torch.zeros((B, T, C))
    for b in range(B):
        z = zf[b, :n].view(32 * W, K)
        tl = int(tlen[b])
        valid = s < 2 * tl + 1
        skip = valid & (s % 2 == 1) & (s >= 2) & (z != zf[b, (s - 2).clamp(min=0)])
        skip_from = (s % 2 == 1) & (s + 2 < S) & (zf[b, s + 2] != z)
        term = valid & ((s == 2 * tl) | ((s == 2 * tl - 1) & (tl > 0)))
        lpb = lp[b]

        CH = plan["chunk"]

        def chunk(k, rows):   # a thread's chunk k: rows[i] of its states, clamped steps
            return torch.stack([rows(i) for i in range(k * CH, k * CH + CH)])

        # forward: the lattice (2, 2 + n), two -inf guards below state 0
        Tc = max(1, min(int(ilen[b]), T))
        lat = torch.full((2, 2 + n), K6.NEG_INF)
        emit = lambda t: lpb[min(t, Tc - 1)][z]
        cur, nxt = chunk(0, emit), chunk(1, emit)
        out = torch.empty((T, 32 * W, K))
        for k in range(-(-Tc // CH)):
            for i in range(min(CH, Tc - k * CH)):
                t = k * CH + i
                if t == 0:
                    a = torch.where(valid & (s <= 1), cur[0], NEG)
                else:
                    prev = lat[(t - 1) & 1]
                    up1, up2 = prev[2 + s[:, 0] - 1], prev[2 + s[:, 0] - 2]
                    a1 = torch.cat([up1[:, None], a[:, :K - 1]], 1)
                    a2 = torch.cat([up2[:, None], up1[:, None], a[:, :K - 2]], 1)[:, -K:] \
                        if K >= 2 else up2[:, None]
                    a2 = torch.where(skip, a2, NEG)
                    a = torch.where(valid, K6._logaddexp3(a, a1, a2) + cur[i], NEG)
                lat[t & 1, 2:] = a.reshape(-1)
                out[t] = a
            cur, nxt = nxt, chunk(k + 2, emit)
        out[Tc:] = a
        al = out.view(T, n)
        alphas[:, b] = al[:, :S]
        fin = lat[(Tc - 1) & 1, 2:]
        a_last = fin[2 * tl - 1] if tl > 0 else NEG
        nll[b] = -K6._logaddexp(fin[2 * tl], a_last)

        # backward: the chain over steps t = Tc - 1 down to 0; x in a lattice
        # with two -inf guards above the last state
        Tc = min(int(ilen[b]), T)
        if Tc <= 0 or not nll[b] < -K6.NEG_INF / 2:
            continue
        step = lambda m: max(Tc - 1 - m, 0)
        CH = plan["beta_chunk"]
        emit_next = lambda m: lpb[min(step(m) + 1, Tc - 1)][z]
        alpha = lambda m: al[step(m)].view(32 * W, K)
        e_cur, e_nxt = chunk(0, emit_next), chunk(1, emit_next)
        a_cur, a_nxt = chunk(0, alpha), chunk(1, alpha)
        xlat = torch.full((2, n + 4), K6.NEG_INF)
        ring = torch.zeros((D, CH, n))
        order = sorted(range(2 * tl + 1), key=lambda q: (int(zf[b, q]), q))
        rank = {q: r for r, q in enumerate(order)}
        classes = sorted({int(zf[b, q]) for q in order})
        runs = [[q for q in order if int(zf[b, q]) == c] for c in classes]
        for k in range(-(-Tc // CH)):
            for i in range(min(CH, Tc - k * CH)):
                if k == 0 and i == 0:
                    beta = torch.where(term, 0.0, NEG)
                else:
                    x = torch.where(valid, beta + e_cur[i], NEG)
                    xlat[(k * CH + i) & 1, :n] = x.reshape(-1)
                    row = xlat[(k * CH + i) & 1]
                    dn1, dn2 = row[s[:, -1] + 1], row[s[:, -1] + 2]
                    x1 = torch.cat([x[:, 1:], dn1[:, None]], 1)
                    x2 = torch.cat([x[:, 2:], dn1[:, None], dn2[:, None]], 1)[:, :K] \
                        if K >= 2 else dn2[:, None]
                    x2 = torch.where(skip_from, x2, NEG)
                    beta = K6._logaddexp3(x, x1, x2)
                occ = torch.exp(torch.clamp(a_cur[i] + beta + nll[b], max=0.0))
                ring[k % D, i] = torch.where(valid, occ, 0.0).reshape(-1)
            # the class sums of the chunk: a (segment, step) each, in order of
            # s; then a (run, step) each over its segments, in order
            m = min(CH, Tc - k * CH)
            steps = Tc - 1 - (k * CH + torch.arange(m))
            for run in runs:
                acc = part = torch.zeros(m)
                for i, q in enumerate(run):
                    if i > 0 and rank[q] % K6.SEG == 0:   # a new segment
                        acc, part = acc + part, torch.zeros(m)
                    part = part + ring[k % D, :m, q]
                grad[b, steps, int(zf[b, run[0]])] = -(acc + part)
            e_cur, e_nxt = e_nxt, chunk(k + 2, emit_next)
            a_cur, a_nxt = a_nxt, chunk(k + 2, alpha)
    return alphas, nll, grad


def _k6_case(name):
    """(lp, targets, ilen, tlen) of each edge the kernels keep; at 1, 2 and 3
    chain warps (U = 4, 20, 40), at 2 states a lane in 10 warps (U=300), at
    T=300 (the ring's chunks many times over) and past the shared-memory
    lattice (S=1,025 over a short T=300, the cluster route's 9 CTAs of two
    warps at 2 states a lane: a row of 280 labels, none repeated, 561 valid
    states, and a row of all 512, which T cannot align: its alphas over
    every state, its gradient zero)."""
    if name == "S=1025":
        lp, targets, ilen, tlen = _inputs(B=2, T=300, C=9, U=512, seed=14)
        rng = np.random.RandomState(15)
        targets[:] = 1 + (np.cumsum(rng.randint(1, 8, size=(2, 512)), 1) % 8)  # no repeats
        targets[0, 280:] = 0
        tlen[:], ilen[:] = [280, 512], [300, 300]
        return lp, targets, ilen, tlen
    if name == "T=300":
        lp, targets, ilen, tlen = _inputs(B=3, T=300, C=9, U=24, seed=11)
        ilen[:] = [300, 217, 41]
        tlen[:] = [24, 20, 24]
        targets[1, 20:] = 0
        return lp, targets, ilen, tlen
    U = {"U=20": 20, "U=40": 40, "U=300": 300}.get(name, 4)
    lp, targets, ilen, tlen = _inputs(B=2 if U > 40 else 4, T=21 if U < 300 else 400, C=7, U=U,
                                      seed=12)
    if name == "U=300":
        targets[:] = np.random.RandomState(13).randint(1, 7, size=targets.shape)
        targets[1, 261:] = 0
        tlen[:] = [300, 261]
    if name == "input lengths below T":
        ilen[:] = [21, 9, 10, 1]
    elif name == "target length 0":
        targets[1], tlen[1] = 0, 0
    elif name == "T=1":
        lp, ilen = lp[:, :1].copy(), np.ones(4, np.int32)
        tlen[:] = [1, 0, 1, 0]
        targets[:, 1:] = 0
        targets[[1, 3]] = 0
    elif name == "repeated labels":
        targets[:] = [[3, 3, 5, 5], [2, 2, 2, 0], [1, 1, 1, 1], [4, 0, 0, 0]]
        tlen[:] = [4, 3, 4, 1]
    elif name == "impossible alignment":
        targets[0], tlen[0], ilen[0] = 4, 4, 6   # four equal labels need 7 frames
    return lp, targets, ilen, tlen


@pytest.fixture
def one_thread():
    """The replays run thousands of small torch ops, which intra-op threads
    only slow down (several times over on a shared host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """JAX's NLLs and gradient of sum(nll) on `_k6_case(name)` (one trace of
    both), computed once a process for both replays."""
    lp, targets, ilen, tlen = _k6_case(name)

    def total(x):
        nll = JC.ctc_loss(x, jnp.asarray(targets), jnp.asarray(ilen), jnp.asarray(tlen),
                          reduction="none")
        return jnp.sum(nll), nll

    (_, nll), grad = jax.value_and_grad(total, has_aux=True)(jnp.asarray(lp))
    return np.asarray(nll), np.asarray(grad)


K6_CASES = ["U=4", "U=20", "U=40", "U=300", "input lengths below T", "target length 0", "T=1",
            "repeated labels", "impossible alignment", "T=300", "S=1025"]


@pytest.mark.parametrize("name", K6_CASES)
def test_k6_replay_matches_plain_and_jax(name, one_thread):
    """The kernels' decomposition gives the plain versions' alphas, NLL and
    gradient, and JAX's custom VJP's NLL and gradient."""
    lp, targets, ilen, tlen = _k6_case(name)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    alphas, nll, grad = _k6_replay(t(lp), t(targets), t(ilen), t(tlen))
    want_a, want_nll = K6.ctc_alpha_plain(t(lp), t(targets), t(ilen), t(tlen))
    np.testing.assert_allclose(alphas.numpy(), want_a.numpy(), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(nll.numpy(), want_nll.numpy(), rtol=1e-6)
    want_g = K6.ctc_beta_grad_plain(t(lp), t(targets), t(ilen), t(tlen), want_a, want_nll,
                                    torch.ones(lp.shape[0]))
    np.testing.assert_allclose(grad.numpy(), want_g.numpy(), rtol=0, atol=ATOL)
    # against JAX's own exp and log: at T=300 the alphas reach ~770, where an
    # fp32 ulp is 6e-5, and the occupancies' exponent carries that rounding
    # (the plain version is 1.9e-5 from JAX there), so the card check's 1e-4
    jax_nll, jax_g = _jax_case(name)
    np.testing.assert_allclose(nll.numpy(), jax_nll, rtol=1e-6)
    atol = ATOL if lp.shape[1] < 100 else 1e-4
    np.testing.assert_allclose(grad.numpy(), jax_g, rtol=0, atol=atol)
    if name == "impossible alignment":
        assert nll[0] > 1e29 and np.all(grad[0].numpy() == 0)
    if name == "S=1025":
        assert nll[1] > 1e29 and np.all(grad[1].numpy() == 0) and nll[0] < 1e4
        assert torch.isfinite(alphas[-1, 1]).all() and (alphas[-1, 1] > K6.NEG_INF).sum() > 512


# (states a lane, lanes a CTA) of the cluster route's replay at each case:
# the card's lanes are 32 W; here few lanes, so that each row is cut into
# several slices (U=4: a slice of two states, so that state 2 tl starts one
# and its NLL takes state 2 tl - 1 from the last edge; S=1,025: eight
# slices of 128 and one of a single state)
CLUSTER_SLICES = {"U=4": (2, 1), "U=40": (4, 2), "U=300": (2, 32), "S=1025": (4, 32)}


def _k6_device_replay(lp, targets, ilen, tlen, K=2, lanes=3, blank=0):
    """K6's route past the shared-memory lattice, a cluster of CTAs a row
    (`csrc/ctc.cu` `alpha_chain` and `beta_grad` with Split, ``lattice``
    "cluster" in `ctc_plan`), in torch, row by row: P = ceil(S / n) CTAs of
    n = ``lanes`` K states (on the card ``lanes`` = 32 W), lane L of CTA p
    holding states p n + L K .. p n + L K + K - 1. Each step runs every
    slice at once: a lane's s-1 and s-2 (backward: s+1 and s+2 of x = beta +
    emission) past its own come from its CTA's lattice of the last two
    steps, whose guard cells are -inf; lane 0 of CTA p > 0 takes them from
    slot (t - 1) % `EDGE_RING` of its edge ring, where CTA p - 1's top lane
    put its top two states of step t - 1 (backward: the top lane of CTA p <
    P - 1 from the bottom two x of CTA p + 1 at the same step). The NLL comes
    from the CTA holding state 2 tl, state 2 tl - 1 from its last edge where
    2 tl begins its slice. Emissions (and, backward, alphas) come in chunks
    of `chunk` steps (backward `beta_chunk`) loaded a chunk ahead. Each CTA
    sums the occupancies of its own slice's valid states, sorted by (class,
    s) and cut at every multiple of `SEG` sorted states and at each class
    into segments (here summed in order of s, on the card by shuffles in a
    fixed order), each class's segments in order, into its partial sums;
    the gradient is minus the partials added in rank order. Returns
    (alphas (T, B, S), nll (B,), the gradient of sum(nll) (B, T, C))."""
    B, T, C = lp.shape
    U = targets.shape[1]
    S = 2 * U + 1
    n = lanes * K
    P = -(-S // n)
    R = K6.EDGE_RING
    NEG = torch.tensor(K6.NEG_INF)
    s = torch.arange(P * n).view(P, lanes, K)        # (CTA, lane, j) -> state
    first = 2 + torch.arange(lanes) * K              # a lane's first state in its lattice row
    zf = torch.full((B, P * n + 2), blank, dtype=torch.long)
    zf[:, 1:2 * U:2] = targets.long()
    alphas = torch.full((T, B, S), float("nan"))
    nll = torch.empty(B)
    grad = torch.zeros((B, T, C))
    for b in range(B):
        z = zf[b, :P * n].view(P, lanes, K)
        tl = int(tlen[b])
        valid = s < 2 * tl + 1
        skip = (s % 2 == 1) & (s >= 2) & (s < S) & (z != zf[b, (s - 2).clamp(min=0)])
        skip_from = (s % 2 == 1) & (s + 2 < S) & (zf[b, (s + 2).clamp(max=P * n + 1)] != z)
        term = valid & ((s == 2 * tl) | ((s == 2 * tl - 1) & (tl > 0)))
        lpb = lp[b]

        def chunks(rows, CH):   # a thread's chunks of CH steps: rows(step) of its states
            k = 0
            while True:
                yield torch.stack([rows(i) for i in range(k * CH, k * CH + CH)])
                k += 1

        # forward: each CTA's lattice (2, 2 + n), two -inf guards below its
        # slice; CTA p's edge ring (R, 2) holds CTA p - 1's top two states
        Tc = max(1, min(int(ilen[b]), T))
        lat = torch.full((P, 2, 2 + n), K6.NEG_INF)
        ring = torch.full((P, R, 2), float("nan"))
        CH = min(K6.CHUNK, 16 // K)
        emit = chunks(lambda t: lpb[min(t, Tc - 1)][z], CH)
        cur = next(emit)
        out = torch.empty((T, P, lanes, K))
        for t in range(Tc):
            i = t % CH
            if t and i == 0:
                cur = next(emit)
            if t == 0:
                a = torch.where(valid & (s <= 1), cur[0], NEG)
            else:
                prev = lat[:, (t - 1) & 1]
                up1, up2 = prev[:, first - 1], prev[:, first - 2]      # (P, lanes)
                up1[1:, 0], up2[1:, 0] = ring[1:, (t - 1) % R, 1], ring[1:, (t - 1) % R, 0]
                a1 = torch.cat([up1[..., None], a[..., :K - 1]], -1)
                a2 = torch.cat([up2[..., None], up1[..., None], a[..., :K - 2]], -1)
                a2 = torch.where(skip, a2, NEG)
                a = torch.where(valid, K6._logaddexp3(a, a1, a2) + cur[i], NEG)
            lat[:, t & 1, 2:] = a.reshape(P, n)
            ring[1:, t % R] = a[:-1, -1, K - 2:]              # the top lane's top two, up
            out[t] = a
        out[Tc:] = a
        alphas[:, b] = out.reshape(T, P * n)[:, :S]
        p = 2 * tl // n                                    # the CTA that holds state 2 tl
        fin = lat[p, (Tc - 1) & 1, 2:]
        a_last = NEG if tl == 0 else fin[2 * tl - 1 - p * n] if 2 * tl > p * n \
            else ring[p, (Tc - 1) % R, 1]
        nll[b] = -K6._logaddexp(fin[2 * tl - p * n], a_last)

        # backward: the chain over steps t = Tc - 1 down to 0 (n_ = Tc - 1 -
        # t); each CTA's x in a lattice (2, n + 4), two -inf guards above its
        # slice; CTA p's edge ring holds CTA p + 1's bottom two x
        Tc = min(int(ilen[b]), T)
        if Tc <= 0 or not nll[b] < -K6.NEG_INF / 2:
            continue
        al = out.reshape(T, P, lanes, K)
        CH = K6.CHUNK // K
        emit_next = chunks(lambda m: lpb[min(max(Tc - 1 - m, 0) + 1, Tc - 1)][z], CH)
        alpha = chunks(lambda m: al[max(Tc - 1 - m, 0)], CH)
        e_cur, a_cur = next(emit_next), next(alpha)
        xlat = torch.full((P, 2, n + 4), K6.NEG_INF)
        ring = torch.full((P, R, 2), float("nan"))
        last = torch.arange(lanes) * K + K - 1             # a lane's last state in its row
        occ = torch.empty((Tc, P, lanes, K))
        for m in range(Tc):
            i = m % CH
            if m and i == 0:
                e_cur, a_cur = next(emit_next), next(alpha)
            if m == 0:
                beta = torch.where(term, 0.0, NEG)
            else:
                x = torch.where(valid, beta + e_cur[i], NEG)
                xlat[:, m & 1, :n] = x.reshape(P, n)
                ring[:-1, (m - 1) % R] = x[1:, 0, :2]          # lane 0's bottom two, down
                row = xlat[:, m & 1]
                dn1, dn2 = row[:, last + 1], row[:, last + 2]    # (P, lanes)
                dn1[:-1, -1], dn2[:-1, -1] = ring[:-1, (m - 1) % R, 0], ring[:-1, (m - 1) % R, 1]
                x1 = torch.cat([x[..., 1:], dn1[..., None]], -1)
                x2 = torch.cat([x[..., 2:], dn1[..., None], dn2[..., None]], -1)[..., :K]
                x2 = torch.where(skip_from, x2, NEG)
                beta = K6._logaddexp3(x, x1, x2)
            occ[m] = torch.where(valid, torch.exp(torch.clamp(a_cur[i] + beta + nll[b], max=0.0)),
                                 0.0)
        # each CTA's class sums over its slice, then the partials in rank order
        occ = occ.flip(0).reshape(Tc, P, n)                # by step t
        total = torch.zeros((Tc, C))
        for p in range(P):
            nv = min(max(2 * tl + 1 - p * n, 0), n)
            order = sorted(range(nv), key=lambda q: (int(zf[b, p * n + q]), q))
            partial = torch.zeros((Tc, C))
            r = 0
            while r < nv:
                c = int(zf[b, p * n + order[r]])
                acc = torch.zeros(Tc)
                while r < nv and int(zf[b, p * n + order[r]]) == c:
                    seg = torch.zeros(Tc)                  # a segment: up to SEG sorted states
                    while True:
                        seg = seg + occ[:, p, order[r]]
                        r += 1
                        if r == nv or r % K6.SEG == 0 or int(zf[b, p * n + order[r]]) != c:
                            break
                    acc = acc + seg
                partial[:, c] = acc
            total = total + partial
        grad[b, :Tc] = -total
    return alphas, nll, grad


@pytest.mark.parametrize("name", K6_CASES)
def test_k6_device_route_replay_matches_plain_and_jax(name, one_thread):
    """The decomposition past the shared-memory lattice (`_k6_device_replay`:
    the plan takes a cluster a row past 4,096 states, and its arithmetic
    does not depend on S, so the cases cut their rows into slices of a few
    lanes, `CLUSTER_SLICES`) gives the plain versions' alphas and NLL bit
    for bit and their gradient, and JAX's custom VJP's NLL and gradient, at
    every edge."""
    lp, targets, ilen, tlen = _k6_case(name)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    K, lanes = CLUSTER_SLICES.get(name, (2, 3))
    alphas, nll, grad = _k6_device_replay(t(lp), t(targets), t(ilen), t(tlen), K, lanes)
    want_a, want_nll = K6.ctc_alpha_plain(t(lp), t(targets), t(ilen), t(tlen))
    np.testing.assert_array_equal(alphas.numpy(), want_a.numpy())
    np.testing.assert_array_equal(nll.numpy(), want_nll.numpy())
    want_g = K6.ctc_beta_grad_plain(t(lp), t(targets), t(ilen), t(tlen), want_a, want_nll,
                                    torch.ones(lp.shape[0]))
    np.testing.assert_allclose(grad.numpy(), want_g.numpy(), rtol=0, atol=ATOL)
    jax_nll, jax_g = _jax_case(name)
    np.testing.assert_allclose(nll.numpy(), jax_nll, rtol=1e-6)
    atol = ATOL if lp.shape[1] < 100 else 1e-4
    np.testing.assert_allclose(grad.numpy(), jax_g, rtol=0, atol=atol)


# the cluster route's replay at 8 states a lane: every edge, and the widest
# case (the longer ones' arithmetic is the replays' above); (lanes a CTA)
# few, so that each row is cut into several slices (U=4: S=9 in two slices
# of 8; S=1,025 in five of 256)
K6_CASES_8 = ["U=4", "input lengths below T", "target length 0", "T=1", "repeated labels",
              "impossible alignment", "S=1025"]
CLUSTER_SLICES_8 = {"S=1025": 32}


@pytest.mark.parametrize("name", K6_CASES_8)
def test_k6_cluster_route_at_8_states_a_lane_replay_matches_plain_and_jax(name, one_thread):
    """The cluster route at 8 states a lane, which `ctc_plan` takes past
    ``max_cluster`` x 1,536 states (from S = 3,073 with ``max_cluster``
    lowered to 2), replayed at every edge (`_k6_device_replay`, whose
    arithmetic does not depend on S, with a few lanes a CTA so that small
    rows take several slices): the plain versions' alphas and NLL bit for
    bit and their gradient, and JAX's custom VJP's NLL and gradient."""
    plan = K6.ctc_plan(2, 700, 3073, max_cluster=2)
    assert (plan["lattice"], plan["states_per_lane"], plan["chain_warps"], plan["cluster"]) == (
        "cluster", 8, 7, 2)
    lp, targets, ilen, tlen = _k6_case(name)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    alphas, nll, grad = _k6_device_replay(t(lp), t(targets), t(ilen), t(tlen), 8,
                                          CLUSTER_SLICES_8.get(name, 1))
    want_a, want_nll = K6.ctc_alpha_plain(t(lp), t(targets), t(ilen), t(tlen))
    np.testing.assert_array_equal(alphas.numpy(), want_a.numpy())
    np.testing.assert_array_equal(nll.numpy(), want_nll.numpy())
    want_g = K6.ctc_beta_grad_plain(t(lp), t(targets), t(ilen), t(tlen), want_a, want_nll,
                                    torch.ones(lp.shape[0]))
    np.testing.assert_allclose(grad.numpy(), want_g.numpy(), rtol=0, atol=ATOL)
    jax_nll, jax_g = _jax_case(name)
    np.testing.assert_allclose(nll.numpy(), jax_nll, rtol=1e-6)
    atol = ATOL if lp.shape[1] < 100 else 1e-4
    np.testing.assert_allclose(grad.numpy(), jax_g, rtol=0, atol=atol)


# (states a lane, lanes a CTA, CTAs a cluster) of the chained route's replay
# at each case: on the card 32 W lanes and up to 16 CTAs; here few, so that
# each row takes several clusters (U=4: S=9 in three clusters of two slices
# of two states, state 2 tl beginning a cluster in a row of 4 labels, so
# its NLL takes state 2 tl - 1 from the link's last step; S=1,025: five
# clusters of two slices of 128, the last holding one state)
CHAIN_SLICES = {"U=20": (2, 3, 2), "U=40": (2, 4, 3), "U=300": (2, 32, 3), "S=1025": (2, 64, 2),
                "T=300": (2, 4, 2)}


def _slice_class_sums(occ, zs, C):
    """A CTA's class sums over its ``occ`` (steps, nv) of its valid states
    of classes ``zs`` (nv), as `beta_grad`'s class-sum warps add them: the
    states sorted by (class, s), each class's run cut at every multiple of
    `SEG` sorted states into segments (each summed in order of s here, by
    shuffles in a fixed order on the card), a run's segments in order.
    Returns (steps, C)."""
    out = torch.zeros((occ.shape[0], C))
    order = sorted(range(len(zs)), key=lambda r: (int(zs[r]), r))
    r = 0
    while r < len(order):
        c, acc = int(zs[order[r]]), torch.zeros(occ.shape[0])
        while r < len(order) and int(zs[order[r]]) == c:
            seg = torch.zeros(occ.shape[0])
            while True:
                seg = seg + occ[:, order[r]]
                r += 1
                if r == len(order) or r % K6.SEG == 0 or int(zs[order[r]]) != c:
                    break
            acc = acc + seg
        out[:, c] = acc
    return out


def _k6_chain_replay(lp, targets, ilen, tlen, K=2, lanes=3, P=2, blank=0):
    """K6's chained route (`csrc/ctc.cu` `alpha_chain` and `beta_grad` with
    Chain, ``lattice`` "chain" in `ctc_plan`) in torch: Q = ceil(S / (P n))
    clusters of P CTAs a row, n = ``lanes`` K states a CTA, run one at a time
    in the order of their tickets (`chain_ticket`: forward every row's
    cluster 0 first, backward the last first), each over all of its row's
    steps before the next starts, so that a cluster reads only what a lower
    ticket wrote. Within a cluster the edges go through its CTAs' rings as
    in `_k6_device_replay`; between clusters q and q + 1 of a row through a
    link (B, Q - 1, T, 2), NaN until written: forward CTA P - 1 of cluster q
    writes its top lane's top two alphas of each step, CTA 0 of cluster q + 1
    reads them as its s - 1 and s - 2 (and its NLL's state 2 tl - 1 where 2
    tl begins the cluster); backward CTA 0 of cluster q + 1 writes its
    bottom two x, CTA P - 1 of cluster q reads them. A cluster past the row's
    valid states (`chain_live`) writes -inf alphas and runs no backward. Each
    CTA's class sums go into partials (B, Q P, T, C); the row's last cluster
    to finish adds them in slice order. Returns (alphas (T, B, S), nll (B,),
    the gradient of sum(nll) (B, T, C), the order the clusters ran in)."""
    B, T, C = lp.shape
    U = targets.shape[1]
    S = 2 * U + 1
    n = lanes * K
    Q = -(-S // (P * n))
    plan = {"cluster": P, "slice_states": n}
    R = K6.EDGE_RING
    NEG = torch.tensor(K6.NEG_INF)
    s = torch.arange(Q * P * n).view(Q, P, lanes, K)  # (cluster, CTA, lane, j) -> state
    first = 2 + torch.arange(lanes) * K               # a lane's first state in its lattice row
    last = torch.arange(lanes) * K + K - 1             # its last
    zf = torch.full((B, Q * P * n + 2), blank, dtype=torch.long)
    zf[:, 1:2 * U:2] = targets.long()
    alphas = torch.full((T, B, S), float("nan"))
    nll = torch.full((B,), float("nan"))
    link = torch.full((B, max(Q - 1, 1), T, 2), float("nan"))
    ran = []
    for i in range(B * Q):                             # forward, in ticket order
        q, b = K6.chain_ticket(i, B, Q)
        tl, lo, hi = int(tlen[b]), q * P * n, min(S, (q + 1) * P * n)
        if q >= K6.chain_live(tl, plan):               # past the valid states
            alphas[:, b, lo:hi] = K6.NEG_INF
            continue
        ran.append(("fwd", q, b))
        sq = s[q]
        z = zf[b][sq]
        valid = sq < 2 * tl + 1
        skip = (sq % 2 == 1) & (sq >= 2) & (sq < S) & (z != zf[b][(sq - 2).clamp(min=0)])
        out_link = q + 1 < K6.chain_live(tl, plan)
        Tc = max(1, min(int(ilen[b]), T))
        lat = torch.full((P, 2, 2 + n), K6.NEG_INF)
        ring = torch.full((P, R, 2), float("nan"))
        out = torch.empty((T, P, lanes, K))
        for t in range(Tc):
            e = lp[b, t][z]
            if t == 0:
                a = torch.where(valid & (sq <= 1), e, NEG)
            else:
                prev = lat[:, (t - 1) & 1]
                up1, up2 = prev[:, first - 1], prev[:, first - 2]      # (P, lanes)
                up1[1:, 0], up2[1:, 0] = ring[1:, (t - 1) % R, 1], ring[1:, (t - 1) % R, 0]
                if q > 0:
                    up1[0, 0], up2[0, 0] = link[b, q - 1, t - 1, 1], link[b, q - 1, t - 1, 0]
                a1 = torch.cat([up1[..., None], a[..., :K - 1]], -1)
                a2 = torch.where(skip, torch.cat([up2[..., None], up1[..., None], a[..., :K - 2]], -1),
                                 NEG)
                a = torch.where(valid, K6._logaddexp3(a, a1, a2) + e, NEG)
            lat[:, t & 1, 2:] = a.reshape(P, n)
            ring[1:, t % R] = a[:-1, -1, K - 2:]
            if out_link:
                link[b, q, t] = a[-1, -1, K - 2:]
            out[t] = a
        out[Tc:] = a
        alphas[:, b, lo:hi] = out.reshape(T, P * n)[:, :hi - lo]
        p = 2 * tl // n - q * P                         # the CTA that holds state 2 tl
        if 0 <= p < P:
            s0 = (q * P + p) * n
            fin = lat[p, (Tc - 1) & 1, 2:]
            a_last = (NEG if tl == 0 else fin[2 * tl - 1 - s0] if 2 * tl > s0
                      else ring[p, (Tc - 1) % R, 1] if p > 0 else link[b, q - 1, Tc - 1, 1])
            nll[b] = -K6._logaddexp(fin[2 * tl - s0], a_last)

    grad = torch.zeros((B, T, C))
    partials = torch.full((B, Q * P, T, C), float("nan"))
    blink = torch.full((B, max(Q - 1, 1), T, 2), float("nan"))
    done = [0] * B
    for i in range(B * Q):                             # backward, in ticket order
        q, b = K6.chain_ticket(i, B, Q, backward=True)
        tl = int(tlen[b])
        live = K6.chain_live(tl, plan)
        Tc = min(int(ilen[b]), T)
        if q >= live or Tc <= 0 or not nll[b] < -K6.NEG_INF / 2:
            continue
        ran.append(("bwd", q, b))
        sq = s[q]
        z = zf[b][sq]
        valid = sq < 2 * tl + 1
        skip_from = (sq % 2 == 1) & (sq + 2 < S) & (zf[b][(sq + 2).clamp(max=Q * P * n + 1)] != z)
        term = valid & ((sq == 2 * tl) | ((sq == 2 * tl - 1) & (tl > 0)))
        row_a = torch.full((T, Q * P * n), K6.NEG_INF)
        row_a[:, :S] = alphas[:, b]
        al = row_a[:, sq]                              # (T, P, lanes, K)
        xlat = torch.full((P, 2, n + 4), K6.NEG_INF)
        ring = torch.full((P, R, 2), float("nan"))
        occ = torch.empty((Tc, P, lanes, K))
        for m in range(Tc):
            t = Tc - 1 - m
            if m == 0:
                beta = torch.where(term, 0.0, NEG)
            else:
                x = torch.where(valid, beta + lp[b, t + 1][z], NEG)
                xlat[:, m & 1, :n] = x.reshape(P, n)
                ring[:-1, (m - 1) % R] = x[1:, 0, :2]
                if q > 0:
                    blink[b, q - 1, m - 1] = x[0, 0, :2]
                row = xlat[:, m & 1]
                dn1, dn2 = row[:, last + 1], row[:, last + 2]            # (P, lanes)
                dn1[:-1, -1], dn2[:-1, -1] = ring[:-1, (m - 1) % R, 0], ring[:-1, (m - 1) % R, 1]
                if q + 1 < live:
                    dn1[-1, -1], dn2[-1, -1] = blink[b, q, m - 1, 0], blink[b, q, m - 1, 1]
                x1 = torch.cat([x[..., 1:], dn1[..., None]], -1)
                x2 = torch.cat([x[..., 2:], dn1[..., None], dn2[..., None]], -1)[..., :K]
                beta = K6._logaddexp3(x, x1, torch.where(skip_from, x2, NEG))
            occ[m] = torch.exp(torch.clamp(al[t] + beta + nll[b], max=0.0))
        occ = occ.flip(0).reshape(Tc, P, n)            # by step t
        for p in range(P):
            s0 = (q * P + p) * n
            nv = min(max(2 * tl + 1 - s0, 0), n)
            partials[b, q * P + p] = 0.0
            partials[b, q * P + p, :Tc] = _slice_class_sums(occ[:, p, :nv], zf[b, s0:s0 + nv], C)
        done[b] += 1
        if done[b] == live:                            # the row's last cluster: slice order
            total = torch.zeros((T, C))
            for j in range(live * P):
                total = total + partials[b, j]
            grad[b] = -total
    return alphas, nll, grad, ran


@pytest.mark.parametrize("name", K6_CASES)
def test_k6_chain_route_replay_matches_plain_and_jax(name, one_thread):
    """The chained route's decomposition (`_k6_chain_replay`; the plan
    takes it past a cluster's 49,152 states, and its arithmetic does not
    depend on S, so the cases cut their rows into clusters of a few CTAs of
    a few lanes, `CHAIN_SLICES`) gives the plain versions' alphas and NLL
    bit for bit and their gradient, and JAX's custom VJP's NLL and
    gradient, at every edge; no cluster reads a link its writer has not
    written (NaN until then), and no cluster past a row's valid states runs."""
    lp, targets, ilen, tlen = _k6_case(name)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    K, lanes, P = CHAIN_SLICES.get(name, (2, 1, 2))
    alphas, nll, grad, ran = _k6_chain_replay(t(lp), t(targets), t(ilen), t(tlen), K, lanes, P)
    want_a, want_nll = K6.ctc_alpha_plain(t(lp), t(targets), t(ilen), t(tlen))
    np.testing.assert_array_equal(alphas.numpy(), want_a.numpy())
    np.testing.assert_array_equal(nll.numpy(), want_nll.numpy())
    want_g = K6.ctc_beta_grad_plain(t(lp), t(targets), t(ilen), t(tlen), want_a, want_nll,
                                    torch.ones(lp.shape[0]))
    np.testing.assert_allclose(grad.numpy(), want_g.numpy(), rtol=0, atol=ATOL)
    jax_nll, jax_g = _jax_case(name)
    np.testing.assert_allclose(nll.numpy(), jax_nll, rtol=1e-6)
    atol = ATOL if lp.shape[1] < 100 else 1e-4
    np.testing.assert_allclose(grad.numpy(), jax_g, rtol=0, atol=atol)
    plan = {"cluster": P, "slice_states": lanes * K}
    S = 2 * targets.shape[1] + 1
    assert -(-S // (P * lanes * K)) >= 2                # every case takes several clusters
    for kind, q, b in ran:
        assert q < K6.chain_live(int(tlen[b]), plan)


# (S, B, max_cluster, (K, W, P, Q) of the plan)
CHAIN_PLANS = [
    (49153, 2, 16, (2, 12, 13, 5)), (49153, 16, 8, (2, 11, 8, 9)),
    (98305, 16, 16, (2, 12, 15, 9)), (98305, 2, 8, (2, 12, 8, 17)),
    (6145, 3, 2, (2, 10, 2, 5)), (200001, 4, 16, (2, 12, 16, 17))]


@pytest.mark.parametrize("S,B,max_cluster,want", CHAIN_PLANS)
def test_ctc_chain_plan(S, B, max_cluster, want):
    """Past a cluster's states the plan chains clusters at `CHAIN_K` = 2
    states a lane (the fastest in chip_ablate.py's sweep, or within 18% of
    it): the fewest slices of at most 12 warps that hold S, in the fewest Q
    clusters of at most ``max_cluster`` CTAs, P = ceil(slices / Q) CTAs a
    cluster, the fewest warps W that hold S; every cluster holds states; a
    link warp beside the chain's; the scratch's sizes (the ticket counter,
    the rows' counts and the links' flags zeroed a call: 1 + B Q words). The
    tickets run every row's first cluster first forward (each cluster after
    its row's cluster below) and the last first backward, and a row's
    clusters past its valid states are skipped."""
    plan = K6.ctc_plan(B, 700, S, max_cluster)
    K, W, P, Q = plan["states_per_lane"], plan["chain_warps"], plan["cluster"], plan["clusters"]
    assert (plan["lattice"], K, W, P, Q) == ("chain",) + want
    n = 32 * K * W
    assert plan["slice_states"] == n and Q * P * n >= S > (Q - 1) * P * n
    assert 2 <= P <= max_cluster and plan["non_portable"] == (P > K6.PORTABLE_CLUSTER)
    assert plan["grid"] == (B * Q * P,) and plan["alpha_threads"] == 32 * (W + 1)
    assert plan["beta_threads"] == 32 * (W + K6.CONSUMER_WARPS + 1) <= 672
    assert plan["link_floats"] == 2 * B * (Q - 1) and plan["partial_floats"] == B * Q * P
    assert plan["sync_ints"] == 1 + B * Q
    assert max(plan["alpha_smem_bytes"], plan["beta_smem_bytes"]) <= 232_448
    assert plan["beta_smem_bytes"] == (K6._beta_smem(K, W) + 4 * K6._ring_floats(W) + K6.EDGE_BYTES
                                       + K6.LINK_BYTES)
    fwd = [K6.chain_ticket(i, B, Q) for i in range(B * Q)]
    bwd = [K6.chain_ticket(i, B, Q, backward=True) for i in range(B * Q)]
    assert sorted(fwd) == sorted(bwd) == [(q, b) for q in range(Q) for b in range(B)]
    for order, below in ((fwd, -1), (bwd, 1)):
        for i, (q, b) in enumerate(order):
            if 0 <= q + below < Q:
                assert order.index((q + below, b)) < i
    assert K6.chain_live(0, plan) == 1 and K6.chain_live((S - 1) // 2, plan) == Q
    assert K6.chain_live((P * n - 1) // 2, plan) == 1 and K6.chain_live(P * n // 2, plan) == 2
