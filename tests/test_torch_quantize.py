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


# ---------------- B6 trim_merge: its launch plan and a replay of its scans ----------------

@pytest.mark.parametrize("T", [1, 133, 680, 1000, 5000, 14_528])
@pytest.mark.parametrize("tokens", [False, True])
def test_trim_merge_plan_fits(T, tokens):
    """Every T the kernel takes (up to `MAX_FRAMES`, as the first design's)
    plans within the card's shared memory at the flagship's C=43 and D=64:
    the row's p_code in one slot where it fits, else a ring of two."""
    plan = B6.trim_merge_plan(T, 43, 64, tokens=tokens)
    assert plan["smem_bytes"] <= 232_448 and plan["threads"] == 1024
    if tokens:
        assert plan["depth"] == 0
    elif plan["depth"] == 1:
        assert plan["chunk"] == T
    else:
        assert plan["depth"] == 2 and 1 <= plan["chunk"] < T
    assert plan["stage_latent"] == (T <= 133 or (tokens and T <= 680))


def test_trim_merge_plan_limits():
    assert B6.trim_merge_plan(133, 43, 64)["depth"] == 1
    assert B6.trim_merge_plan(14_528, 43, 64)["chunk"] == 167
    with pytest.raises(ValueError, match="1 to 14528"):
        B6.trim_merge_plan(14_529, 43, 64)
    with pytest.raises(ValueError, match="not one frame"):
        B6.trim_merge_plan(14_528, 20_000, 64)


def _b6_replay(p_code, latent, max_f, *, threads, chunk):
    """`trim_merge_kernel` in numpy: the argmax a chunk of `chunk` frames at a
    time; the scans a chunk of `threads` frames at a time, each warp's run
    starts and kept counts from its ballots, carried across warps and
    chunks; the segment ends by walking the tokens; the means in time
    order. Returns (trimmed, lengths, slot, count)."""
    B, T, D = latent.shape
    m1 = max_f + 1
    out = np.zeros_like(latent)
    lengths = np.zeros(B, np.int32)
    slot = np.zeros((B, T), np.int32)
    count = np.zeros((B, T), np.float32)
    for b in range(B):
        tok = np.zeros(T, np.int64)
        for f0 in range(0, T, chunk):
            tok[f0:f0 + chunk] = p_code[b, f0:f0 + chunk].argmax(-1)
        sstart, scnt = [0] * T, [0] * T
        run_carry = kept_carry = 0
        for c0 in range(0, T, threads):
            nw = threads // 32
            t = c0 + np.arange(threads)
            inn = t < T
            tk = np.where(inn, tok[np.minimum(t, T - 1)], 0)
            chg = inn & ((t == 0) | (tk != tok[np.maximum(np.minimum(t, T - 1) - 1, 0)]))
            chg = chg.reshape(nw, 32)
            wlast = [c0 + 32 * w + int(np.flatnonzero(chg[w])[-1]) if chg[w].any() else -1
                     for w in range(nw)]
            run = np.zeros(threads, np.int64)
            for w in range(nw):
                earlier = max([run_carry] + wlast[:w])
                for lane in range(32):
                    mine = np.flatnonzero(chg[w, :lane + 1])
                    run[32 * w + lane] = c0 + 32 * w + mine[-1] if len(mine) else earlier
            run_carry = max([run_carry] + wlast)
            pos = t - run
            ks = (inn & (pos % m1 == 0) & (tk != 0)).reshape(nw, 32)
            wkept = ks.sum(1)
            for w in range(nw):
                for lane in range(32):
                    i = 32 * w + lane
                    if not inn[i]:
                        continue
                    before = kept_carry + int(wkept[:w].sum()) + int(ks[w, :lane + 1].sum())
                    s = t[i] - pos[i] % m1
                    e = t[i] + 1
                    while e < s + m1 and e < T and tok[e] == tk[i]:
                        e += 1
                    slot[b, t[i]] = before - 1 if tk[i] != 0 else -1
                    count[b, t[i]] = e - s
                    if ks[w, lane]:
                        sstart[before - 1], scnt[before - 1] = t[i], e - s
            kept_carry += int(wkept.sum())
        lengths[b] = kept_carry
        for j in range(kept_carry):
            v = np.zeros(D, np.float32)
            for t_ in range(sstart[j], sstart[j] + scnt[j]):
                v += latent[b, t_]
            out[b, j] = v / np.float32(scnt[j])
    return out, lengths, slot, count


def _one_hot_runs(runs, C=6, D=5, seed=0):
    """p_code of rows of (token, frames) runs, and a seeded latent."""
    T = sum(n for _, n in runs[0])
    p = np.full((len(runs), T, C), 0.01, np.float32)
    for b, row in enumerate(runs):
        t = 0
        for tok, n in row:
            p[b, t:t + n, tok] = 1.0
            t += n
    return p, np.random.RandomState(seed).randn(len(runs), T, D).astype(np.float32)


# runs that cross the warp edges at frames 31, 32 and 33 and the chunk edge
# at 64 (the replay's chunk of 64 frames), some longer than max_frames_per_phn
EDGES = {
    "warp_edges": lambda: _one_hot_runs([[(2, 31), (3, 1), (3, 1), (4, 33), (1, 30)],
                                         [(0, 30), (5, 4), (0, 28), (2, 34)],
                                         [(1, 32), (1, 32), (0, 1), (3, 31)]]),
    "chunk_edges": lambda: _one_hot_runs([[(4, 60), (2, 9), (0, 3), (3, 24)],
                                          [(1, 63), (1, 1), (2, 2), (0, 30)],
                                          [(2, 64), (0, 1), (5, 31)]], seed=1),
    "all_blank": lambda: _one_hot_runs([[(0, 70)], [(0, 69), (3, 1)]], seed=2),
    "T1": lambda: _case(9, T=1),
    "T680": lambda: _case(11, B=2, T=680),
}


@pytest.mark.parametrize("max_f", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("case", sorted(EDGES))
def test_trim_merge_replay_matches_plain_and_jax(case, max_f):
    """The kernel's carries replayed (2 warps a chunk of 64 frames, and the
    kernel's 1,024 threads) equal the plain version bit for bit (trimmed,
    lengths, slots, counts) and the JAX package to 1e-6."""
    p, latent = EDGES[case]()
    want = [x.numpy() for x in B6.trim_merge_plain(torch.from_numpy(p), torch.from_numpy(latent),
                                                    max_f)]
    for threads, chunk in ((64, 64), (1024, 167)):
        got = _b6_replay(p, latent, max_f, threads=threads, chunk=chunk)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    j_out, j_len, _ = j_trim_merge(jnp.asarray(p), jnp.asarray(latent), max_frames_per_phn=max_f)
    np.testing.assert_array_equal(got[1], np.asarray(j_len))
    np.testing.assert_allclose(got[0], np.asarray(j_out), rtol=0, atol=ATOL)


# ---------------- B6 trim_merge_bwd: its launch plan and a replay of its gather ----------------

@pytest.mark.parametrize("D,aligned,vec,lanes", [(64, True, 4, 16), (64, False, 1, 32),
                                                 (12, True, 4, 4), (3, True, 1, 4),
                                                 (256, True, 4, 32), (1, True, 1, 1)])
def test_trim_merge_bwd_plan(D, aligned, vec, lanes):
    """float4 loads only where D % 4 == 0 and the rows are aligned; the
    lanes a frame cover its loads (a power of two, at most 32); a CTA of
    256 threads; a grid of (frame groups, B): two frames a warp at D=64."""
    plan = B6.trim_merge_bwd_plan(8, 133, D, aligned)
    assert (plan["vec"], plan["lanes"]) == (vec, lanes)
    assert plan["frames"] * plan["lanes"] == plan["threads"] == 256
    assert plan["grid"] == (-(-133 // plan["frames"]), 8)


def _b6_bwd_replay(d_out, slot, count, plan):
    """`trim_merge_bwd_kernel` in numpy: a CTA a group of ``frames`` frames
    of one batch row, a group of ``lanes`` lanes a frame whose first lane
    reads the slot and count, ``vec`` floats a load at lane-strided
    offsets, each element divided by the count."""
    B, T, D = d_out.shape
    out = np.full((B, T, D), np.nan, np.float32)
    gx, gy = plan["grid"]
    for b in range(gy):
        for cta in range(gx):
            for f in range(plan["frames"]):
                t = cta * plan["frames"] + f
                if t >= T:
                    continue
                s, c = slot[b, t], count[b, t]   # the group's first lane, by shuffle
                for lane in range(plan["lanes"]):
                    for k in range(lane, D // plan["vec"], plan["lanes"]):
                        cols = slice(k * plan["vec"], (k + 1) * plan["vec"])
                        out[b, t, cols] = (d_out[b, s, cols] / c if s >= 0
                                           else np.float32(0.0))
    return out


@pytest.mark.parametrize("B,T,D,aligned", [(8, 133, 64, True), (1, 40, 64, False),
                                           (3, 50, 12, True), (2, 17, 3, True)])
def test_trim_merge_bwd_replay_matches_plain(B, T, D, aligned):
    """The replayed gather writes every element once and equals the plain
    version bit for bit, on slots and counts of the forward on long runs
    (some frames dropped, segments of 1 to 4 frames)."""
    rng = np.random.RandomState(B * T + D)
    p = np.full((B, T, 5), 0.01, np.float32)
    p[np.arange(B)[:, None], np.arange(T)[None, :], (np.arange(T)[None, :] // 5
                                                      + np.arange(B)[:, None]) % 5] = 1.0
    latent = rng.randn(B, T, D).astype(np.float32)
    _, _, slot, count = B6.trim_merge_plain(torch.from_numpy(p), torch.from_numpy(latent), 3)
    assert (slot < 0).any() and (slot >= 0).any()
    d_out = rng.randn(B, T, D).astype(np.float32)
    want = B6.trim_merge_bwd_plain(torch.from_numpy(d_out), slot, count).numpy()
    got = _b6_bwd_replay(d_out, slot.numpy(), count.numpy(), B6.trim_merge_bwd_plan(B, T, D, aligned))
    np.testing.assert_array_equal(got, want)
