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

@pytest.mark.parametrize("T", [1, 133, 680, 1000, 5000, 14_528, 14_529, 20_000])
@pytest.mark.parametrize("tokens", [False, True])
def test_trim_merge_plan_fits(T, tokens):
    """Every T plans within the card's shared memory at the flagship's C=43
    and D=64: the row route (a CTA a row) below `SPLIT_FRAMES` frames, the
    row's p_code (none with the tokens given), its three per-frame int
    arrays and its latent in shared memory; else the split route (the
    tokens over the card, the scans a CTA a row, the means over the card)."""
    plan = B6.trim_merge_plan(T, 43, 64, tokens=tokens)
    assert plan["threads"] == 1024
    row = T < B6.SPLIT_FRAMES == 133
    assert plan["route"] == ("row" if row else "split")
    if row:
        assert plan["stage_latent"] == (T <= 133 or (tokens and T <= 680))
        assert plan["smem_bytes"] == B6._trim_smem(T, 43, 64, not tokens, plan["stage_latent"])
        assert plan["smem_bytes"] <= 232_448
    else:
        assert plan["tok_lanes"] == (0 if tokens else 8)


def test_trim_merge_plan_limits():
    """The plan raises only for T < 1: the row route below 133 frames, the
    split route from there, and at any T where the row does not fit one
    CTA's shared memory (C=8,000 at T=20; C=20,000 at T=14,528: float4
    loads, 32 lanes a frame); a small limit forces the split route at any
    T."""
    assert B6.trim_merge_plan(132, 43, 64)["route"] == "row"
    assert B6.trim_merge_plan(133, 43, 64)["route"] == "split"
    assert B6.trim_merge_plan(20, 8000, 64)["route"] == "split"
    long = B6.trim_merge_plan(1_261, 43, 64)
    assert (long["route"], long["tok_vec"], long["tok_lanes"]) == ("split", 1, 8)
    assert (long["vec"], long["lanes"], long["rows"]) == (4, 16, 16)
    assert (long["scratch_ints"], long["token_ints"]) == (2_528, 1_261)
    wide = B6.trim_merge_plan(14_528, 20_000, 64)
    assert (wide["route"], wide["tok_vec"], wide["tok_lanes"]) == ("split", 4, 32)
    given = B6.trim_merge_plan(20_000, 1, 64, tokens=True)
    assert (given["route"], given["tok_lanes"], given["token_ints"]) == ("split", 0, 0)
    assert B6.trim_merge_plan(5, 43, 64, limit=1_024)["route"] == "split"
    assert B6.trim_merge_plan(5, 43, 64, aligned=False, limit=1_024)["vec"] == 1
    with pytest.raises(ValueError, match="T >= 1"):
        B6.trim_merge_plan(0, 43, 64)


@pytest.mark.parametrize("T,C", [(14_529, 43), (20_000, 43), (14_528, 8000), (20_000, 8000),
                                 (100_000, 43), (14_528, 7192), (1_261, 43), (680, 8000),
                                 (57_977, 44)])
def test_trim_merge_plan_takes_long_rows(T, C):
    """No T or C >= 1 raises; past one row's shared memory every plan is the
    split route: its scans a CTA of 1,024 threads a row; about
    `TOKEN_LOADS` loads a lane of the tokens kernel (float4 where C % 4 == 0, at most 32 lanes a frame); the means a
    group of 16 lanes of float4 an output row at D=64; the scratch of the
    slot starts and counts and of the tokens."""
    plan = B6.trim_merge_plan(T, C, 64)
    assert plan["route"] == "split" and B6._trim_smem(T, C, 64, True, False) > 232_448
    assert plan["threads"] == 1024
    assert plan["tok_vec"] == (4 if C % 4 == 0 else 1)
    loads = C // plan["tok_vec"]
    lanes = plan["tok_lanes"]
    assert lanes in (1, 2, 4, 8, 16, 32) and (lanes == 32 or lanes * B6.TOKEN_LOADS >= loads)
    assert lanes == 1 or (lanes // 2) * B6.TOKEN_LOADS < loads
    assert (plan["vec"], plan["lanes"], plan["rows"]) == (4, 16, 16)
    assert plan["scratch_ints"] == 2 * -(-T // 4) * 4 and plan["token_ints"] == T


def _group_argmax(p, lanes, vec):
    """The split route's tokens (`trim_merge_tokens_kernel`), a group of
    ``lanes`` lanes a frame: lane l keeps the first maximum (NaN the
    largest) of its loads of ``vec`` classes at l, l + lanes, ... in class
    order, then xor shuffles over lanes/2, ..., 1 keep the one first in the
    argmax's order (the larger, NaN the largest; the smaller class on a
    tie). p (T, C) -> tokens (T,)."""
    T, C = p.shape
    beats = lambda x, y: (np.isnan(x) & ~np.isnan(y)) | (x > y)
    vals, idx = np.zeros((lanes, T), np.float32), np.full((lanes, T), -1)
    for lane in range(lanes):
        for k in range(lane, C // vec, lanes):
            for c in range(k * vec, k * vec + vec):
                take = (idx[lane] < 0) | beats(p[:, c], vals[lane])
                vals[lane], idx[lane] = np.where(take, p[:, c], vals[lane]), np.where(take, c, idx[lane])
    o = lanes // 2
    while o:
        pv, pi = vals[np.arange(lanes) ^ o], idx[np.arange(lanes) ^ o]
        first = beats(vals, pv) | (~beats(pv, vals) & (idx < pi))
        take = (pi >= 0) & ((idx < 0) | ~first)
        vals, idx = np.where(take, pv, vals), np.where(take, pi, idx)
        o //= 2
    return idx[0]


def _b6_scan_replay(tok, max_f, threads):
    """`scan_row` in numpy, every thread of a chunk at once: one row's tokens
    (T,) a chunk of `threads` frames at a time, a thread a frame; a frame's
    run start the last change point at or before it in its warp (the
    kernel's ballot and __clz: an inclusive max over the lanes) or, where
    none, the warps' before it and the chunks' (carried); a segment starts
    where (t - run start) % (max_f + 1) == 0; its kept starts at or before
    it counted the same way (ballot and __popc: an inclusive sum); the
    segment's end walked from the frame. Returns (slot, count, slot
    starts, slot counts, kept)."""
    T = len(tok)
    m1 = max_f + 1
    nw = threads // 32
    tok = np.asarray(tok)
    slot = np.zeros(T, np.int32)
    count = np.zeros(T, np.float32)
    sstart, scnt = np.zeros(T, np.int64), np.zeros(T, np.int64)
    chg_all = np.ones(T, bool)
    chg_all[1:] = tok[1:] != tok[:-1]
    run_carry = kept_carry = 0
    for c0 in range(0, T, threads):
        t = c0 + np.arange(threads)
        inn = t < T
        tc = np.minimum(t, T - 1)
        tk = np.where(inn, tok[tc], 0)
        chg = (inn & chg_all[tc]).reshape(nw, 32)
        inc = np.maximum.accumulate(np.where(chg, t.reshape(nw, 32), -1), axis=1)
        wlast = inc[:, 31]
        earlier = np.array([max([run_carry] + list(wlast[:w])) for w in range(nw)])
        run = np.where(inc >= 0, inc, earlier[:, None]).reshape(threads)
        run_carry = max([run_carry] + list(wlast))
        pos = t - run
        ks = inn & (pos % m1 == 0) & (tk != 0)
        kinc = np.cumsum(ks.reshape(nw, 32), axis=1)
        wkept = kinc[:, 31]
        before = (kept_carry + np.concatenate([[0], np.cumsum(wkept)[:-1]])[:, None]
                  + kinc).reshape(threads)  # kept segments starting at or before t
        kept_carry += int(wkept.sum())
        s = t - pos % m1
        e = t + 1
        for _ in range(m1 - 1):  # segment_end: at most m1 - 1 steps
            e = e + (inn & (e < s + m1) & (e < T) & (tok[np.minimum(e, T - 1)] == tk))
        slot[t[inn]] = np.where(tk[inn] != 0, before[inn] - 1, -1)
        count[t[inn]] = (e - s)[inn]
        sstart[before[ks] - 1], scnt[before[ks] - 1] = t[ks], (e - s)[ks]
    return slot, count, list(sstart), list(scnt), kept_carry


def _b6_mean_replay(latent_row, sstart, scnt, kept, lanes=32, vec=2):
    """`mean_row` in numpy, every output row at once: lane l of a group of
    ``lanes`` takes ``vec`` channels at l*vec, (l + lanes)*vec, ... of row
    j: the kept segment's frames summed in time order from 0, divided by
    its count; zeros past the kept count."""
    T, D = latent_row.shape
    out = np.full((T, D), np.nan, np.float32)
    start, cnt = np.asarray(sstart[:kept]), np.asarray(scnt[:kept])
    for lane in range(lanes):
        for k in range(lane, D // vec, lanes):
            cols = slice(k * vec, (k + 1) * vec)
            v = np.zeros((kept, vec), np.float32)
            for d in range(int(cnt.max()) if kept else 0):
                on = d < cnt
                v[on] += latent_row[start[on] + d, cols]
            out[:kept, cols] = v / cnt[:, None].astype(np.float32)
            out[kept:, cols] = 0.0
    return out


def _b6_replay(tokens, latent, max_f, *, threads, lanes=32, vec=2):
    """`trim_merge_kernel` (the row route) or, with the means a group of
    ``lanes`` lanes of ``vec`` channels, `trim_merge_scan_kernel` and
    `trim_merge_means_kernel` (the split route) in numpy, from the rows'
    tokens (B, T): the scans (`_b6_scan_replay`), the means in time order
    (`_b6_mean_replay`). Returns (trimmed, lengths, slot, count)."""
    B, T, D = latent.shape
    out = np.zeros_like(latent)
    lengths = np.zeros(B, np.int32)
    slot = np.zeros((B, T), np.int32)
    count = np.zeros((B, T), np.float32)
    for b in range(B):
        slot[b], count[b], sstart, scnt, lengths[b] = _b6_scan_replay(tokens[b], max_f, threads)
        out[b] = _b6_mean_replay(latent[b], sstart, scnt, lengths[b], lanes,
                                 vec if D % vec == 0 else 1)
    return out, lengths, slot, count


def _b6_split_replay(p_code, latent, max_f, plan):
    """The split route's three launches at ``plan``: the tokens a group of
    the plan's lanes a frame (`_group_argmax`), the scans a CTA of its
    threads a row, the means a group of its lanes an output row."""
    tokens = np.stack([_group_argmax(row, plan["tok_lanes"], plan["tok_vec"]) for row in p_code])
    return _b6_replay(tokens, latent, max_f, threads=plan["threads"], lanes=plan["lanes"],
                      vec=plan["vec"])


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


def _check_replay(got, p, latent, max_f):
    """``got`` equals the plain version bit for bit (trimmed, lengths, slots,
    counts) and the JAX package's trimmed latents and lengths to 1e-6."""
    want = [x.numpy() for x in B6.trim_merge_plain(torch.from_numpy(p), torch.from_numpy(latent),
                                                    max_f)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    j_out, j_len, _ = j_trim_merge(jnp.asarray(p), jnp.asarray(latent), max_frames_per_phn=max_f)
    np.testing.assert_array_equal(got[1], np.asarray(j_len))
    np.testing.assert_allclose(got[0], np.asarray(j_out), rtol=0, atol=ATOL)


@pytest.mark.parametrize("max_f", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("case", sorted(EDGES))
def test_trim_merge_replay_matches_plain_and_jax(case, max_f):
    """The scans' carries replayed (2 warps a chunk of 64 frames, and the
    kernels' 1,024 threads; a thread a frame's argmax, the first maximum)
    equal the plain version bit for bit (trimmed, lengths, slots, counts)
    and the JAX package to 1e-6."""
    p, latent = EDGES[case]()
    for threads in (64, 1024):
        _check_replay(_b6_replay(p.argmax(-1), latent, max_f, threads=threads), p, latent, max_f)


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


def _long_rows(T, C=5, D=3, seed=0):
    """Two rows of T frames: runs of 1 to 9 frames of random tokens (the
    blank among them), and a seeded latent of D channels."""
    rng = np.random.RandomState(seed)
    p = np.full((2, T, C), 0.01, np.float32)
    for b in range(2):
        t = 0
        while t < T:
            n = rng.randint(1, 10)
            p[b, t:t + n, rng.randint(C)] = 1.0
            t += n
    return p, rng.randn(2, T, D).astype(np.float32)


@pytest.mark.parametrize("T", [14_529, 20_000])
def test_trim_merge_long_replay_matches_plain_and_jax(T):
    """Past 14,528 frames the split route (at C=5, D=3: a lane a frame's
    tokens, the scans at 1,024 threads, 4 lanes an output row) replayed
    equals the plain version bit for bit and JAX to 1e-6."""
    p, latent = _long_rows(T, seed=T)
    plan = B6.trim_merge_plan(T, 5, 3)
    assert (plan["route"], plan["tok_lanes"], plan["lanes"], plan["vec"]) == ("split", 1, 4, 1)
    _check_replay(_b6_split_replay(p, latent, 3, plan), p, latent, 3)


def _nan_ties(C=70):
    """Rows whose maximum lies in classes a lane apart (3 and 35, 67), tied
    exactly, with the blank, and NaN in places (the first NaN wins)."""
    rng = np.random.RandomState(4)
    p = rng.rand(2, 40, C).astype(np.float32)
    p[0, :10, [3, 35, 67]] = 2.0
    p[0, 10:20, [0, 64]] = 2.0
    p[1, :8, [40, 8]] = np.nan
    p[1, 8:16, [69, 37, 5]] = 3.0
    p[1, 16:20, 66] = np.nan
    return p, rng.randn(2, 40, 4).astype(np.float32)


def _nan_ties_43():
    """As `_nan_ties` at the flagship's 43 classes (8 lanes a frame): ties a
    lane apart (3, 11, 19) and a group apart (2, 42), with the blank, and
    NaN in places."""
    rng = np.random.RandomState(5)
    p = rng.rand(2, 40, 43).astype(np.float32)
    p[0, :10, [3, 11, 19]] = 2.0
    p[0, 10:20, [0, 42, 2]] = 2.0
    p[1, :8, [41, 9]] = np.nan
    p[1, 8:16, [42, 34, 7]] = 3.0
    p[1, 16:20, 40] = np.nan
    return p, rng.randn(2, 40, 4).astype(np.float32)


ARGMAX_CASES = {"nan_ties": _nan_ties, "nan_ties_43": _nan_ties_43,
                "nan_ties_72": lambda: _nan_ties(72), "ties": CASES["ties"],
                "long_runs": CASES["long_runs"]}


@pytest.mark.parametrize("case", sorted(ARGMAX_CASES))
def test_trim_merge_device_argmax_replay_matches_plain_and_jax(case):
    """The split route's tokens replayed lane by lane (`_group_argmax`, a
    group of the plan's lanes a frame: 8 at C=43, float4 loads at C=72)
    give the first maximum, NaN the largest, as the plain version and
    `jnp.argmax`; the whole split replay equals the plain version bit for
    bit and JAX to 1e-6."""
    p, latent = ARGMAX_CASES[case]()
    plan = B6.trim_merge_plan(p.shape[1], p.shape[2], latent.shape[2], limit=1_024)
    assert plan["route"] == "split" and plan["tok_vec"] == (4 if p.shape[2] % 4 == 0 else 1)
    tokens = np.stack([_group_argmax(row, plan["tok_lanes"], plan["tok_vec"]) for row in p])
    np.testing.assert_array_equal(tokens, torch.from_numpy(p).argmax(-1).numpy())
    np.testing.assert_array_equal(tokens, np.asarray(jnp.argmax(jnp.asarray(p), -1)))
    _check_replay(_b6_split_replay(p, latent, 3, plan), p, latent, 3)


SPLIT_CASES = {"blank_row": _blank_row, "ties": _ties, "long_runs": _long_runs,
               **{k: EDGES[k] for k in ("warp_edges", "chunk_edges", "all_blank", "T1")}}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_trim_merge_split_replay_matches_plain_and_jax(case):
    """The split route forced at a small T (a shared-memory limit the row
    does not fit): its three launches replayed (`_b6_split_replay`: the
    tokens a lane group a frame, the scans a CTA of 1,024 threads a row,
    the means a lane group an output row) equal the plain version bit for
    bit on blank rows, ties and long runs, and JAX to 1e-6."""
    p, latent = SPLIT_CASES[case]()
    plan = B6.trim_merge_plan(p.shape[1], p.shape[2], latent.shape[2], limit=600)
    assert plan["route"] == "split"
    _check_replay(_b6_split_replay(p, latent, 3, plan), p, latent, 3)
