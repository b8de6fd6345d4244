"""The kernels' cost arithmetic against hand counts, one shape a kernel:
FLOPs of the products against ``FlopCounterMode`` over the plain
computation the kernel replaces, bytes against counts written out here."""

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from port_bench import harness as H

C = H.cost_modules()
Z = torch.zeros


def flops(fn):
    with FlopCounterMode(display=False) as m:
        fn()
    return m.get_total_flops()


def test_every_wrapper_has_a_cost_and_a_pattern():
    assert set(C) >= {"bilstm_rec", "bilstm_rec_cs", "bilstm_rec_bwd", "bigru_rec", "bigru_rec_bwd",
                      "attention_step", "attention_step_bwd", "ctc_alpha", "ctc_beta_grad",
                      "stft_frames", "spec_db", "trim_merge", "trim_merge_bwd", "gl_project",
                      "gl_ola_frame"}
    for m in C.values():
        assert isinstance(m.KERNELS, str) and callable(m.cost)


def test_lstm_recurrence():
    T, B, Hd = 5, 3, 4
    w, x = Z(4 * Hd, Hd), Z(T, B, 4 * Hd)

    def plain():  # the recurrent product of both directions
        for _ in range(2 * T):
            Z(B, Hd) @ w.T

    f, b = C["bilstm_rec"].cost(dict(w_hh_f=w, w_hh_b=w, x_proj_f=x, x_proj_b=x))
    assert f == flops(plain) == 2 * T * B * 2 * 4 * Hd * Hd
    # W_hh 2 x 64, x_proj 2 x 240, hs 120 floats
    assert b == 4 * (128 + 480 + 120)
    f1, b1 = C["bilstm_rec"].cost(dict(w_hh_f=w, w_hh_b=None, x_proj_f=x, x_proj_b=None))
    assert (f1, b1) == (f // 2, 4 * (64 + 240 + 60))
    assert C["bilstm_rec_cs"].cost(dict(w_hh_f=w, w_hh_b=w, x_proj_f=x, x_proj_b=x)) == (f, b + 4 * 120)
    g = Z(T, B, 4 * Hd)
    fb, bb = C["bilstm_rec_bwd"].cost(dict(w_hh_f=w, w_hh_b=w, gates_f=g, gates_b=g))
    assert fb == f
    # W_hh 128, gates 480, their gradients 480, cs 120, g_hs 120
    assert bb == 4 * (128 + 480 + 480 + 120 + 120)


def test_gru_recurrence():
    T, B, Hd = 5, 3, 4
    w, bh, x = Z(3 * Hd, Hd), Z(3 * Hd), Z(T, B, 3 * Hd)

    def plain():
        for _ in range(2 * T):
            Z(B, Hd) @ w.T

    f, b = C["bigru_rec"].cost(dict(w_hh_f=w, w_hh_b=w, b_hh_f=bh, b_hh_b=bh, x_proj_f=x, x_proj_b=x))
    assert f == flops(plain)
    # W_hh and b_hh 2 x (48 + 12), x_proj 2 x 180, hs 120
    assert b == 4 * (120 + 360 + 120)
    z = Z(T, B, Hd)
    fb, bb = C["bigru_rec_bwd"].cost(dict(w_hh_f=w, w_hh_b=w, z_f=z, z_b=z))
    assert fb == f
    # W_hh 96; z 2 x 60, coefficients 2 x 180, outputs 2 x 60; g_hs 120
    assert bb == 4 * (96 + 600 + 120)


def test_attention_step():
    B, L, A, D, Fl, Cc, K = 2, 7, 8, 6, 4, 2, 5
    a = dict(pq=Z(B, A), processed_memory=Z(B, L, A), memory=Z(B, L, D), attn_hist=Z(B, Cc, L),
             loc_w=Z(Fl, Cc, K), loc_lin=Z(A, Fl), v=Z(A), mask=None)

    def plain():
        loc = F.conv1d(a["attn_hist"], a["loc_w"], padding=2)
        e = (torch.tanh(loc.transpose(1, 2) @ a["loc_lin"].T + a["processed_memory"])
             @ a["v"][:, None])[..., 0]
        torch.einsum("bl,bld->bd", torch.softmax(e, 1), a["memory"])

    f, b = C["attention_step"].cost(a)
    assert f == flops(plain)
    # pq 16, pm 112, memory 84, hist 28, loc_w 40, loc_lin 32, v 8, context 12, weights 14
    assert b == 4 * (16 + 112 + 84 + 28 + 40 + 32 + 8 + 12 + 14)
    fb, bb = C["attention_step_bwd"].cost(a)
    assert fb == 2 * B * L * (2 * D + A + 2 * Fl * A + 2 * Fl * Cc * K)
    ins = 16 + 112 + 84 + 28 + 40 + 32 + 8 + 14 + 12 + 12 + 14
    outs = 16 + 112 + 84 + 28 + 40 + 32 + 8
    assert bb == 4 * (ins + outs)


def test_memory_bound_kernels():
    B, T, Cc, U = 2, 9, 5, 3           # S = 7 states
    lp, tg = Z(B, T, Cc), Z(B, U)
    assert C["ctc_alpha"].cost(dict(log_probs=lp, targets=tg))[1] == 4 * (90 + 6 + 4 + 126 + 2)
    assert C["ctc_beta_grad"].cost(dict(log_probs=lp, targets=tg))[1] == 4 * (180 + 126 + 6 + 8)
    w = Z(2, 100)
    a = dict(waves=w, num_frames=6, support=(3, 10), noise=None)
    assert C["stft_frames"].cost(a)[1] == 4 * (200 + 120)
    assert C["stft_frames"].cost(dict(a, noise=w))[1] == 4 * (400 + 120)
    assert C["spec_db"].cost(dict(x=Z(2, 6, 10), reim=True, db=True))[1] == 4 * (120 + 60 + 60)
    assert C["spec_db"].cost(dict(x=Z(2, 6, 4), reim=False, db=True))[1] == 4 * (48 + 48)
    assert C["trim_merge"].cost(dict(p_code=Z(2, 6, 5), latent=Z(2, 6, 3)))[1] == \
        4 * (60 + 72 + 2 + 24)
    assert C["trim_merge_bwd"].cost(dict(d_out=Z(2, 6, 3)))[1] == 4 * (72 + 24)
    assert C["gl_project"].cost(dict(mag=Z(2, 6, 5)))[1] == 4 * (120 + 60 + 120) // 1
    fr = Z(2, 6, 10)
    assert C["gl_ola_frame"].cost(dict(frames=fr, hop=4, emit_signal=True))[1] == 4 * (120 + 40)
    assert C["gl_ola_frame"].cost(dict(frames=fr, hop=4, emit_signal=False))[1] == 4 * 240


def test_least_time_is_the_larger_bound():
    assert H.least_s(67e12, 0) == 1.0
    assert H.least_s(0, 3.35e12) == 1.0
    assert H.least_s(67e12, 6.7e12) == 2.0
