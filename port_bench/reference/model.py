"""The plain reference model: the VQVAE of semi-supervised multi-speaker
TTS (a CTC phoneme ASR with a conv stack and a BiLSTM, a codebook shared
with the text side, a Tacotron-2 TTS with a location-sensitive attention
decoder, speaker adaIN and a CBHG mel-to-linear postnet), its serving path
(text -> waveform through Griffin-Lim) and its two train steps (the paired
step and the speech-first cycle) with the Adam update, in plain PyTorch.

Weights are a dict of tensors by the program's parameter names; the
benchmark makes them from the seed and hands the same dict to both sides.
Random draws (dropout masks, the prenet's masks, which stay on at
inference, the augmentation, the scheduled-sampling coins and the
Griffin-Lim phases) come from a ``torch.Generator`` seeded as the program
seeds its own, in the order the model's equations use them.

``count_only``: the model runs on the ``meta`` device for a FLOP count;
the two steps with no product in them whose outputs depend on values
(the CTC lattice, trim/merge's segments) are then replaced by stand-ins of
the same shapes."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import audio as A

EPS = 1e-10
FRAME_PHN_RATIO = 6.0
GRAD_CLIP, B1, B2, ADAM_EPS = 5.0, 0.9, 0.999, 1e-8


class Model:
    """The sizes of one configuration file (its ``model`` block and the
    vocabulary, speakers and attribute table beside it)."""

    def __init__(self, conf: dict):
        m = conf["model"]
        self.audio = A.Audio(conf["audio"])
        self.enc = m["encoder"]
        self.cb = m["codebook"]
        self.dec = m["decoder"]["decoder"]
        self.tenc = m["decoder"]["encoder"]
        self.separate_postnet = bool(m["decoder"].get("separate_postnet", False))
        self.r = int(self.dec["n_frames_per_step"])
        self.n_mels = self.audio.n_mels
        self.trf = 2 ** sum(1 for s in self.enc["stride"] if s != 1)
        self.max_frames_per_phn = int(m["max_frames_per_phn"])
        self.vocab = int(conf["vocab_size"])
        self.phn_attr = conf["phn_attr"]


class Net:
    """Weights ``P``, BatchNorm running statistics ``S`` and a generator."""

    def __init__(self, model: Model, P: dict, S: dict, phn_attr, g, count_only=False):
        self.m, self.P, self.S, self.phn_attr, self.g = model, P, S, phn_attr, g
        self.count_only = count_only

    # ---- blocks ----
    def lin(self, name, x, bias=True):
        y = x @ self.P[name + ".w"].T
        b = self.P.get(name + ".b") if bias else None
        return y if b is None else y + b

    def conv(self, name, x, stride=1, padding=None, bias=True):
        w = self.P[name + ".w"]
        k = w.shape[2]
        b = self.P.get(name + ".b") if bias else None
        pad = (k - 1) // 2 if padding is None else padding
        return F.conv1d(x.transpose(1, 2), w, b, stride=stride, padding=pad).transpose(1, 2)

    def bn(self, name, x, train, eps):
        if train:
            mean, var = x.mean((0, 1)), x.var((0, 1), unbiased=False)
        else:
            mean, var = self.S[name + ".mean"], self.S[name + ".var"]
        return (x - mean) * torch.rsqrt(var + eps) * self.P[name + ".scale"] + self.P[name + ".bias"]

    def drop(self, x, rate, on=True):
        if not on or rate <= 0.0:
            return x
        u = torch.rand(x.shape, generator=self.g, device=x.device)
        return torch.where(u < 1.0 - rate, x / (1.0 - rate), torch.zeros_like(x))

    def lstm(self, name, x, reverse):
        P = self.P
        w_hh = P[name + ".w_hh"]
        H = w_hh.shape[1]
        xp = x @ P[name + ".w_ih"].T + (P[name + ".b_ih"] + P[name + ".b_hh"])
        h = c = x.new_zeros((x.shape[0], H))
        out = [None] * x.shape[1]
        for t in (range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])):
            i, f, gg, o = (xp[:, t] + h @ w_hh.T).split(H, -1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            out[t] = h
        return torch.stack(out, 1)

    def bilstm_stack(self, name, x, layers, rate=0.0, train=False):
        for li in range(layers):
            x = torch.cat([self.lstm(f"{name}.{li}.fwd", x, False),
                           self.lstm(f"{name}.{li}.bwd", x, True)], -1)
            if li < layers - 1:
                x = self.drop(x, rate, train)
        return x

    def gru(self, name, x, reverse):
        P = self.P
        w_hh, b_hh = P[name + ".w_hh"], P[name + ".b_hh"]
        H = w_hh.shape[1]
        xr, xz, xn = (x @ P[name + ".w_ih"].T + P[name + ".b_ih"]).split(H, -1)
        h = x.new_zeros((x.shape[0], H))
        out = [None] * x.shape[1]
        for t in (range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])):
            hr, hz, hn = (h @ w_hh.T + b_hh).split(H, -1)
            r = torch.sigmoid(xr[:, t] + hr)
            z = torch.sigmoid(xz[:, t] + hz)
            n = torch.tanh(xn[:, t] + r * hn)
            h = (1.0 - z) * n + z * h
            out[t] = h
        return torch.stack(out, 1)

    def prenet(self, x):
        for i in range(2):
            x = self.drop(F.relu(self.lin(f"tts.decoder.prenet.{i}", x, bias=False)),
                          float(self.m.dec["prenet_dropout"]))
        return x

    # ---- ASR and codebook ----
    def asr(self, x, train):
        e = self.m.enc
        act = getattr(torch, e["activation"].lower())
        for i, k in enumerate(e["kernel"]):
            y = self.conv(f"asr.convs.{i}", x, stride=e["stride"][i], padding=1 if k != 1 else 0)
            if e["batch_norm"]:
                y = self.bn(f"asr.bn.{i}", y, train, 1e-5)
            y = act(y)
            if e["residual"][i]:
                y = y + x
            x = self.drop(y, e["dropout"], train)
        x = self.bilstm_stack("asr.rnn", x, e["rnn_layers"], e["dropout"], train)
        x = self.drop(x, e["dropout"], train)
        return self.lin("asr.postnet", x)

    def _attr(self, idx=None):
        a = self.phn_attr if idx is None else self.phn_attr[idx]
        return self.lin("codebook.proj_attr", a)

    def embed_text(self, txt):
        table = self.P["codebook.learnable_table" if self.m.cb["bone"] == "l2" else "codebook.embedding"]
        return torch.cat([table[txt], self._attr(txt)], -1)

    def quantize(self, enc):
        """-> (p_code, latent)."""
        if self.m.cb["bone"] == "seperate":
            p_code = torch.softmax(self.lin("codebook.asr_final", enc), -1)
            picked = p_code.argmax(-1)
            return p_code, torch.cat([self.P["codebook.embedding"][picked], self._attr(picked)], -1)
        table = torch.cat([self.P["codebook.learnable_table"], self._attr()], -1)
        sim = -((enc ** 2).sum(-1, keepdim=True) + (table ** 2).sum(-1) - 2.0 * enc @ table.T)
        p_code = torch.softmax(float(self.m.cb["temp"]) * sim, -1)
        return p_code, enc + table[p_code.argmax(-1)] - enc.detach()

    # ---- TTS ----
    def tts_encoder(self, x, train):
        for i in range(int(self.m.tenc["enc_n_conv"])):
            x = F.relu(self.bn(f"tts.encoder.bn.{i}", self.conv(f"tts.encoder.convs.{i}", x), train, 1e-5))
            x = self.drop(x, float(self.m.tenc["enc_dropout"]), train)
        return self.bilstm_stack("tts.encoder.lstm", x, int(self.m.tenc["enc_rnn_layer"]))

    def attention(self, q, mem, pm, hist):
        P = self.P
        pq = q @ P["tts.decoder.attn.query_layer.w"].T
        loc_w = P["tts.decoder.attn.loc_conv.w"]
        loc = F.conv1d(hist, loc_w, padding=(loc_w.shape[2] - 1) // 2)
        e_in = pq[:, None, :] + loc.transpose(1, 2) @ P["tts.decoder.attn.loc_linear.w"].T
        energy = (torch.tanh(e_in + pm) @ P["tts.decoder.attn.v.w"].T)[..., 0]
        w = torch.softmax(energy, 1)
        return torch.einsum("bl,bld->bd", w, mem), w

    def cell(self, name, x, h, c):
        P = self.P
        H = h.shape[1]
        gates = x @ P[name + ".w_ih"].T + P[name + ".b_ih"] + h @ P[name + ".w_hh"].T + P[name + ".b_hh"]
        i, f, gg, o = gates.split(H, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        return torch.sigmoid(o) * torch.tanh(c), c

    def decoder(self, mem, spkr, steps, train=False, teacher=None, tf_rate=1.0):
        d, r, M = self.m.dec, self.m.r, self.m.n_mels
        B, L, _ = mem.shape
        pm = self.lin("tts.decoder.attn.memory_layer", mem, bias=False)
        ada_mean = self.lin("tts.decoder.pseudo_mean", spkr)
        ada_std = F.relu(self.lin("tts.decoder.pseudo_std", spkr))
        z = mem.new_zeros
        if teacher is not None:
            Tt = teacher.shape[1] // r
            t_pre = self.prenet(teacher.reshape(B, Tt, r * M))
            t_mean = t_pre.mean(1)
            coins = torch.rand((steps, 2), generator=self.g, device=mem.device)
        dec_in = self.prenet(z((B, r * M)))
        Hq, Hd = int(d["query_rnn_dim"]), int(d["dec_rnn_dim"])
        qh, qc, dh, dc = z((B, Hq)), z((B, Hq)), z((B, Hd)), z((B, Hd))
        w, w_sum, ctx = z((B, L)), z((B, L)), z((B, mem.shape[2]))
        mels, aligns = [], []
        for t in range(steps):
            qh, qc = self.cell("tts.decoder.query_rnn", torch.cat([dec_in, ctx], -1), qh, qc)
            qh = self.drop(qh, float(d["query_dropout"]), train)
            ctx, w = self.attention(qh, mem, pm, torch.stack([w, w_sum], 1))
            w_sum = w_sum + w
            dh, dc = self.cell("tts.decoder.dec_rnn", torch.cat([ctx, ada_std * (qh - ada_mean)], -1), dh, dc)
            dh = self.drop(dh, float(d["dec_dropout"]), train)
            out = self.lin("tts.decoder.proj", torch.cat([dh, ctx], -1))
            mels.append(out)
            aligns.append(w)
            own = self.prenet(out)
            if teacher is None:
                dec_in = own
            else:
                teach = torch.where(coins[t, 1] < float(d["drop_dec_in"]), t_mean, t_pre[:, min(t, Tt - 1)])
                dec_in = torch.where(coins[t, 0] > tf_rate, own, teach)
        return torch.stack(mels, 1).reshape(B, steps * r, M), torch.stack(aligns, 1)

    def cbhg(self, x, train):
        T = x.shape[1]
        pre = "tts.postnet.cbhg"
        outs = []
        for i in range(8):
            y = F.relu(self.conv(f"{pre}.banks.{i}.conv", x, padding=(i + 1) // 2, bias=False))
            outs.append(self.bn(f"{pre}.banks.{i}.bn", y, train, 1e-3)[:, :T])
        h = F.pad(torch.cat(outs, -1), (0, 0, 1, 1), value=float("-inf"))
        h = torch.maximum(h[:, :-1], h[:, 1:])[:, :T]
        for i, act in enumerate((True, False)):
            y = self.conv(f"{pre}.projs.{i}.conv", h, padding=1, bias=False)
            h = self.bn(f"{pre}.projs.{i}.bn", F.relu(y) if act else y, train, 1e-3)
        h = self.lin(f"{pre}.pre_highway", h, bias=False) + x
        for i in range(4):
            t = torch.sigmoid(self.lin(f"{pre}.highways.{i}.T", h))
            h = F.relu(self.lin(f"{pre}.highways.{i}.H", h)) * t + h * (1.0 - t)
        return torch.cat([self.gru(f"{pre}.gru.fwd", h, False), self.gru(f"{pre}.gru.bwd", h, True)], -1)

    def tts(self, lat, sid, steps, train=False, teacher=None):
        mem = self.tts_encoder(lat, train)
        mel, align = self.decoder(mem, self.P["spkr_embed"][sid], steps, train, teacher)
        post_in = mel.detach() if self.m.separate_postnet else mel
        return mel, self.lin("tts.postnet.linear", self.cbhg(post_in, train)), align

    # ---- serving ----
    def synthesize(self, text, sid, steps):
        """Text ids (B, U), speakers (B,) -> linear amplitude (B, T, F)."""
        _, lin, _ = self.tts(self.embed_text(text), sid, steps)
        return A.linear_to_amp(lin)

    def vocode(self, amp):
        """Linear amplitude -> waveform (B, S) on the host: Griffin-Lim,
        the inverse pre-emphasis, then a clip to [-1, 1]."""
        a = self.m.audio
        phases = A.random_phases(amp.shape, self.g, amp.device)
        x = A.griffin_lim(amp, phases, a.n_fft, a.hop, a.win)
        if self.count_only:
            return x
        return torch.clamp(A.inv_preemphasis(x, a.coeff), -1.0, 1.0)

    # ---- training ----
    def ctc(self, probs, text):
        lp = torch.log(probs + EPS)
        tl = (text != 0).sum(-1)
        if self.count_only:
            return lp.mean()
        il = torch.full((lp.shape[0],), lp.shape[1], dtype=torch.long, device=lp.device)
        nll = F.ctc_loss(lp.transpose(0, 1), text.long(), il, tl, blank=0, reduction="none")
        return (nll / tl.clamp(min=1).to(nll.dtype)).mean()

    def trim_merge(self, p_code, latent):
        """The mean latent of each non-blank segment of each row (a segment
        ends where the argmax changes or its run passes max_frames_per_phn
        frames), compacted left -> (trimmed, lengths)."""
        B, T, D = latent.shape
        if self.count_only:
            return latent, torch.full((B,), T, device=latent.device)
        tok = p_code.argmax(-1).tolist()
        out = latent.new_zeros((B, T, D))
        lengths = []
        mf = self.m.max_frames_per_phn
        for b in range(B):  # row by row, segment by segment
            starts, run = [], 0
            for t in range(T):
                run = 1 if t == 0 or tok[b][t] != tok[b][t - 1] else run + 1
                if (run - 1) % (mf + 1) == 0:
                    starts.append(t)
            rows = []
            for s, e in zip(starts, starts[1:] + [T]):
                if tok[b][s] != 0:
                    rows.append(latent[b, s:e].mean(0))
            lengths.append(len(rows))
            if rows:
                out[b, :len(rows)] = torch.stack(rows)
        return out, torch.tensor(lengths, device=latent.device)

    def _pad_frames(self, x):
        return F.pad(x, (0, 0, 0, self.m.r - x.shape[1] % self.m.r))

    def _features(self, waves, lengths):
        a = self.m.audio
        mel, lin, _ = A.featurize(a, waves, lengths)
        draws = A.augment_draws(a, waves.shape[0], waves.shape[1], self.g, waves.device)
        aug, _ = A.featurize_augmented(a, waves, lengths, *draws)
        return self._pad_frames(mel), self._pad_frames(lin), aug

    def floss(self, pred, label):
        a = self.m.audio
        loss = ((pred - label) ** 2).mean()
        dim = pred.shape[-1]
        if dim != self.m.n_mels:
            n = int(dim * (3000 / (a.sr / 2)))
            return 0.5 * loss + 0.5 * ((pred[..., :n] - label[..., :n]) ** 2).mean()
        pd, ld = pred[:, 1:] - pred[:, :-1], label[:, 1:] - label[:, :-1]
        return loss + 0.5 * ((pd - ld) ** 2).mean()

    def paired_loss(self, batch, w):
        waves, wl, text, sid = batch
        mel, lin, aug = self._features(waves, wl)
        p_code, _ = self.quantize(self.asr(aug, True))
        asr_loss = self.ctc(p_code, text)
        mel_p, lin_p, _ = self.tts(self.embed_text(text), sid, mel.shape[1] // self.m.r, True, mel)
        mel_loss, lin_loss = self.floss(mel_p, mel), self.floss(lin_p, lin)
        return w["tts"] * (mel_loss + lin_loss) + w["asr"] * asr_loss, dict(
            asr_loss=asr_loss, mel_loss=mel_loss, linear_loss=lin_loss)

    def speech_first_loss(self, batch, u_batch, w, step_no):
        waves, wl, text, sid = batch
        u_waves, u_wl, _, u_sid = u_batch
        mel, lin, aug = self._features(waves, wl)
        u_mel, u_lin, u_aug = self._features(u_waves, u_wl)
        Bp, r = mel.shape[0], self.m.r
        steps = max(mel.shape[1], u_mel.shape[1]) // r
        p_code, q = self.quantize(self.asr(_cat(aug, u_aug), True))
        u_lat, u_len = self.trim_merge(p_code[Bp:], q[Bp:])
        ok = bool((u_len > 0).all()) if not self.count_only else True
        asr_loss = self.ctc(p_code[:Bp, :aug.shape[1] // self.m.trf], text)
        lat = _cat(self.embed_text(text), u_lat)
        mel_p, lin_p, _ = self.tts(lat, torch.cat([sid, u_sid]), steps, True, _cat(mel, u_mel))
        Tp, Tu = mel.shape[1], u_mel.shape[1]
        mel_loss, lin_loss = self.floss(mel_p[:Bp, :Tp], mel), self.floss(lin_p[:Bp, :Tp], lin)
        u_loss = self.floss(mel_p[Bp:, :Tu], u_mel) + self.floss(lin_p[Bp:, :Tu], u_lin)
        gate = float(ok and step_no > w["unpair_speech_start"])
        total = w["asr"] * asr_loss + w["tts"] * (mel_loss + lin_loss) + w["unpair_speech"] * gate * u_loss
        return total, dict(asr_loss=asr_loss, mel_loss=mel_loss, linear_loss=lin_loss,
                           unpair_speech_loss=u_loss)


def _cat(a, b):
    """Two batches on the batch axis, time zero-padded to the longer."""
    T = max(a.shape[1], b.shape[1])
    pad = lambda x: F.pad(x, [0, 0] * (x.dim() - 2) + [0, T - x.shape[1]])
    return torch.cat([pad(a), pad(b)], 0)


def noam_lr(lr, count, warmup=1000.0):
    s = count + 1.0
    return lr * warmup ** 0.5 * min(s * warmup ** -1.5, s ** -0.5)


class Adam:
    """Clip to global norm 5, Adam (b1 0.9, b2 0.999, eps 1e-8), the decay
    schedule, and no update where the gradient is not finite."""

    def __init__(self, params: dict, lr):
        self.lr = lr
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0
        self.schedule_count = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict):
        gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        if not bool(torch.isfinite(gnorm)):
            return gnorm
        scale = 1.0 if float(gnorm) < GRAD_CLIP else GRAD_CLIP / float(gnorm)
        self.count += 1
        lr = noam_lr(self.lr, float(self.schedule_count))
        for k, p in params.items():
            g = grads[k] * scale
            self.mu[k] = (1.0 - B1) * g + B1 * self.mu[k]
            self.nu[k] = (1.0 - B2) * g * g + B2 * self.nu[k]
            u = (self.mu[k] / (1.0 - B1 ** self.count)) / (
                torch.sqrt(self.nu[k] / (1.0 - B2 ** self.count)) + ADAM_EPS)
            p.add_(-lr * u)
        self.schedule_count += 1
        return gnorm


def grads_of(total, params: dict):
    names = list(params)
    gs = torch.autograd.grad(total, [params[n] for n in names], allow_unused=True)
    return {n: (torch.zeros_like(params[n]) if g is None else g) for n, g in zip(names, gs)}
