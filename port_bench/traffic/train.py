"""Training traffic: the trainer's own loop (``VqvaeTrainer.exec``) in a
closed loop over batches made from the seed at the cell's pads.

A cell file gives the batch size and the pads of the paired batches (and of
the unpaired ones, where the configuration trains the speech-first cycle),
the durations their rows are drawn from, how many distinct batches of each
kind the loop cycles through, and the warm-up steps. Every row's length is
drawn from the seed, its wave is speech-like, its text random phoneme ids
of the length the duration gives at six mel frames a token.

Correctness: set-up drives the trainer through its first ``check_steps``
steps (a cell file's key), as the window does, and keeps each step's loss,
the gradient as the optimizer got it (from its first moment after step 1)
and each parameter's change after the last of them. The checked steps reach
a replay of each kind of step's CUDA graph: a shape runs eagerly at its
first call, is captured at its second (whose work is an eager run) and
replays from its third, so the flagship's speech-first graph first replays
at step 6. Once the window has closed and the program is freed, the plain
reference follows the same steps from the same weights, batches and seeds,
and the worst gap of each is held to its limit."""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from port_bench import harness as H
from port_bench.reference import model as R


def step_seed(seed, step_no):
    """The seed of a train step's generator (the trainer's rule)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(step_no) * 0xBF58476D1CE4E5B9) % (1 << 63)


def step_kind(step, hp):
    """The step the trainer runs at ``step``: the speech-first cycle on even
    steps past its start when its weight is above 0, else paired."""
    if step % 2 == 0 and hp["unpair_speech_weight"] > 0 and step > hp["unpair_speech_start_step"]:
        return "speech_first"
    return "paired"


def loss_weights(hp):
    return dict(asr=hp["asr_weight"], tts=hp["tts_weight"], unpair_speech=hp["unpair_speech_weight"],
                unpair_speech_start=hp["unpair_speech_start_step"])


# ---------------- inputs ----------------

def batch_pool(cell, conf, seed, device, kind):
    """``cell[kind]["pool"]`` batches (waves, wave_len, text, sid) of the
    cell's pads; every row different."""
    spec = cell[kind]
    a = conf["audio"]
    sr, hop = a["sample_rate"], int(a["frame_shift_ms"] / 1000 * a["sample_rate"])
    g = H.generator(seed, "batches." + kind, device)
    rows = torch.Generator().manual_seed(H.mix(seed, "rows." + kind))
    durs = torch.tensor(spec["durations"], dtype=torch.float64)
    B, S, U = spec["batch"], spec["pad_samples"], spec["pad_tokens"]
    out = []
    for _ in range(spec["pool"]):
        d = durs[torch.randint(len(durs), (B,), generator=rows)].tolist()
        lengths = [min(S, int(round(x * sr))) for x in d]
        tokens = [min(U, H.tokens_of(x, sr, hop)) for x in d]
        w = H.waves(lengths, S, g, sr, device)
        text = H.texts(tokens, U, conf["vocab_size"], g, device)
        sid = torch.randint(conf["n_spkr"], (B,), generator=g, device=device).to(torch.int32)
        out.append((w.contiguous(), torch.tensor(lengths, dtype=torch.int32, device=device), text, sid))
    return out


def cycle(pool):
    while True:
        yield from pool


# ---------------- the program ----------------

def build(conf, cell, seed, device):
    """The trainer of the configuration with the seed's weights -> (trainer,
    the weights)."""
    from semi_tts_tpu_torch.models import vqvae as V
    from semi_tts_tpu_torch.ops.features import AudioConfig, AudioFeaturizer
    from semi_tts_tpu_torch.train.optim import Optimizer, tf_rate_schedule
    from semi_tts_tpu_torch.train.steps import StepBuilder, Weights
    from semi_tts_tpu_torch.train.train_vqvae import VqvaeTrainer

    a, hp = conf["audio"], conf["hparas"]
    cfg = V.config_from_yaml(conf["model"], n_mels=a["num_mels"],
                             linear_dim=a["num_freq"] if a["use_linear"] else None,
                             vocab_size=conf["vocab_size"], n_spkr=conf["n_spkr"],
                             attr_dim=len(conf["phn_attr"][0]))
    model = V.VQVAE(cfg, generator=torch.Generator().manual_seed(0)).to(device)
    P, S = H.make_weights(*H.model_shapes(model), seed, device)
    H.load_weights(model, P, S)
    audio = AudioConfig(num_freq=a["num_freq"], num_mels=a["num_mels"],
                        frame_length_ms=a["frame_length_ms"], frame_shift_ms=a["frame_shift_ms"],
                        preemphasis_coeff=a["preemphasis_coeff"], sample_rate=a["sample_rate"],
                        use_linear=a["use_linear"], snr_range=tuple(a["snr_range"]),
                        time_stretch_range=tuple(a["time_stretch_range"]))
    phn_attr = torch.tensor(conf["phn_attr"], dtype=torch.float32, device=device)
    builder = StepBuilder(cfg, AudioFeaturizer(audio, device), phn_attr,
                          weights=Weights(hp["asr_weight"], hp["tts_weight"], hp["unpair_text_weight"],
                                          hp["unpair_speech_weight"], hp["unpair_text_start_step"],
                                          hp["unpair_speech_start_step"]),
                          freq_loss_kwargs=dict(loss=hp["freq_loss_type"],
                                                differential_loss=hp["differential_loss"],
                                                emphasize_linear_low=hp["emphasize_linear_low"]))
    opt = Optimizer(model.parameters(), hp["optimizer"], hp["lr"], hp["lr_scheduler"])
    trainer = VqvaeTrainer(model, builder, opt, pair_iter=None, dev_set=[], max_step=0,
                           valid_step=hp["valid_step"], seed=seed,
                           tf_rate=tf_rate_schedule(hp["tf_start"], hp["tf_end"], hp["tf_step"]))
    return trainer, P


class Driver:
    """The trainer with the benchmark's spans around each step, the metrics
    of the first steps kept, and the rows of each finished step counted."""

    def __init__(self, trainer, cell, spans):
        self.t, self.spans, self.keep = trainer, spans, cell["check_steps"]
        self.rows = {"paired": cell["paired"]["batch"],
                     "speech_first": cell["paired"]["batch"] + cell.get("unpaired", {}).get("batch", 0)}
        self.kept, self.kinds, self.recorder, self.calls = [], [], None, {}
        step = trainer._train_step

        def traced(batch, unpaired=None):
            kind = self.t.step_kind()
            record = self.recorder is not None and kind not in self.calls
            with self.spans.span("port_bench.step." + kind):
                if record:
                    with self.recorder.recording() as rec:
                        mets = step(batch, unpaired)
                    self.calls[kind] = list(rec.calls)
                else:
                    mets = step(batch, unpaired)
            self.kinds.append(kind)
            if len(self.kept) < self.keep:
                self.kept.append({k: v for k, v in mets.items() if k.endswith("_loss")})
            return mets

        trainer._train_step = traced

    def run_to(self, step):
        self.t.max_step = step
        self.t.exec()

    def rows_of(self, kinds):
        return sum(self.rows[k] for k in kinds)


def param_names(trainer):
    return [n for n, _ in trainer.model.named_parameters()]


def first_grad_norms(trainer):
    """Each leaf's norm of the gradient the optimizer got at step 1, from
    its first moment."""
    opt = trainer.optimizer
    return {n: float(v.norm()) / (1.0 - R.B1) for n, v in zip(param_names(trainer), opt.views(opt.mu))}


def change_norms(trainer, P):
    return {n: float((p.detach() - P[n]).norm()) for n, p in trainer.model.named_parameters()}


def program_readings(driver, P):
    """The checked steps through the trainer's loop -> the readings
    compared."""
    driver.run_to(1)
    grads = first_grad_norms(driver.t)
    driver.run_to(driver.keep)
    change = change_norms(driver.t, P)
    losses = [{k: float(v) for k, v in m.items()} for m in driver.kept]
    return dict(losses=losses, grads=grads, change=change)


# ---------------- the reference ----------------

def reference_readings(conf, cell, seed, device, tf32=False):
    """The plain reference over the same checked steps from the same
    weights and batches; ``tf32``: its products in TF32 (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _reference(conf, cell, seed, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def weights_of(conf, seed, device):
    """The seed's weights, made as `build` makes them: by the shapes of the
    configuration's parameters."""
    from semi_tts_tpu_torch.models import vqvae as V

    a = conf["audio"]
    cfg = V.config_from_yaml(conf["model"], n_mels=a["num_mels"],
                             linear_dim=a["num_freq"] if a["use_linear"] else None,
                             vocab_size=conf["vocab_size"], n_spkr=conf["n_spkr"],
                             attr_dim=len(conf["phn_attr"][0]))
    with torch.device("meta"):
        shapes = H.model_shapes(V.VQVAE(cfg))
    return H.make_weights(*shapes, seed, device)


def _reference(conf, cell, seed, device):
    hp = conf["hparas"]
    P, S = weights_of(conf, seed, device)
    P = {k: v.clone().requires_grad_(True) for k, v in P.items()}
    init = {k: v.detach().clone() for k, v in P.items()}
    pairs = cycle(batch_pool(cell, conf, seed, device, "paired"))
    unpairs = cycle(batch_pool(cell, conf, seed, device, "unpaired")) if "unpaired" in cell else None
    m = R.Model(conf)
    phn_attr = torch.tensor(conf["phn_attr"], dtype=torch.float32, device=device)
    opt = R.Adam(P, hp["lr"])
    w = loss_weights(hp)
    losses, grads = [], None
    for step in range(cell["check_steps"]):
        g = torch.Generator(device=device).manual_seed(step_seed(seed, step))
        net = R.Net(m, P, S, phn_attr, g)
        batch = next(pairs)
        if step_kind(step, hp) == "paired":
            total, mets = net.paired_loss(batch, w)
        else:
            total, mets = net.speech_first_loss(batch, next(unpairs), w, step)
        gr = R.grads_of(total, P)
        opt.step(P, gr)
        losses.append({k: float(v.detach()) for k, v in mets.items()} | {"total_loss": float(total.detach())})
        if step == 0:
            grads = {n: float(v.norm()) / (1.0 - R.B1) for n, v in opt.mu.items()}
        del total, gr, net
    change = {n: float((P[n].detach() - init[n]).norm()) for n in P}
    return dict(losses=losses, grads=grads, change=change)


def compare(prog, ref):
    """The numbers held to the limits: the worst relative gap of a step's
    total loss; the worst gap of a leaf's norm of the first gradient and of
    its change over the checked steps, each over the larger of the
    reference's norm of that leaf and of the median leaf. Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone under Adam and are left out of the change."""
    loss = max(abs(p["total_loss"] - r["total_loss"]) / max(abs(r["total_loss"]), 1e-30)
               for p, r in zip(prog["losses"], ref["losses"]))
    gmed = statistics.median(ref["grads"].values())
    grad = max(abs(prog["grads"][n] - v) / max(v, gmed, 1e-30) for n, v in ref["grads"].items())
    moved = [n for n, v in ref["grads"].items() if v >= 1e-3 * gmed]
    cmed = statistics.median(ref["change"][n] for n in moved)
    change = max(abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n], cmed, 1e-30)
                 for n in moved)
    worst = max(moved, key=lambda n: abs(prog["change"][n] - ref["change"][n])
                / max(ref["change"][n], cmed, 1e-30))
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}, worst


# ---------------- the run ----------------

def run(ctx):
    conf, cell, seed, device = ctx.conf, ctx.cell, ctx.seed, ctx.device
    hp = conf["hparas"]
    t_start = ctx.t0
    trainer, P = build(conf, cell, seed, device)
    trainer.pair_iter = cycle(batch_pool(cell, conf, seed, device, "paired"))
    if "unpaired" in cell:
        trainer.unpair_iter = cycle(batch_pool(cell, conf, seed, device, "unpaired"))
    spans = H.Spans()
    driver = Driver(trainer, cell, spans)
    if ctx.trace:
        driver.recorder = H.CallRecorder(H.cost_modules())
    prog = program_readings(driver, P)
    del P
    driver.run_to(cell["warmup_steps"])
    H.sync(device)
    setup_s = time.perf_counter() - t_start
    data = {"setup_s": setup_s}

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    spans.items.clear()
    first = len(driver.kinds)
    if ctx.trace:
        spans.traced = True
        with H.profiled(device) as out:
            _window(driver, min(ctx.seconds, cell["trace_seconds"]), device)
        data["trace"] = out["trace"]
        data["calls"] = driver.calls
        data["flops"] = {k: step_flops(conf, cell, k) for k in set(driver.kinds[first:])}
    else:
        elapsed = _window(driver, ctx.seconds, device)
        kinds = driver.kinds[first:]
        data["train_utt_per_s"] = driver.rows_of(kinds) / elapsed
        print(f"port_bench: {len(kinds)} steps ({kinds.count('speech_first')} speech-first) "
              f"in {elapsed:.3f} s", flush=True)
    data["kinds"] = driver.kinds[first:]
    data["spans"] = list(spans.items)
    attempted = len(driver.kinds)
    device_rec = H.device_record(device, ctx.chips)

    del driver, trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_readings(conf, cell, seed, device)
    numbers, worst = compare(prog, ref)
    print(f"port_bench: the reference's {cell['check_steps']} steps took "
          f"{time.perf_counter() - t_ref:.3f} s; the leaf whose change differs most: {worst}",
          flush=True)
    return dict(data=data, numbers=numbers, attempted=attempted, failed=0, device=device_rec)


def _window(driver, seconds, device):
    """Steps through the trainer's loop until ``seconds`` have passed; the
    window ends with a synchronise -> its length."""
    t0 = time.perf_counter()
    step = driver.t.step
    while True:
        step += 1
        driver.run_to(step)
        if time.perf_counter() - t0 >= seconds:
            break
    H.sync(device)
    return time.perf_counter() - t0


def step_flops(conf, cell, kind):
    """FLOPs of one train step of ``kind`` at the cell's pads: the plain
    reference's forward, backward and update, counted on ``meta``."""
    dev = torch.device("meta")
    P, S = weights_of(conf, 0, dev)
    P = {k: v.requires_grad_(True) for k, v in P.items()}
    m = R.Model(conf)
    net = R.Net(m, P, S, torch.zeros((conf["vocab_size"], len(conf["phn_attr"][0])), device=dev),
                None, count_only=True)

    def batch(spec):
        B, S_, U = spec["batch"], spec["pad_samples"], spec["pad_tokens"]
        return (torch.zeros((B, S_), device=dev), torch.full((B,), S_, dtype=torch.int32, device=dev),
                torch.ones((B, U), dtype=torch.int32, device=dev),
                torch.zeros((B,), dtype=torch.long, device=dev))

    w = loss_weights(conf["hparas"])

    def step():
        if kind == "paired":
            total, _ = net.paired_loss(batch(cell["paired"]), w)
        else:
            total, _ = net.speech_first_loss(batch(cell["paired"]), batch(cell["unpaired"]), w, 2)
        torch.autograd.grad(total, list(P.values()), allow_unused=True)

    n = sum(math.prod(v.shape) for v in P.values())
    return H.count_flops(step) + 12 * n  # Adam's update: a dozen operations a weight
