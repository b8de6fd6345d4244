"""The comparison that decides ``correct`` fails when the timed path is
broken underneath: the whole run on the CPU, the chip's look skipped, with
each fault a cell can have planted in the program."""

import torch

import tiny
from test_port_bench_reference import run_cell


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    from semi_tts_tpu_torch.train import optim

    def unchanged(self, grads):  # the norm as the step reports it, no update
        return torch.sqrt(sum((g * g).sum() for g in grads if g is not None))

    monkeypatch.setattr(optim.Optimizer, "step", unchanged)
    out = run_cell(tiny.train_cell(), tiny.conf())
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] > 0.5


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from semi_tts_tpu_torch.train.steps import StepBuilder

    full = StepBuilder.paired_loss_and_grads

    def half(self, model, waves, wave_len, text, sid, *a, **k):  # the mean over the first half
        n = waves.shape[0] // 2
        return full(self, model, waves[:n], wave_len[:n], text[:n], sid[:n], *a, **k)

    monkeypatch.setattr(StepBuilder, "paired_loss_and_grads", half)
    cell = tiny.train_cell()
    cell["paired"]["batch"] = 4
    out = run_cell(cell, tiny.conf())
    assert not out["correct"] and out["checks"]["loss_gap"]["value"] > 1e-3


def test_an_answer_altered_where_it_is_made_is_not_correct(monkeypatch):
    from semi_tts_tpu_torch import serve

    made = serve.specgram_to_waveform

    def altered(*a, **k):  # the first row's waveform made 1% louder
        wav = made(*a, **k)
        return torch.cat([wav[:1] * 1.01, wav[1:]])

    monkeypatch.setattr(serve, "specgram_to_waveform", altered)
    for name in ("semi.bulk", "semi.online"):
        out = run_cell(tiny.serve_cell(name), tiny.conf())
        assert not out["correct"], name
