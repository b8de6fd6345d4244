"""The control of each cell's comparison, and the half-batch fault of the
training cells, read on the card through a whole run of the cell at its own
size (``run.main``, a one-second window), each judged by the run's own
comparison against the cell's limits: both come out not correct.

The control is the plain reference computed in TF32 (the precision below
the configurations' fp32 with TF32 off) put in the program's place: a
training cell's readings of its checked steps, a serving cell's waveforms
of the sampled requests. The fault leaves half of each paired batch out of
the program's step and takes the mean over the rest.

On the card only: ``python3 -m pytest port_bench/tests -m card -s`` (each
run's compared numbers and their limits are its last lines on standard
error)."""

import pytest

from port_bench import harness as H
from port_bench import run
from port_bench import serving as SV

SEEDS = (4100000001, 4100000003, 4100000005)
BENCH = H.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
TRAIN = [c for c in CELLS if H.cell_of(c, BENCH)["kind"] == "train"]


def run_cell(name, seed):
    return run.main(["--workload", name, "--seed", str(seed), "--seconds", "1", "--trace", "0"])


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(card, monkeypatch, name, seed):
    cell = H.cell_of(name, BENCH)
    conf = H.config_of(cell["config"], BENCH)
    mod = H.traffic_module(cell["kind"])
    if cell["kind"] == "train":
        monkeypatch.setattr(mod, "program_readings", lambda driver, P: mod.reference_readings(
            conf, cell, seed, card, tf32=True))
    else:
        checked = SV.reference_check

        def control(conf_, seed_, device, served):
            ctl = SV.reference_waves(conf_, seed_, device, [x[:3] for x in served], tf32=True)
            return checked(conf_, seed_, device, [x[:3] + (w,) for x, w in zip(served, ctl)])

        monkeypatch.setattr(SV, "reference_check", control)
    monkeypatch.setattr(H, "traffic_module", lambda kind: mod)
    assert run_cell(name, seed)["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out_is_not_correct_at_the_cells_size(card, monkeypatch, name, seed):
    from semi_tts_tpu_torch.train.steps import StepBuilder

    full = StepBuilder.paired_loss_and_grads

    def half(self, model, waves, wave_len, text, sid, *a, **k):  # the mean over the first half
        n = waves.shape[0] // 2
        return full(self, model, waves[:n], wave_len[:n], text[:n], sid[:n], *a, **k)

    monkeypatch.setattr(StepBuilder, "paired_loss_and_grads", half)
    assert run_cell(name, seed)["correct"] is False
