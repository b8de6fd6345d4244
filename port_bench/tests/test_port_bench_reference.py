"""The frozen plain reference against the program's CPU path at the tiny
sizes: the whole harness run on the CPU (``--device cpu``), each cell's
numbers far inside their limits."""

import pytest

import tiny
from port_bench import run

SEED = 3000000017


def run_cell(cell, conf, trace=0, seed=SEED):
    return run.main(["--workload", cell["name"], "--seed", str(seed), "--seconds", "0.5",
                     "--trace", str(trace), "--device", "cpu"], cell_override=cell, conf_override=conf)


def supervised():
    conf = tiny.conf("seperate")
    conf["hparas"]["unpair_speech_weight"] = 0.0
    return tiny.train_cell("supervised.train"), conf


@pytest.mark.parametrize("which", ["semi", "supervised"])
def test_train_steps_match_the_program(which):
    cell, conf = (tiny.train_cell(), tiny.conf()) if which == "semi" else supervised()
    out = run_cell(cell, conf)
    c = out["checks"]
    assert out["correct"]
    assert c["loss_gap"]["value"] < 1e-5
    assert c["grad_gap"]["value"] < 1e-3 and c["change_gap"]["value"] < 1e-3
    assert out["metrics"]["train_utt_per_s"]["value"] > 0 and out["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("name", ["semi.bulk", "semi.online"])
def test_served_waveforms_match_the_program(name):
    out = run_cell(tiny.serve_cell(name), tiny.conf())
    assert out["correct"] and out["checks"]["wave_gap"]["value"] < 1e-5
    assert out["attempted"] > 0 and out["failed"] == 0


def test_traced_run_reports_the_per_layer_metrics_it_can_read():
    out = run_cell(tiny.serve_cell(), tiny.conf(), trace=1)
    assert {"mfu.bulk", "idle_share.bulk"} <= set(out["metrics"])
    assert out["device"]["window_s"] > 0 and "breakdown" in out
    assert list(out)[-1] == "checks"
