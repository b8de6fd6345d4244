"""``BENCHMARK.json`` against the benchmark's contract, every name it gives
found as a file, and a cell and a metric added as new files only."""

import json
import os
import re
import shutil

import pytest

from port_bench import harness as H

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
B = H.manifest()


def test_keys_names_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["paths"] == ["port_bench"] and B["command"] == ["python3", "port_bench/run.py"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in B[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in B["end_to_end"]}
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
    n = len(B["workloads"])
    assert 2 + 14 * n <= 2 + 14 * 24 and (B["run_seconds"] + 60) * (2 + 14 * 24) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(B)) < 64 * 1024


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer():
    for w in B["workloads"]:
        e2e = {m["name"] for m in H.metrics_of(w["name"], B, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        layer = H.metrics_of(w["name"], B, "per_layer")
        assert layer and all(m["moves"] in e2e for m in layer), w["name"]
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_every_name_is_a_file():
    for c in B["configs"]:
        conf = H.read_json(os.path.join(H.ROOT, c["file"]))
        assert conf["reduced"] == c["reduced"] == []
    for w in B["workloads"]:
        cell = H.cell_of(w["name"], B)
        assert os.path.exists(os.path.join(H.HERE, "traffic", cell["kind"] + ".py"))
        assert set(cell["limits"])
    for m in B["per_layer"]:
        assert H.reader(m["name"]) is not None, m["name"]


def test_a_cell_and_a_metric_added_as_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(H.HERE, root / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(B))
    bench["workloads"].append(dict(B["workloads"][0], name="semi.train.copy",
                                   why="the same traffic under another name"))
    bench["per_layer"].append({"name": "steps.train", "unit": "count", "better": "higher",
                               "source": "program_span", "layer": "training loop",
                               "moves": "train_utt_per_s", "workloads": ["semi.train.copy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(root / "port_bench" / "workloads" / "semi.train.json",
                root / "port_bench" / "workloads" / "semi.train.copy.json")
    (root / "port_bench" / "metrics" / "steps.train.py").write_text(
        "def read(ctx):\n    return len(ctx.data['kinds'])\n")
    copy = H.load_module(str(root / "port_bench" / "harness.py"), "port_bench_harness_copy")
    got = copy.manifest()
    cell = copy.cell_of("semi.train.copy", got)
    assert cell["kind"] == "train" and cell["name"] == "semi.train.copy"
    assert [m["name"] for m in copy.metrics_of("semi.train.copy", got, "per_layer")] == ["steps.train"]
    assert copy.reader("steps.train").read(type("C", (), {"data": {"kinds": [1, 2]}})) == 2


def test_a_layer_metric_without_a_list_of_cells_goes_to_each_cell_of_the_metric_it_moves():
    bench = json.loads(json.dumps(B))
    bench["per_layer"].append({"name": "steps.all", "unit": "count", "better": "higher",
                               "source": "program_span", "layer": "training loop",
                               "moves": "train_utt_per_s"})
    for w in B["workloads"]:
        e2e = {m["name"] for m in H.metrics_of(w["name"], bench, "end_to_end")}
        got = [m["name"] for m in H.metrics_of(w["name"], bench, "per_layer")]
        assert ("steps.all" in got) == ("train_utt_per_s" in e2e), w["name"]
    assert any("steps.all" in [m["name"] for m in H.metrics_of(w["name"], bench, "per_layer")]
               for w in B["workloads"])


def test_a_directory_of_the_benchmark_alone_gives_no_result(tmp_path):
    import subprocess
    import sys

    shutil.copytree(H.HERE, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(H.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "semi.bulk", "--seed",
                          "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.parametrize("var", ["TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"])
def test_caches_sit_at_fixed_paths_in_the_checkout(monkeypatch, var):
    monkeypatch.delenv(var, raising=False)
    H.set_cache_dirs()
    assert os.environ[var].startswith(H.ROOT + os.sep) and os.environ["USE_FLAX"] == "0"
