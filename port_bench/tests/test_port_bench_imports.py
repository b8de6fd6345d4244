"""Nothing the benchmark runs imports JAX or the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from port_bench import harness as H

FORBIDDEN = {"jax", "jaxlib", "flax", "semi_tts_tpu"}


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(H.HERE, "**", "*.py"), recursive=True):
        for name in imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(H.HERE, "reference", "*.py")):
        for name in imports(path):
            assert name.split(".")[0] != "semi_tts_tpu_torch", (path, name)
    code = ("import sys; sys.path.insert(0, %r); import port_bench.reference.model; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % H.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    loaded = set(eval(out.stdout))
    assert not loaded & (FORBIDDEN | {"semi_tts_tpu_torch"}), loaded


def test_a_run_loads_no_jax_module():
    code = ("import sys; sys.path[:0] = [%r, %r]; import tiny; from port_bench import run; "
            "run.main(['--workload', 'semi.bulk', '--seed', '5', '--seconds', '0.3', '--trace', '0', "
            "'--device', 'cpu'], cell_override=tiny.serve_cell(), conf_override=tiny.conf()); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (H.ROOT, os.path.dirname(os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "semi_tts_tpu_torch" in loaded and not loaded & FORBIDDEN
