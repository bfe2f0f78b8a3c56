"""Nothing under ``bench/`` imports JAX or the JAX package, and the run
refuses a machine with no card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from bench import run, spec  # noqa: E402

BARRED = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_barred_import_under_bench():
    files = sorted((ROOT / "bench").rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not imported(path) & BARRED, path
    # whole names: the port's own name begins with the JAX package's
    assert "repro_torch" not in BARRED and "repro" in BARRED


def test_barred_modules_compares_whole_names():
    assert run.barred_modules(["repro_torch.models", "numpy"]) == []
    assert run.barred_modules(["repro.core", "jaxlib", "torch"]) == [
        "jaxlib", "repro"]


def test_run_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cell = spec.benchmark()["workloads"][0]["name"]
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench/run.py"), "--workload", cell,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith("{")
    assert "no CUDA card" in proc.stderr
