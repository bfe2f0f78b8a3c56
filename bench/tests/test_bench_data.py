"""The benchmark as data: BENCHMARK.json keeps to its contract, every cell,
configuration, mix, limit, driver, architecture and metric reader loads by
name, and new ones are picked up without an edit to any file already
there."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from bench import arch, drivers, spec  # noqa: E402

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]
WIDTHS = ("d_model", "d_ff", "n_heads", "n_kv_heads", "head_dim")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source", "workloads"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves", "workloads"})):
        for entry in BENCH[group]:
            assert set(entry) <= keys, (group, entry)
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in seen
            seen.add((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in (
                    "lower", "higher")
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200
                    assert "\n" not in entry[text] and "\t" not in entry[text]


def test_metrics_cover_every_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    for cell in CELLS:
        c = spec.load_cell(cell)
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer


def test_cells_take_one_chip_each_pair_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    path = ROOT / entry["file"]
    assert entry["file"].startswith("bench/configs/")
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["chips"] == 1 and "assumed" in cfg
    assert not set(cfg["reduced"]) & set(WIDTHS)
    drivers.model_config(cfg)            # the program takes it as it is
    drivers.reference(cfg)               # and its reference is beside it
    arch.load(cfg)                       # with its shapes and counts


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads(cell):
    c = spec.load_cell(cell)
    assert issubclass(drivers.load(c.mix["driver"]), drivers.Driver)
    assert c.limits and all(v > 0 for v in c.limits.values())
    small = spec.load_cell(cell, rehearsal=True)
    assert small.config["d_model"] < c.config["d_model"]


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_returns_nothing_without_records(metric):
    read = spec.reader(metric)
    assert read({}) is None
    assert read({"driver": "other", "profile": {"busy_s": 1.0,
                                                "window_s": 2.0}}) is None


def test_new_mix_and_entry_need_no_edit(tmp_path):
    """A copy of the benchmark gains a cell, a mix, a limit and a metric
    by new files and new entries alone."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((ROOT / "bench/mixes/batch-decode.json").read_text())
    mix["requests"] = [[512, 8], [1024, 8]]
    (tmp_path / "bench/mixes/two-lengths.json").write_text(json.dumps(mix))
    (tmp_path / "bench/limits/smollm-360m.two-lengths.json").write_text(
        json.dumps({"logit_gap": 0.1}))
    (tmp_path / "bench/metrics/requests.count.py").write_text(
        "def read(rec):\n    return rec.get('requests')\n")
    bench["workloads"].append({"name": "smollm-360m.two-lengths",
                               "config": "smollm-360m",
                               "traffic": "two-lengths", "chips": 1,
                               "why": "two prompt lengths"})
    bench["per_layer"].append({"name": "requests.count", "unit": "count",
                               "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "serve_tokens_per_s",
                               "workloads": ["smollm-360m.two-lengths"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("smollm-360m.two-lengths", root=tmp_path)
    assert cell.mix["requests"] == [[512, 8], [1024, 8]]
    assert cell.config["name"] == "smollm-360m"
    assert [m["name"] for m in cell.per_layer] == ["requests.count"]
    assert spec.reader("requests.count", root=tmp_path)({"requests": 3}) == 3
    after = {p: p.read_bytes() for p in before}
    assert after == before


NEW_ARCH = '''
"""A toy architecture: one matrix and one gain."""


def leaf_shapes(cfg):
    return [("w", (cfg["d_model"], cfg["d_model"])), ("g", (cfg["d_model"],))]


def step_flops(cfg, rows):
    return 2 * cfg["d_model"] ** 2 * rows
'''

NEW_DRIVER = '''
"""A toy driver: products of the toy architecture's matrix, checked
against the same product in float64."""

import time

import torch

from bench import arch
from bench.drivers import Driver, Window


class Products(Driver):
    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.mix = cell.config, cell.mix
        self.marks = []

    def setup(self):
        self.w = self.weights()
        self.x = torch.ones(self.mix["rows"], self.cfg["d_model"])
        self.mark("weights")

    def window(self, seconds):
        t0, n = time.perf_counter(), 0
        while n == 0 or time.perf_counter() - t0 < seconds:
            self.y = self.x @ self.w["w"]
            n += 1
        flops = n * arch.load(self.cfg).step_flops(self.cfg, self.mix["rows"])
        return Window({"products_per_s": n / (time.perf_counter() - t0)},
                      attempted=n, failed=0, records={"driver": "products",
                                                      "flops": flops})

    def release(self):
        pass

    def check(self):
        want = self.x.double() @ self.weights()["w"].double()
        return {"product_gap": float((self.y - want).abs().max())}


DRIVER = Products
'''


def test_new_driver_and_architecture_need_no_edit(tmp_path):
    """A copy of the benchmark gains a driver (``drivers/<name>.py``) and an
    architecture (``arch/<name>.py``) with a configuration, a mix, a
    limit, a metric and their entries, by new files alone; a whole run of
    the new cell on the CPU goes through ``bench/run.py``'s ``run``."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    new = {"arch/toy.py": NEW_ARCH, "drivers/products.py": NEW_DRIVER,
           "configs/toy.json": json.dumps({"name": "toy", "architecture": "toy",
                                           "d_model": 8}),
           "mixes/rows.json": json.dumps({"driver": "products", "rows": 4}),
           "limits/toy.rows.json": json.dumps({"product_gap": 1e-4}),
           "metrics/flops.toy.py": "def read(rec):\n"
                                   "    return rec.get('flops')\n"}
    for name, text in new.items():
        (tmp_path / "bench" / name).write_text(text)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a test",
                             "file": "bench/configs/toy.json", "reduced": [],
                             "why": "a toy"})
    bench["workloads"].append({"name": "toy.rows", "config": "toy",
                               "traffic": "rows", "chips": 1, "why": "toy"})
    bench["end_to_end"].append({"name": "products_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["toy.rows"]})
    bench["per_layer"].append({"name": "flops.toy", "unit": "FLOP",
                               "better": "higher", "source": "host_clock",
                               "layer": "toy", "moves": "products_per_s",
                               "workloads": ["toy.rows"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import json, torch\n"
        "from bench import run, spec\n"
        "cell = spec.load_cell('toy.rows')\n"
        "res = run.run(cell, 3, 0.05, False, torch.device('cpu'))\n"
        "print(json.dumps({'correct': res['correct'],"
        " 'metrics': sorted(res['metrics']), 'checks': res['checks'],"
        " 'flops': spec.reader('flops.toy')({'flops': 5})}))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT / "src")]))
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["flops"] == 5
    assert out["metrics"] == ["products_per_s", "setup_s"]
    assert out["checks"][0][0] == "product_gap"
    assert {p: p.read_bytes() for p in before} == before
