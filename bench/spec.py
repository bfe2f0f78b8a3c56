"""A cell as data: ``BENCHMARK.json``'s entry, its configuration file, its
traffic mix (``bench/mixes/<traffic>.json``), its limits
(``bench/limits/<cell>.json``) and the readers of its per-layer metrics
(``bench/metrics/<metric>.py``), all found by name."""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _rehearsed(data: Dict, rehearsal: bool) -> Dict:
    """``data`` with its ``rehearsal`` entries put over it, when asked."""
    extra = data.get("rehearsal", {}) if rehearsal else {}
    return {**data, **extra}


def _applies(metric: Mapping, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, *, rehearsal: bool = False,
              root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; with
    ``rehearsal``, its configuration and mix at the sizes their
    ``rehearsal`` entries give (a CPU run), and the limits the limits
    file's ``rehearsal`` entry gives for those sizes."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((root / "bench" / "mixes" / f"{w['traffic']}.json")
                     .read_text())
    limits = _rehearsed(json.loads(
        (root / "bench" / "limits" / f"{name}.json").read_text()), rehearsal)
    limits.pop("rehearsal", None)
    return Cell(name=name, chips=w["chips"],
                config=_rehearsed(config, rehearsal),
                mix=_rehearsed(mix, rehearsal), limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def reader(metric: str, root: Path = ROOT
           ) -> Callable[[Mapping], Optional[float]]:
    """``bench/metrics/<metric>.py``'s ``read``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def derive(seed: int, *tags: object) -> int:
    """A 63-bit seed for one use of the run's seed: the same ``seed`` and
    ``tags`` give the same number, other tags another."""
    text = "/".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1
