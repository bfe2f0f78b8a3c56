"""``python -m repro_torch.lint`` — the perf linter's reporting CLI (twin
of ``python -m repro.lint``).

Runs :mod:`repro_torch.analysis.perflint` over the checked-in job graphs
(:mod:`repro_torch.analysis.corpus`, the port's copies of the
reference's graph builders, reported under the reference's source
names) and reports ``OFLP1##`` findings with their predicted cycle
deltas:

    PYTHONPATH=src python -m repro_torch.lint          # text report
    python -m repro_torch.lint --json out.json         # machine-readable
    python -m repro_torch.lint --sarif out.sarif       # GitHub code scanning
    python -m repro_torch.lint --codes-md              # README code table
    python -m repro_torch.lint --explain-regret        # policy=AUTO regret
    python -m repro_torch.lint --update-baseline       # accept findings

Exit status is 0 when every finding is *accounted for* — suppressed by
a file-level ``# repro: allow(OFLP10x)`` comment in the graph-builder
source, or present in the committed baseline (``LINT_baseline.json``,
shared with the reference) — and 1 when new findings appear.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

#: default selection width (the reference's CI mesh width)
MESH_WIDTH = 8

#: where the checked-in corpus's builder sources live
CORPUS_DIR = Path(__file__).resolve().parent / "analysis" / "corpus"

#: checked-in graph sources: (reported source name, ``<file>:<builder>``
#: under :data:`CORPUS_DIR`) where the builder returns ``{name:
#: [GraphNode, ...]}``; the names are the reference's builder files
DEFAULT_CORPUS = (
    ("examples/job_graph", "job_graph.py:build_graphs"),
    ("benchmarks/dag_bench", "dag_bench.py:bench_graphs"),
)

DEFAULT_BASELINE = "LINT_baseline.json"

_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\(([^)]*)\)")


@dataclasses.dataclass
class CorpusGraph:
    """One checked-in graph plus its source-file suppression set."""

    name: str                    # "<source>:<graph>"
    path: Path                   # the builder's source file
    nodes: List[Any]
    allowed: frozenset           # codes a `# repro: allow(...)` suppresses


def _allowed_codes(path: Path) -> frozenset:
    try:
        text = path.read_text()
    except OSError:
        return frozenset()
    codes: set = set()
    for m in _ALLOW_RE.finditer(text):
        codes.update(c.strip().upper() for c in m.group(1).split(",")
                     if c.strip())
    return frozenset(codes)


def load_corpus(specs: Sequence[str],
                root: Optional[Path] = None,
                sources: Optional[Sequence[str]] = None
                ) -> List[CorpusGraph]:
    """Load every ``<file>:<builder>`` spec, relative to ``root`` (the
    working directory by default; missing files are skipped with a
    note).  ``sources`` names each spec's graphs (default: the file's
    path without its suffix)."""
    root = Path.cwd() if root is None else root
    out: List[CorpusGraph] = []
    for i, spec in enumerate(specs):
        fname, _, builder = spec.rpartition(":")
        path = (root / fname).resolve()
        if not path.exists():
            print(f"note: corpus source {fname} not found, skipping",
                  file=sys.stderr)
            continue
        modname = f"_repro_torch_lint_{path.stem}"
        mspec = importlib.util.spec_from_file_location(modname, path)
        assert mspec is not None and mspec.loader is not None
        mod = importlib.util.module_from_spec(mspec)
        sys.modules[modname] = mod
        mspec.loader.exec_module(mod)
        allowed = _allowed_codes(path)
        source = (str(Path(fname).with_suffix("")) if sources is None
                  else sources[i])
        for name, nodes in getattr(mod, builder)().items():
            out.append(CorpusGraph(name=f"{source}:{name}", path=path,
                                   nodes=list(nodes), allowed=allowed))
    return out


def lint_corpus(graphs: Iterable[CorpusGraph], *,
                width: int = MESH_WIDTH
                ) -> List[Tuple[CorpusGraph, List[Any]]]:
    from repro_torch.analysis import perflint
    return [(g, perflint.lint_graph(g.nodes, default_width=width))
            for g in graphs]


# -- reporting surfaces ------------------------------------------------------


def codes_markdown() -> str:
    """The README diagnostic-code table, generated from the registry
    (``--codes-md``; the tests fail on README drift)."""
    from repro_torch.analysis.diagnostics import CODES
    lines = [
        "| code | severity | title |",
        "|------|----------|-------|",
    ]
    for code in sorted(CODES):
        info = CODES[code]
        lines.append(f"| `{code}` | {info.severity.value} | "
                     f"{info.title} |")
    return "\n".join(lines)


def finding_key(graph: str, finding: Any) -> str:
    return f"{graph}::{finding.key()}"


def to_json(results: List[Tuple[CorpusGraph, List[Any]]]) -> Dict[str, Any]:
    return {
        "schema": 1,
        "graphs": {
            g.name: [f.to_payload() for f in findings]
            for g, findings in results
        },
    }


def to_sarif(results: List[Tuple[CorpusGraph, List[Any]]]) -> Dict[str, Any]:
    """SARIF 2.1.0 (the GitHub code-scanning upload format)."""
    from repro_torch.analysis.diagnostics import CODES, Severity
    level = {Severity.ERROR: "error", Severity.WARNING: "warning",
             Severity.PERF: "note"}
    rules = [{
        "id": code,
        "shortDescription": {"text": CODES[code].title},
        "fullDescription": {"text": CODES[code].explain},
        "defaultConfiguration": {
            "level": level[CODES[code].severity]},
    } for code in sorted(CODES)]
    sarif_results = []
    for g, findings in results:
        for f in findings:
            sarif_results.append({
                "ruleId": f.code,
                "level": level[f.diagnostic.severity],
                "message": {"text": f"{g.name}: {f}"},
                "locations": [{
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": g.path.name,
                            "uriBaseId": "SRCROOT"},
                        "region": {"startLine": 1},
                    },
                }],
                "properties": {
                    "graph": g.name,
                    "predictedCycles": f.predicted_cycles,
                    "optimalCycles": f.optimal_cycles,
                    "fix": (None if f.fix is None
                            else dataclasses.asdict(f.fix)),
                },
            })
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {"name": "repro-perflint",
                                "informationUri": "",
                                "rules": rules}},
            "results": sarif_results,
        }],
    }


def regret_report(results: List[Tuple[CorpusGraph, List[Any]]]) -> str:
    """Per-graph model regret: predicted critical path as checked in vs
    with every autofix applied (``--explain-regret``).  The migration
    story for ``policy=AUTO`` users: the planner already avoids these
    regrets on the fields it decides — the table shows what *pinned*
    fields and graph structure still leave on the table."""
    from repro_torch.analysis import perflint
    from repro_torch.core.simulator import graph_critical_path
    lines = [f"{'graph':44s} {'cycles':>10s} {'autofixed':>10s} "
             f"{'regret':>7s}"]
    for g, findings in results:
        jobs, _ = perflint.graph_jobs(g.nodes, default_width=MESH_WIDTH)
        cur = graph_critical_path(jobs)
        fixed_nodes = perflint.apply(findings, nodes=g.nodes).nodes
        assert fixed_nodes is not None
        fjobs, _ = perflint.graph_jobs(fixed_nodes,
                                       default_width=MESH_WIDTH)
        opt = graph_critical_path(fjobs)
        lines.append(f"{g.name:44s} {cur:10.0f} {opt:10.0f} "
                     f"{cur / opt if opt else 1.0:7.3f}")
    return "\n".join(lines)


# -- baseline ----------------------------------------------------------------


def load_baseline(path: Path) -> Dict[str, int]:
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    return {str(k): int(v) for k, v in data.get("findings", {}).items()}


def save_baseline(path: Path,
                  results: List[Tuple[CorpusGraph, List[Any]]]) -> None:
    counts: Dict[str, int] = {}
    for g, findings in results:
        for f in findings:
            if f.code in g.allowed:
                continue
            k = finding_key(g.name, f)
            counts[k] = counts.get(k, 0) + 1
    path.write_text(json.dumps(
        {"schema": 1, "findings": dict(sorted(counts.items()))},
        indent=2, sort_keys=True) + "\n")


def new_findings(results: List[Tuple[CorpusGraph, List[Any]]],
                 baseline: Dict[str, int]
                 ) -> List[Tuple[str, Any]]:
    """Findings neither suppressed in-source nor covered by the
    baseline (per-key counts: the baseline absorbs at most its recorded
    number of findings per key)."""
    budget = dict(baseline)
    fresh: List[Tuple[str, Any]] = []
    for g, findings in results:
        for f in findings:
            if f.code in g.allowed:
                continue
            k = finding_key(g.name, f)
            if budget.get(k, 0) > 0:
                budget[k] -= 1
                continue
            fresh.append((g.name, f))
    return fresh


# -- entry point -------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="model-driven performance linter over checked-in "
                    "job graphs")
    ap.add_argument("--graphs", action="append", metavar="FILE:BUILDER",
                    help="graph source (default: the checked-in corpus); "
                         "repeatable")
    ap.add_argument("--width", type=int, default=MESH_WIDTH,
                    help=f"default selection width (default "
                         f"{MESH_WIDTH})")
    ap.add_argument("--json", metavar="PATH",
                    help="write findings as JSON")
    ap.add_argument("--sarif", metavar="PATH",
                    help="write findings as SARIF 2.1.0")
    ap.add_argument("--baseline", metavar="PATH", default=DEFAULT_BASELINE,
                    help=f"baseline file (default {DEFAULT_BASELINE})")
    ap.add_argument("--update-baseline", action="store_true",
                    help="accept the current findings into the baseline")
    ap.add_argument("--codes-md", action="store_true",
                    help="print the diagnostic-code table as markdown "
                         "and exit")
    ap.add_argument("--explain-regret", action="store_true",
                    help="print per-graph model regret (current vs "
                         "autofixed critical path)")
    args = ap.parse_args(argv)

    if args.codes_md:
        print(codes_markdown())
        return 0

    if args.graphs:
        corpus = load_corpus(args.graphs)
    else:
        corpus = load_corpus([spec for _, spec in DEFAULT_CORPUS],
                             root=CORPUS_DIR,
                             sources=[src for src, _ in DEFAULT_CORPUS])
    results = lint_corpus(corpus, width=args.width)

    if args.json:
        Path(args.json).write_text(
            json.dumps(to_json(results), indent=2, sort_keys=True) + "\n")
    if args.sarif:
        Path(args.sarif).write_text(
            json.dumps(to_sarif(results), indent=2, sort_keys=True) + "\n")
    if args.explain_regret:
        print(regret_report(results))
        print()

    baseline_path = Path(args.baseline)
    if args.update_baseline:
        save_baseline(baseline_path, results)
        print(f"baseline written: {baseline_path}")
        return 0

    baseline = load_baseline(baseline_path)
    fresh = new_findings(results, baseline)
    total = sum(len(f) for _, f in results)
    suppressed = sum(1 for g, fs in results for f in fs
                     if f.code in g.allowed)
    for g, findings in results:
        status = ("clean" if not findings
                  else f"{len(findings)} finding(s)")
        print(f"  {g.name:45s} {len(g.nodes):3d} nodes  {status}")
        for f in findings:
            mark = ("allowed" if f.code in g.allowed else
                    "baseline" if (g.name, f) not in fresh else "NEW")
            print(f"    [{mark}] {f}")
    print(f"lint-graphs: {len(corpus)} graphs, {total} finding(s) "
          f"({suppressed} allowed, {total - suppressed - len(fresh)} "
          f"baselined, {len(fresh)} new)")
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
