"""Aggregate dry-run JSON records into the roofline table — twin of
``repro.launch.report``; it reads either package's records.

    PYTHONPATH=src python -m repro_torch.launch.report results/dryrun [--tag baseline]

The mesh names ``pod16x16`` and ``pod2x16x16`` name the same logical
meshes in both packages.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List


def load_records(directory: str, tag: str = None) -> List[Dict]:
    recs = []
    for f in sorted(os.listdir(directory)):
        if not f.endswith(".json"):
            continue
        with open(os.path.join(directory, f)) as fh:
            r = json.load(fh)
        if tag and r.get("tag") != tag:
            continue
        recs.append(r)
    return recs


def fmt_bytes(b) -> str:
    if b is None:
        return "-"
    return f"{b / 1e9:.2f}GB"


def roofline_table(recs: List[Dict], mesh: str = "pod16x16") -> str:
    lines = [
        "| arch | shape | status | t_comp (s) | t_mem (s) | t_coll (s) | "
        "bottleneck | MODEL/HLO | roofline frac | args/dev | temp/dev |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | SKIP ({r['reason'][:40]}…) "
                f"| - | - | - | - | - | - | - | - |")
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | ERROR | - | - | - | - | - "
                f"| - | - | - |")
            continue
        ro = r["roofline"]
        mem = r["memory"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok "
            f"| {ro['t_compute_s']:.3e} | {ro['t_memory_s']:.3e} "
            f"| {ro['t_collective_s']:.3e} | {ro['bottleneck']} "
            f"| {ro['useful_flops_fraction']:.3f} "
            f"| {ro['roofline_fraction']:.4f} "
            f"| {fmt_bytes(mem['argument_bytes_per_device'])} "
            f"| {fmt_bytes(mem['temp_bytes_per_device'])} |")
    return "\n".join(lines)


def summarize(recs: List[Dict]) -> str:
    pods = [r for r in recs if r["mesh"] == "pod16x16"]
    mpods = [r for r in recs if r["mesh"] == "pod2x16x16"]
    ok_p = sum(1 for r in pods if r["status"] == "ok")
    ok_m = sum(1 for r in mpods if r["status"] == "ok")
    sk_p = sum(1 for r in pods if r["status"] == "skipped")
    sk_m = sum(1 for r in mpods if r["status"] == "skipped")
    er = [f"{r['arch']}×{r['shape']}×{r['mesh']}"
          for r in recs if r["status"] == "error"]
    out = [f"single-pod 16x16: {ok_p} ok, {sk_p} documented skips",
           f"multi-pod 2x16x16: {ok_m} ok, {sk_m} documented skips"]
    if er:
        out.append(f"ERRORS: {er}")
    # interesting cells for hillclimbing
    ok_cells = [r for r in pods if r["status"] == "ok"]
    if ok_cells:
        worst = min(ok_cells, key=lambda r: r["roofline"]["roofline_fraction"])
        coll = max(ok_cells, key=lambda r: r["roofline"]["t_collective_s"]
                   / max(1e-30, r["roofline"]["t_compute_s"]))
        out.append(f"worst roofline fraction: {worst['arch']}×{worst['shape']} "
                   f"({worst['roofline']['roofline_fraction']:.4f})")
        out.append(f"most collective-bound: {coll['arch']}×{coll['shape']} "
                   f"(t_coll/t_comp="
                   f"{coll['roofline']['t_collective_s']/max(1e-30, coll['roofline']['t_compute_s']):.2f})")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("directory")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--mesh", default="pod16x16")
    args = ap.parse_args()
    recs = load_records(args.directory, args.tag)
    print(summarize(recs))
    print()
    print(roofline_table(recs, args.mesh))


if __name__ == "__main__":
    main()
