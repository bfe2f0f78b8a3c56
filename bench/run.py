"""Run one cell of the port's benchmark on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's program from the seed, warms up every shape its traffic
sends (set-up, timed from the start of this script), measures for
``--seconds``, and with ``--trace 1`` profiles a short slice of the same
work.  Then it frees the program and holds what the window produced
against the plain reference.  The last line of standard output is the
result as one JSON object; the numbers compared are the last lines of
standard error and the result's last key.  Without a CUDA card, or with
fewer cards than the cell asks for, it exits 1 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules the process may not hold: JAX and the JAX package
BARRED = ("jax", "jaxlib", "flax", "repro")


def barred_modules(names=None) -> list:
    """The barred top-level names among ``names`` (the loaded modules)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(BARRED))


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float = T_START) -> dict:
    """Set up, measure and check ``cell`` on ``device`` -> the result
    (``checks``: [(name, value, limit)])."""
    import torch

    from bench import compare, drivers
    from bench.spec import reader

    driver = drivers.load(cell.mix["driver"])(cell, seed, device)
    driver.mark("imports")
    driver.setup()
    setup_s = time.perf_counter() - t_start
    last, phases = t_start, []
    for phase, t in sorted(driver.marks, key=lambda m: m[1]):
        phases.append(f"{phase} {t - last:.2f} s")
        last = t
    print("set-up: " + ", ".join(phases), file=sys.stderr)
    win = driver.window(seconds)
    metrics = {"setup_s": setup_s, **win.metrics}
    out = {"metrics": {m["name"]: {"value": metrics[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end}}
    if trace:
        t_prof = time.perf_counter()
        prof = driver.profile()
        print(f"profiled slice {prof['window_s']:.1f} s, read in "
              f"{time.perf_counter() - t_prof:.1f} s", file=sys.stderr)
        rec = {**win.records, "profile": prof}
        read = {m["name"]: (reader(m["name"])(rec), m["unit"])
                for m in cell.per_layer}
        out["metrics"] = {n: {"value": v, "unit": u}
                          for n, (v, u) in read.items() if v is not None}
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
        out["trace"] = {"busy_s": prof["busy_s"],
                        "window_s": prof["window_s"]}
    if device.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    driver.release()
    t_check = time.perf_counter()
    numbers = driver.check()
    print(f"reference check {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    checks = compare.against(numbers, cell.limits)
    out.update(attempted=win.attempted, failed=win.failed,
               correct=win.failed == 0 and compare.passed(checks),
               checks=checks)
    return out


def result_line(res: dict, device_kind: str, count: int) -> dict:
    """The printed result: ``checks`` last."""
    device = {"platform": "gpu", "kind": device_kind, "count": count,
              "memory_peak_bytes": res.get("memory_peak_bytes", 0)}
    if "trace" in res:
        device.update(res["trace"])
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in res["checks"]}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: this benchmark measures the card",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    res = run(cell, args.seed, args.seconds, bool(args.trace), device)
    barred = barred_modules()
    if barred:
        print(f"the process holds {barred}: the benchmark runs the port "
              "alone", file=sys.stderr)
        return 1
    for name, value, limit in res["checks"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    line = result_line(res, torch.cuda.get_device_name(device), cell.chips)
    print(json.dumps(line), flush=True)
    return 0


def environment() -> None:
    """The checkout and the port's sources, not this directory, lead the
    path; no library loads JAX; the build caches stay in the checkout."""
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var, name in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                      ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "bench-cache" / name)


if __name__ == "__main__":
    environment()
    sys.exit(main())
