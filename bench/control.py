"""Read the numbers that set a cell's limits: the program's (the lower
reading) and those of the control and the faults (the upper reading), on
the card at the cell's own size, seed by seed in one process.

    python3 bench/control.py --workload <cell> --seeds 1 2 3 [--seconds 10]

What is read is the cell's driver's (``limit_readings``): for ``train``,
the reference put in the program's place, computed in fp8 (the control)
and over half of each batch (a fault), each against the float32
reference, beside the program's first steps; for ``batch_generate``, a
short window at the cell's load, then the gap of each served token and of
the token the fp8 reference puts first.  One JSON line a seed.  The benchmark's runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, seconds: float, device) -> dict:
    """The readings of the cell's driver (``limit_readings``) on one seed."""
    from bench import drivers

    out = drivers.load(cell.mix["driver"])(cell, seed, device
                                           ).limit_readings(seconds)
    drivers.free_device()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rehearsal", action="store_true",
                    help="the rehearsal sizes on the CPU")
    args = ap.parse_args(argv)
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench.spec import load_cell

    cell = load_cell(args.workload, rehearsal=args.rehearsal)
    device = torch.device("cpu" if args.rehearsal else "cuda")
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(cell, seed, args.seconds, device)
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
