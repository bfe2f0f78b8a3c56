"""Rehearse a cell on the CPU, at the sizes the ``rehearsal`` entries of
its configuration and mix give: the same drivers, reference and checks as
``bench/run.py``, the program's plain paths in place of its kernels.

    python3 bench/rehearse.py --workload <cell> [--seed 1] [--seconds 2] [--trace 0]

It prints the result as ``bench/run.py`` would, its device the CPU.  None
of its numbers is a measurement of the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench import run
    from bench.spec import load_cell

    cell = load_cell(args.workload, rehearsal=True)
    res = run.run(cell, args.seed, args.seconds, bool(args.trace),
                  torch.device("cpu"), t_start=T_START)
    line = run.result_line(res, "cpu rehearsal", 0)
    line["device"]["platform"] = "cpu"
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
