"""Time a kernel on the card: this tree against another.

    python src/repro_torch/kernels/launch_ab.py --base DIR [--kernel axpy|atax]

``DIR`` is the root of a checkout of another commit (``git archive`` of it
unpacked under ``build/``, say).  The script runs four processes in the
order base, this tree, this tree, base; each builds its tree's kernels and
times that tree's wrapper on fp64 inputs.  ``--kernel axpy`` (the default)
times ``repro_torch.kernels.axpy.axpy`` at the offload path's n = 32 shard
(32, 32768) and at 2^24 elements; ``--kernel atax`` times
``repro_torch.kernels.atax.atax`` at the n = 32 shard (32, 128, 4096) and
at 8192², each result first held to ``ref.atax`` at 1e-9:

  * call ms: CUDA events around each single call (the card idles between
    calls, so the host's launch path is on the clock), median of ``REPS``;
  * device ms: events around back-to-back calls queued behind a sleep
    kernel, over input sets rotated past the 50 MB L2, over their count
    (median of ``DEVICE_ROUNDS``);
  * host µs: the host's time a call over ``HOST_CALLS`` calls, at the shard
    only, where the card keeps up (median of ``DEVICE_ROUNDS``).

``torch.add(y, x, alpha=2.5)`` (for atax: the two calls ``torch.bmm``
twice, ``torch.mv`` twice at 8192²) is timed the same way in each process,
as the yardstick of that process's host speed.  For atax, this tree's
processes also time the kernel under every (rows, stages) pair of
``atax.SHAPES`` at the shard, each with the row groups that fill the
card's wave for it (the route column names the pair, the groups and the
card's count of clusters), the sweep that ``atax.ROW_WEIGHT`` is fitted
to.  For axpy, in this tree's processes the
wrapper is also timed with ``build.launch`` swapped for two other routes to
the same C entry point: ``private`` reads the device and the raw stream
from ``torch._C`` (no ``Stream`` object a call), ``parent`` is the older
wrapper's path (a ``torch.cuda.device`` context on every call and the
stream through ``torch.cuda.current_stream``).  Each result is checked
against ``torch.add`` before it is timed.  The table is printed and written
to ``chiprun_out/launch_ab.json`` (``launch_ab_atax.json`` for atax).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
SHAPES = {"shard (32, 32768)": (32, 32768), "2^24": (1 << 24,)}
ATAX_SHAPES = {"shard (32, 128, 4096)": (32, 128, 4096),
               "8192^2": (8192, 8192)}
ALPHA = 2.5
REPS = 200
DEVICE_CALLS = 40
DEVICE_ROUNDS = 5
HOST_CALLS = 500
#: host µs only where the card keeps up with the host (the shard)
HOST_MAX = 1 << 21
ROTATE_BYTES = 200e6
SLEEP_CYCLES_PER_CALL = 200_000


def _routes(torch, b):
    """Other routes from the wrapper to the C entry point (same checks)."""

    def private(kernel, name, t, *args):
        fn = b.entry(name)
        index = t.get_device()
        stream = torch._C._cuda_getCurrentRawStream(index)
        if index == torch._C._cuda_getDevice():
            rc = fn(*args, stream)
        else:
            with torch.cuda.device(index):
                rc = fn(*args, stream)
        b.check_rc(rc, kernel)

    def parent(kernel, name, t, *args):
        with torch.cuda.device(t.device):
            rc = getattr(b.library(), name)(
                *args, torch.cuda.current_stream(t.device).cuda_stream)
        b.check_rc(rc, kernel)

    return {"private": private, "parent": parent}


def _time(torch, fn, sets, host_too):
    """call ms, device ms and (with ``host_too``) host µs of ``fn`` on
    the input ``sets`` (pairs)."""
    x, y = sets[0]
    for _ in range(3):
        fn(x, y)
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    for start, end in ev:
        start.record()
        fn(x, y)
        end.record()
    torch.cuda.synchronize()
    call = statistics.median(s.elapsed_time(e) for s, e in ev)

    calls = max(DEVICE_CALLS, 2 * len(sets))
    device = []
    for _ in range(DEVICE_ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * calls)
        start.record()
        for i in range(calls):
            fn(*sets[i % len(sets)])
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end) / calls)

    host = []
    for _ in range(DEVICE_ROUNDS if host_too else 0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn(x, y)
        host.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return {"call_ms": call, "device_ms": statistics.median(device),
            "host_us": statistics.median(host) if host else None}


def worker(src: str, tree: str) -> dict:
    sys.path[:] = [src] + [p for p in sys.path[1:]]
    import torch
    from repro_torch.kernels import axpy as ax
    from repro_torch.kernels import build as b

    b.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    routes = {"as is": None}
    if hasattr(b, "entry"):
        routes.update(_routes(torch, b))
    out = {"tree": tree, "rows": []}
    for label, shape in SHAPES.items():
        x, y = (torch.randn(shape, generator=gen, device="cuda",
                            dtype=torch.float64) for _ in range(2))
        copies = max(0, int(-(-ROTATE_BYTES // (2 * x.nbytes))) - 1)
        sets = [(x, y)] + [(x.clone(), y.clone()) for _ in range(copies)]
        want = torch.add(y, x, alpha=ALPHA)
        host_too = x.numel() <= HOST_MAX
        for route, fn in routes.items():
            saved = b.launch if fn else None
            if fn:
                b.launch = fn
            try:
                got = ax.axpy(x, y, ALPHA)
                torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
                row = _time(torch, lambda u, v: ax.axpy(u, v, ALPHA), sets,
                            host_too)
            finally:
                if fn:
                    b.launch = saved
            out["rows"].append({"shape": label, "fn": "axpy", "route": route,
                                **row})
        row = _time(torch, lambda u, v: torch.add(v, u, alpha=ALPHA), sets,
                    host_too)
        out["rows"].append({"shape": label, "fn": "torch.add",
                            "route": "-", **row})
        del sets, x, y, want
        torch.cuda.empty_cache()
    return out


def _atax_shapes(torch, at, ref, a, x, sets, label):
    """The kernel under each (rows, stages) pair of ``at.SHAPES``: the plan
    is made with the card's cluster count for that pair only, and swapped
    in for ``at.card_plan`` while it is timed."""
    batch, m, n = a.shape
    index = a.get_device()
    rows = []
    saved = at.card_plan
    for pair in at.SHAPES:
        def clusters(c, r, st, t, ch, pair=pair):
            return (at._card_clusters(index, a.dtype, n, c, r, st, t, ch)
                    if (r, st) == pair else 0)
        forced = at.plan(batch, m, n, a.dtype, at._sms(index), clusters)
        at.card_plan = lambda *args, p=forced: p
        try:
            torch.testing.assert_close(at.atax(a, x), ref.atax(a, x),
                                       rtol=1e-9, atol=1e-9)
            row = _time(torch, at.atax, sets, False)
        finally:
            at.card_plan = saved
        rows.append({"shape": label, "fn": "atax",
                     "route": f"R{forced.rows} st{forced.stages} "
                              f"G{forced.groups} wave {forced.wave}", **row})
    return rows


def worker_atax(src: str, tree: str) -> dict:
    sys.path[:] = [src] + [p for p in sys.path[1:]]
    import torch
    from repro_torch.kernels import atax as at
    from repro_torch.kernels import build as b
    from repro_torch.kernels import ref

    b.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"tree": tree, "rows": []}
    for label, shape in ATAX_SHAPES.items():
        a = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.float64)
        x = torch.randn(shape[:-2] + shape[-1:], generator=gen, device="cuda",
                        dtype=torch.float64)
        copies = max(0, int(-(-ROTATE_BYTES // a.nbytes)) - 1)
        sets = [(a, x)] + [(a.clone(), x.clone()) for _ in range(copies)]
        torch.testing.assert_close(at.atax(a, x), ref.atax(a, x), rtol=1e-9,
                                   atol=1e-9)
        if a.ndim == 2:
            def two(u, v):
                return torch.mv(u.T, torch.mv(u, v))
        else:
            def two(u, v):
                return torch.bmm(u.mT, torch.bmm(u, v.unsqueeze(-1)))
        for fn, name in ((at.atax, "atax"), (two, "two calls")):
            out["rows"].append({"shape": label, "fn": name, "route": "-",
                                **_time(torch, fn, sets, False)})
        if hasattr(at, "SHAPES") and a.ndim == 3:
            out["rows"] += _atax_shapes(torch, at, ref, a, x, sets, label)
        del sets, a, x
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="root of the checkout to compare with")
    ap.add_argument("--kernel", choices=("axpy", "atax"), default="axpy")
    ap.add_argument("--worker", nargs=2, metavar=("SRC", "TREE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        run = worker_atax if args.kernel == "atax" else worker
        print(json.dumps(run(*args.worker)))
        return 0
    if not args.base:
        ap.error("--base is required")
    import torch
    if not torch.cuda.is_available():
        print("launch_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    trees = {"base": str(Path(args.base).resolve() / "src"),
             "this": str(ROOT / "src")}
    runs = []
    for tree in ("base", "this", "this", "base"):
        proc = subprocess.run(
            [sys.executable, __file__, "--kernel", args.kernel, "--worker",
             trees[tree], tree],
            capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": trees[tree]})
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(f"{'tree':5} {'shape':22} {'fn':9} {'route':20} "
          f"{'call ms':>9} {'device ms':>10} {'host us':>8}")
    for run in runs:
        for r in run["rows"]:
            print(f"{run['tree']:5} {r['shape']:22} {r['fn']:9} "
                  f"{r['route']:20} {r['call_ms']:9.4f} {r['device_ms']:10.4f} "
                  f"{r['host_us'] or float('nan'):8.2f}")
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    name = "launch_ab.json" if args.kernel == "axpy" else "launch_ab_atax.json"
    (dest / name).write_text(json.dumps(
        {"card": card.strip(), "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
