#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--out DIR]

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``).  Without a card, or without the rest of the
repository beside it, it exits non-zero and prints no result.  It imports
no JAX and nothing of the reference package.

1. Header: the card's name and power limit, and the kernels' build from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel).
2. Kernels: every hand-written kernel against its plain PyTorch version on
   the card — at float64 at every shape the offload phase gives it, in
   float32/bfloat16 over ``tests/test_kernels.py``'s sweeps with that
   file's tolerances, and timed (CUDA events, median of 30 calls after
   warm-up) beside its plain version, one PyTorch library call where one
   computes the same function, and its bound at the offload phase's largest
   shapes and at one large standalone shape each.
3. Offload (the main path): ``OffloadRuntime`` on the card for all six
   jobs × {baseline, extended} × n ∈ {1, 8, 32}, at each job's default
   size and at a larger one; results against ``make_instance``'s expected
   values at rtol=atol=1e-9, the launch trace's collective structure, cold
   / warm / resident per-dispatch wall times and the plan counters; one
   fused dispatch (B=8) per job and one tree staging at n=32.  The kernels'
   launch counts are zeroed just before this phase and read just after.
4. The ``kernels:`` line with those counts, one JSON line of the kernels'
   numbers, the card line, and last ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero without the last line.  Everything
measured is also written to ``DIR/chip_smoke.json`` (default
``chiprun_out/`` beside this file).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
#: peak operations per second by element type (H100 SXM data sheet; the
#: float64 figure is the tensor-core rate, the float32 one outside them)
PEAK_OPS_PER_S = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12}
JOB_TOL = dict(rtol=1e-9, atol=1e-9)   # tests/test_offload_runtime.py:17
REPS = 30
#: the offload phase's sizes: each job's default and one larger size
OFFLOAD_SIZES = {
    "axpy": ((), (1 << 20,)),
    "montecarlo": ((), (1 << 20,)),
    "matmul": ((), (1024, 1024, 1024)),
    "atax": ((), (4096, 4096)),
    "covariance": ((), (1024, 2048)),
    "bfs": ((), (1024,)),
}
#: one large standalone shape per kernel (its inputs' shapes)
LARGE_SHAPES = {
    "axpy": ((1 << 24,), (1 << 24,)),
    "matmul": ((4096, 4096), (4096, 4096)),
    "atax": ((8192, 8192), (8192,)),
    "covariance": ((2048, 4096),),
}
NS = (1, 8, 32)
FUSE = 8
KERNEL_JOBS = ("axpy", "matmul", "atax", "covariance")


class Checks:
    """Collects failed checks; the run fails at the end if any did."""

    def __init__(self):
        self.failed = []

    def __call__(self, ok, what):
        if not ok:
            self.failed.append(what)
            print(f"FAILED: {what}", flush=True)
        return ok


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"),
                   help="directory for chip_smoke.json and the ptxas report")
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one H100",
              file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch import convert
    from repro_torch.core import jobs
    from repro_torch.core.offload import (
        OffloadConfig, OffloadRuntime, count_collectives,
    )
    from repro_torch.core.policy import Residency, Staging
    from repro_torch.kernels import build, ops, ref

    # plain float32 products in full float32, as the kernels compute them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    check = Checks()
    report = {"kernel_checks": [], "kernel_times": [], "offload": [],
              "fused": [], "tree": []}

    # -- 1. header ----------------------------------------------------------
    card = nvidia_smi("name,power.limit")
    print(f"card: {card}  (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")
    print(f"clocks/power at start: "
          f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    built = build.build(verbose=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "ptxas.txt"), "w") as f:
        f.write(built.ptxas)
    print(f"kernel build: {built.seconds:.1f} s ({built.path.name}, "
          f"built={built.built})", flush=True)
    report["card"], report["build_s"] = card, built.seconds

    # -- 2. kernels against their plain versions -----------------------------
    def work(name, shapes, dtype):
        """(bytes, operations) the function needs: each input read once,
        each output written once."""
        s = torch.empty((), dtype=dtype).element_size()
        if name == "axpy":
            n = int(np.prod(shapes[0]))
            return 3 * n * s, 2 * n
        if name == "matmul":
            *lead, m, k = shapes[0]
            n = shapes[1][-1]
            b = int(np.prod(lead))
            return b * (m * k + k * n + m * n) * s, 2 * b * m * n * k
        if name == "atax":
            *lead, m, n = shapes[0]
            b = int(np.prod(lead))
            return b * (m * n + 2 * n) * s, 4 * b * m * n
        *lead, m, n = shapes[0]      # covariance: mean, centring, SYRK
        b = int(np.prod(lead))
        return b * (m * n + m * m) * s, b * (m * (m + 1) * n + 2 * m * n)

    def bound(name, tensors, dtype):
        nbytes, nops = work(name, [tuple(t.shape) for t in tensors], dtype)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / PEAK_OPS_PER_S[str(dtype).split(".")[1]] * 1e3
        return ((t_bytes, "bytes") if t_bytes >= t_ops
                else (t_ops, "operations"))

    def time_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
        for start, end in ev:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)

    def call(name, tensors, impl):
        fn = getattr(ops, name) if impl == "kernel" else getattr(ref, name)
        kw = {"impl": "kernel"} if impl == "kernel" else {}
        if name == "axpy":
            return fn(tensors[0], tensors[1], 2.5, **kw)
        return fn(*tensors, **kw)

    def library(name, tensors):
        """One PyTorch call computing the same function, where one exists
        for these shapes (timed as a yardstick only)."""
        if name == "axpy":
            x, y = tensors
            return lambda: torch.add(y, x, alpha=2.5)
        if name == "matmul":
            return lambda: torch.matmul(*tensors)
        if tensors[0].ndim != 2:
            return None          # no single batched call for these two
        if name == "atax":       # two calls: A^T (A x)
            a, x = tensors
            return lambda: torch.mv(a.T, torch.mv(a, x))
        return lambda: torch.cov(tensors[0])

    def compare(name, tensors, tol, tag):
        got = call(name, tensors, "kernel")
        want = call(name, tensors, "plain")
        torch.cuda.synchronize()
        g, w = got.double(), want.double()
        err = (g - w).abs().max().item() if g.numel() else 0.0
        ok = (got.shape == want.shape and got.dtype == want.dtype
              and bool(((g - w).abs() <= tol["atol"]
                        + tol["rtol"] * w.abs()).all()))
        if name == "covariance":
            ok = ok and bool(((g - g.mT).abs() <= 1e-5
                              + 1e-5 * g.abs()).all())
        row = {"kernel": name, "tag": tag, "dtype": str(got.dtype),
               "shapes": [list(t.shape) for t in tensors],
               "max_abs_err": err, "tol": tol, "ok": ok}
        report["kernel_checks"].append(row)
        check(ok, f"{name} {tag} {row['shapes']} {got.dtype}: kernel vs "
                  f"plain max_abs_err {err:.3g} outside {tol}")
        return err

    def timed(name, tensors, tag):
        dtype = tensors[0].dtype
        row = {"kernel": name, "tag": tag, "dtype": str(dtype),
               "shapes": [list(t.shape) for t in tensors],
               "ms": time_ms(lambda: call(name, tensors, "kernel")),
               "plain_ms": time_ms(lambda: call(name, tensors, "plain"))}
        lib = library(name, tensors)
        row["library_ms"] = time_ms(lib) if lib is not None else None
        row["bound_ms"], row["bound_by"] = bound(name, tensors, dtype)
        report["kernel_times"].append(row)
        lib_s = ("-" if row["library_ms"] is None
                 else f"{row['library_ms']:.4f}")
        print(f"  time {name:10s} {tag:22s} {str(dtype):14s} "
              f"{row['shapes']}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {lib_s} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
        return row

    def job_shapes(name, size, n, fuse=None):
        """The cluster-major float64 operands phase F hands the kernel."""
        job = jobs.PAPER_JOBS[name](*size)
        if fuse is None:
            host, _ = job.make_instance(0)
        else:
            host = jobs.stack_instances(jobs.make_instances(job, fuse)[0])
        staged = convert.operands_to_clusters(
            host, job, list(range(n)), dev, lead=0 if fuse is None else 1)
        order = {"axpy": ("x", "y"), "matmul": ("A", "B"),
                 "atax": ("A", "x"), "covariance": ("data",)}[name]
        return [staged[k] for k in order]

    print("== kernels: float64 at the offload phase's shapes", flush=True)
    main_rows = {}
    for name in KERNEL_JOBS:
        for size in OFFLOAD_SIZES[name]:
            for n in NS:
                job = jobs.PAPER_JOBS[name](*size)
                if any(ax is not None and job.make_instance(0)[0][k].shape[ax] % n
                       for k, ax in job.shard_axes.items()):
                    continue          # not a shape the offload phase runs
                tensors = job_shapes(name, size, n)
                err = compare(name, tensors, JOB_TOL,
                              f"job {size or 'default'} n={n}")
                print(f"  {name:10s} size={size or 'default'} n={n:2d} "
                      f"{[list(t.shape) for t in tensors]}: max_abs_err "
                      f"{err:.3g}", flush=True)
        tensors = job_shapes(name, (), 8, fuse=FUSE)
        compare(name, tensors, JOB_TOL, f"job default n=8 B={FUSE}")
        # the largest shape of the offload phase: the JSON line's numbers
        tensors = job_shapes(name, OFFLOAD_SIZES[name][1], 32)
        row = timed(name, tensors, "job large n=32")
        row["max_abs_err"] = compare(name, tensors, JOB_TOL,
                                     "job large n=32")
        main_rows[name] = row
        del tensors
    torch.cuda.empty_cache()

    print("== kernels: float32/bfloat16 sweeps (tests/test_kernels.py)",
          flush=True)
    rng = np.random.default_rng(42)

    def rnd(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype).to(dev)

    f32, bf16 = torch.float32, torch.bfloat16
    elem_tol = {f32: dict(rtol=2e-4, atol=2e-4),
                bf16: dict(rtol=3e-2, atol=3e-2)}            # :14-16
    mm_tol = {f32: dict(rtol=1e-3, atol=1e-2),
              bf16: dict(rtol=5e-2, atol=5e-1)}              # :43-44
    for dt in (f32, bf16):
        for n in (64, 100, 1024, 4096, 5000):
            compare("axpy", [rnd(n, dt), rnd(n, dt)], elem_tol[dt], "sweep")
        for m, k, n in ((128, 128, 128), (256, 384, 128), (100, 70, 36),
                        (17, 300, 129), (512, 64, 512)):
            compare("matmul", [rnd((m, k), dt), rnd((k, n), dt)], mm_tol[dt],
                    "sweep")
    for m, n in ((256, 128), (100, 64), (512, 256), (33, 100)):
        compare("atax", [rnd((m, n), f32), rnd(n, f32)],
                dict(rtol=2e-3, atol=2e-3), "sweep")                # :63
    for m, n in ((32, 64), (128, 256), (100, 50), (8, 2)):
        compare("covariance", [rnd((m, n), f32)],
                dict(rtol=1e-4, atol=1e-4), "sweep")                # :73-75
    n_sweep = sum(r["tag"] == "sweep" for r in report["kernel_checks"])
    print(f"  {n_sweep} sweep comparisons done", flush=True)

    print("== kernels: one large shape each", flush=True)
    # test_kernels.py's tolerances, except atax and bfloat16 covariance.
    # atax outputs reach ~1e4 here (A^T A x over 8192 rows), so f32 sums
    # taken in another order differ by ~0.1: atol 1.0 is 1e-4 of their
    # scale.  Both kernels and their plain versions accumulate bfloat16 in
    # f32 and round once, so bfloat16 is held to about one ulp (rtol 1e-2);
    # covariance's off-diagonal values are ~0.016 at 2048x4096, so its
    # atol stays well below them
    large_tol = {"axpy": elem_tol, "matmul": mm_tol,
                 "atax": {f32: dict(rtol=2e-3, atol=1.0),
                          bf16: dict(rtol=1e-2, atol=1.0)},
                 "covariance": {f32: dict(rtol=1e-4, atol=1e-4),
                                bf16: dict(rtol=1e-2, atol=2e-3)}}
    for name, shapes in LARGE_SHAPES.items():
        for dt in (torch.float64, f32, bf16):
            tensors = [rnd(shape, dt) for shape in shapes]
            tol = JOB_TOL if dt == torch.float64 else large_tol[name][dt]
            timed(name, tensors, "large")
            compare(name, tensors, tol, "large")
            del tensors
    torch.cuda.empty_cache()
    print(f"clocks/power after kernel timing: "
          f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}",
          flush=True)

    # -- 3. the main path: the offload runtime on the card -------------------
    print("== offload: six jobs x {baseline, extended} x n in "
          f"{NS}", flush=True)
    build.reset_counts()
    configs = {"baseline": OffloadConfig.baseline(),
               "extended": OffloadConfig.extended()}

    def dispatch(rt, job, operands, **sel):
        t0 = time.perf_counter()
        got = rt.offload(job, operands, **sel).wait()
        return got, (time.perf_counter() - t0) * 1e3

    def structure_ok(cname, counts, n):
        if cname == "baseline":
            return counts["collective-permute"] == 2 * (n - 1)
        return (counts["collective-permute"] == 0
                and counts["all-reduce"] <= 2)

    for cname, cfg in configs.items():
        rt = OffloadRuntime(config=cfg)
        check(rt.num_clusters == 32 and rt.device.type == "cuda",
              "runtime defaults: 32 clusters on the card")
        for name in jobs.PAPER_JOBS:
            for size in OFFLOAD_SIZES[name]:
                job = jobs.PAPER_JOBS[name](*size)
                operands, expected = job.make_instance(1)
                for n in NS:
                    tag = f"{cname:8s} {job.spec.name:28s} n={n:2d}"
                    try:
                        got, cold = dispatch(rt, job, operands, n=n)
                    except ValueError as e:
                        # the reference raises the same divisibility error
                        ok = "not divisible" in str(e)
                        check(ok, f"{tag}: {e}")
                        print(f"  {tag}: {e} (as in the reference)")
                        report["offload"].append(
                            {"config": cname, "job": job.spec.name, "n": n,
                             "skipped": str(e)})
                        continue
                    plan = rt.plan(job, n=n)
                    counts = count_collectives(plan.fn.trace)
                    warm = [dispatch(rt, job, operands, n=n) for _ in range(5)]
                    res = [dispatch(rt, job, Residency.RESIDENT, n=n)
                           for _ in range(5)]
                    match = all(np.allclose(r, expected, **JOB_TOL)
                                for r in [got] + [w[0] for w in warm + res])
                    err = float(np.max(np.abs(got - expected)))
                    check(match, f"{tag}: result off by {err:.3g}")
                    check(structure_ok(cname, counts, n),
                          f"{tag}: launch trace {counts}")
                    row = {"config": cname, "job": job.spec.name, "n": n,
                           "max_abs_err": err, "ok": match,
                           "cold_ms": cold,
                           "warm_ms": statistics.median(w[1] for w in warm),
                           "resident_ms": statistics.median(
                               r[1] for r in res),
                           "collectives": {k: v for k, v in counts.items()
                                           if v},
                           "stats": {k: v for k, v in
                                     vars(plan.stats).items() if v}}
                    report["offload"].append(row)
                    print(f"  {tag}: err {err:.2g}  cold {cold:.3f} ms, warm "
                          f"{row['warm_ms']:.3f} ms, resident "
                          f"{row['resident_ms']:.3f} ms  "
                          f"{row['collectives']}  {row['stats']}",
                          flush=True)
        del rt
        torch.cuda.empty_cache()

    print(f"== offload: fused dispatch, B={FUSE}, n=8", flush=True)
    for cname, cfg in configs.items():
        rt = OffloadRuntime(config=cfg)
        for name in jobs.PAPER_JOBS:
            job = jobs.PAPER_JOBS[name]()
            insts, exps = jobs.make_instances(job, FUSE, seed0=10)
            t0 = time.perf_counter()
            outs = rt._offload_fused(job, insts, n=8).wait_each()
            ms = (time.perf_counter() - t0) * 1e3
            ok = all(np.allclose(o, e, **JOB_TOL) for o, e in zip(outs, exps))
            counts = count_collectives(rt.plan(job, n=8, fuse=FUSE,
                                               args_shape=(FUSE, 8)).fn.trace)
            check(ok, f"fused {cname} {name}: results")
            check(structure_ok(cname, counts, 8),
                  f"fused {cname} {name}: launch trace {counts}")
            report["fused"].append({"config": cname, "job": job.spec.name,
                                    "batch": FUSE, "ok": ok, "ms": ms})
            print(f"  {cname:8s} {job.spec.name:28s} B={FUSE}: ok={ok} "
                  f"{ms:.3f} ms for {FUSE} jobs", flush=True)

    print("== offload: tree staging at n=32", flush=True)
    job = jobs.make_covariance(*OFFLOAD_SIZES["covariance"][1])
    operands, expected = job.make_instance(2)
    size, args_bytes = operands["data"].nbytes, 8 * 8
    for staging in (Staging.DIRECT, Staging.TREE):
        rt = OffloadRuntime(config=OffloadConfig(staging=staging))
        got, cold = dispatch(rt, job, operands, n=32)
        warm = statistics.median(dispatch(rt, job, operands, n=32)[1]
                                 for _ in range(5))
        st = rt.stats
        ok = bool(np.allclose(got, expected, **JOB_TOL))
        if staging is Staging.TREE:
            # six operand stagings, the job args once (cached after)
            ok = ok and (st.h2d_bytes == 6 * size + args_bytes
                         and st.d2d_bytes == (6 * size + args_bytes) * 31
                         and st.tree_stages == 7)
        check(ok, f"tree staging {staging.value}: {vars(st)}")
        report["tree"].append({"staging": staging.value, "ok": ok,
                               "cold_ms": cold, "warm_ms": warm,
                               "h2d_bytes": st.h2d_bytes,
                               "d2d_bytes": st.d2d_bytes})
        print(f"  {job.spec.name} n=32 {staging.value:6s}: cold {cold:.3f} "
              f"ms, warm {warm:.3f} ms, h2d {st.h2d_bytes} B, d2d "
              f"{st.d2d_bytes} B over 6 dispatches", flush=True)
        del rt
    torch.cuda.synchronize()
    launches = build.launch_counts()

    # -- 3b. where a dispatch's time goes (after the counts were read) --------
    print("== profile: device busy share of dispatches (torch.profiler)",
          flush=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(prof):
        """(total device µs, top device ops) of a profile."""
        rows = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            rows.append((us, e.key, e.count))
        rows.sort(reverse=True)
        return sum(r[0] for r in rows), rows[:4]

    for cname, cfg in configs.items():
        rt = OffloadRuntime(config=cfg)
        for name, size, n, mode in (("axpy", (), 1, "resident"),
                                    ("axpy", (), 32, "resident"),
                                    ("covariance", OFFLOAD_SIZES[
                                        "covariance"][1], 32, "resident"),
                                    ("covariance", OFFLOAD_SIZES[
                                        "covariance"][1], 32, "warm")):
            job = jobs.PAPER_JOBS[name](*size)
            operands, _ = job.make_instance(1)
            dispatch(rt, job, operands, n=n)
            reps = 20 if mode == "resident" else 3
            src = Residency.RESIDENT if mode == "resident" else operands
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    dispatch(rt, job, src, n=n)
                wall_us = (time.perf_counter() - t0) * 1e6 / reps
            busy, top = device_us(prof)
            busy /= reps
            row = {"config": cname, "job": job.spec.name, "n": n,
                   "mode": mode, "wall_us_profiled": wall_us,
                   "device_us": busy,
                   "busy_share": busy / wall_us if busy else None,
                   "top": [(k, us / reps, c // reps) for us, k, c in top]}
            report.setdefault("profile", []).append(row)
            share = ("not measured (no device time in the trace)"
                     if not busy else f"{busy / wall_us:.3f}")
            print(f"  {cname:8s} {job.spec.name:24s} n={n:2d} {mode:8s}: "
                  f"wall {wall_us:.1f} us (profiled), device {busy:.1f} us, "
                  f"busy share {share}; top "
                  + "; ".join(f"{k[:40]} {us:.1f} us x{c}"
                              for k, us, c in row["top"]), flush=True)
        del rt
    torch.cuda.empty_cache()

    # -- 4. what the main path launched, and the result lines ----------------
    print("kernels: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    for name in KERNEL_JOBS:
        check(launches[name] > 0,
              f"the offload phase never launched the {name} kernel")
    line = []
    for name in KERNEL_JOBS:
        k, row = build.KERNELS[name], main_rows[name]
        line.append({"name": name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": launches[name],
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"],
                     "shapes": row["shapes"], "dtype": row["dtype"]})
    report["kernels"] = line
    report["failed"] = check.failed
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    if check.failed:
        print(f"chip_smoke: {len(check.failed)} check(s) failed",
              file=sys.stderr)
        for what in check.failed:
            print(f"  {what}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
