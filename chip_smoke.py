#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--out DIR]

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``).  Without a card, or without the rest of the
repository beside it, it exits non-zero and prints no result.  It imports
no JAX and nothing of the reference package.

1. Header: the card's name and power limit, the kernels' build from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel),
   and a census of the built code's SASS (``cuobjdump -sass``: HGMMA,
   HMMA, DMMA, UTMALDG, LDGSTS and UBLKCP by kernel, to
   ``DIR/sass_census.json``); the bf16 flash kernel must hold a
   tensor-core product, the fp64 matmul and covariance DMMA, atax the bulk
   copy (UBLKCP).
2. Kernels: every hand-written kernel against its plain PyTorch version on
   the card — at float64 at every shape the offload phase gives it, in
   float32/bfloat16 over ``tests/test_kernels.py``'s sweeps with that
   file's tolerances, the fp64 covariance SYRK's hard cases (ragged M and
   N, data offset by +1e3, a view off a 16-byte boundary; exactly
   symmetric), axpy's (ragged lengths, x, y and z at different offsets
   from a 16-byte boundary) and atax's (ragged M and N in fp64, f32 and
   bf16, batch 1 and 3, A and x off a 16-byte boundary; one launch each)
   — and timed beside its plain version, one PyTorch library call where
   one computes the same function (atax: two calls, ``torch.mv`` or
   ``torch.bmm`` twice), and its bound at the offload phase's largest
   shapes (fp64 matmul and atax also at the n = 1 and 8 shards) and at one
   large standalone shape each; atax prints its launch plan and the
   card's ``cudaOccupancyMaxActiveClusters`` for it, and must give the
   same bits from two calls at every timed shape.  Two times
   each: "call ms", CUDA events around each single call (median of 30
   after warm-up), which holds the host's launch path; and "device ms",
   events around a run of back-to-back calls queued behind a sleep kernel
   (so the host is off the clock), over inputs rotated through more bytes
   than the 50 MB L2, per call.
3. Offload (the main path): ``OffloadRuntime`` on the card for all six
   jobs × {baseline, extended} × n ∈ {1, 8, 32}, at each job's default
   size and at a larger one; results against ``make_instance``'s expected
   values at rtol=atol=1e-9, the launch trace's collective structure, cold
   / warm / resident per-dispatch wall times and the plan counters; one
   fused dispatch (B=8) per job and one tree staging at n=32.  The kernels'
   launch counts are zeroed just before this phase and read just after.
   Then the session layer (``session_phase``), the perf linter
   (``lint_phase``: ``Session(lint=True)``, one submission per OFLP1##
   code, each fix run against its original, the model's cycles beside the
   card's ms) and ``BackupOffload`` (``backup_phase``: primary clusters
   0-15, backup 16-31, one forced reissue).
4. Flash attention: the hand-written kernel against ``ref.attention`` over
   ``tests/test_kernels.py``'s flash sweep (f32 at 2e-3), GQA, Sq < Skv,
   causal Sq > Skv (whose rows with no visible column must give the mean
   of V), head dims 32, 64, 80 and 128, Skv = 1, in f32 and bf16 (at 1e-2,
   about one bf16 ulp of unit-scale outputs); then at the serving phase's
   prefill shape and at one shape bound by operations (2048 tokens),
   timed beside its plain version, ``scaled_dot_product_attention`` (with
   its own distance to ``ref.attention``, the noise floor) and its
   bound.
5. Serving (the second main path): ``ServeEngine`` on the card with
   Yi-9B at its published width (48 layers, d 4096, 32/4 heads, head dim
   128; float32 weights drawn from a seeded generator, bf16 compute).
   ``generate`` for 4 prompts of 512 tokens and 32 new tokens in the
   ``step``, ``chunk`` and ``host`` modes (identical greedy tokens), then
   ``generate_many`` for 8 requests of 64-1024 tokens at 0.5 arrivals per
   step.  The launch counts are zeroed just before and read just after:
   every prefill must run the flash kernel once per layer.  Then the
   prefill logits with the kernel against the plain attention, and the
   prefill / decode / continuous times.  Then the serve tenant
   (``tenant_phase``): a ``ServeTenant`` on a ``FabricScheduler`` of 32
   logical clusters adopts the same model (floor 1, burst 8), serves the
   same prompts in two bursts around an offload ``Session`` on the
   head-room and a failover of its floor window; both bursts' tokens must
   be the ``step`` mode's, and the peak memory shows one copy of the
   weights.
6. SSM scan: the hand-written kernel against ``ref.ssm_scan`` over
   ``tests/test_kernels.py``'s scan sweep (f32 at 2e-4), S = 1, N = 32 and
   64, a D that leaves a channel group short, a given ``h0`` with the
   final state returned, and bf16 (at 1e-2, about one bf16 ulp); then at
   the prefill chunk of falcon-mamba-7b (4 × 256 tokens, D 8192, N 16,
   f32), timed beside its plain version and its bound.
7. Serving falcon-mamba-7b (the third main path): ``ServeEngine`` on the
   card at its published width and depth (64 Mamba-1 layers, d 4096,
   d_inner 8192, N 16; float32 weights drawn from a seeded generator,
   bf16 compute).  ``generate`` for 4 prompts of 512 tokens and 32 new
   tokens in the ``step``, ``chunk`` and ``host`` modes (identical greedy
   tokens); ``generate_many`` raises, as the reference's does.  The launch
   counts are zeroed just before and read just after: every prefill must
   run the scan kernel once per chunk of every layer.  Then the prefill
   logits with the kernel against the plain scan, and the prefill / decode
   times, peak memory and busy shares.
8. The ``kernels:`` line with the counts, one JSON line of the kernels'
   numbers, the card line, and last ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero without the last line.  Everything
measured is also written to ``DIR/chip_smoke.json`` (default
``chiprun_out/`` beside this file).
"""

from __future__ import annotations

import argparse
import dataclasses
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
#: the serving phase: Yi-9B at its published width
SERVE_ARCH = "yi-9b"
SERVE_STATIC = dict(batch=4, prompt_len=512, new_tokens=32, decode_chunk=8)
SERVE_MANY = dict(requests=8, lo=64, hi=1024, new_tokens=32,
                  arrival_rate=0.5, batch=8, max_len=1057)
#: prefill logits, kernel vs plain attention.  In float32 compute the two
#: differ only in the f32 summation order inside attention: elementwise
#: 1e-3 on logits of order 1 (f32 keeps 24 bits).  In bf16 compute (the
#: model's own) that order flips bf16 roundings of the attention output,
#: and 48 layers of a bf16 residual stream carry them on: the bar is 5 %
#: of the logits' L2 norm, and the run prints the same distance for the
#: chunked attention (another f32 order) beside it as the noise floor
PREFILL_TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
               "bfloat16": dict(rel_l2=5e-2)}
#: flash attention against ref.attention: tests/test_kernels.py:78-113
#: in f32; in bf16 both round one f32 result to bf16 once, so about one
#: ulp of unit-scale outputs (2^-7 = 7.8e-3 at [1, 2))
FLASH_TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
             "bfloat16": dict(rtol=1e-2, atol=1e-2)}
#: the instructions each redesigned kernel must hold in its SASS (every
#: instance, by the kernel's name): the bf16 flash kernel a tensor-core
#: product, the fp64 matmul and covariance DMMA, atax the bulk copy
#: (cp.async.bulk) that brings its row panels in
SASS_NEEDS = {"flash_wgmma_kernel": ("HGMMA", "HMMA"),
              "matmul_dmma_kernel": ("DMMA",),
              "cov_dmma_kernel": ("DMMA",),
              "atax_cluster_kernel": ("UBLKCP",)}
#: atax's hard cases (their own generator): M off the 8/4/2-row panels and
#: below one, N giving slices of one chunk, ragged slices and rows whose
#: bytes are not a multiple of 16; batch 1 and 3; fp64 at the job path's
#: 1e-9, f32 at the sweep's 2e-3 (tests/test_kernels.py:63), bf16 at 1e-2
#: (both sides sum in f32 and round to bf16 once: about one ulp)
ATAX_HARD_M = (1, 2, 7, 17, 33, 130)
ATAX_HARD_N = (1, 2, 17, 100, 4097)
#: (batch, M, N) of the views one element off a 16-byte boundary
ATAX_VIEWS = ((3, 33, 100), (1, 130, 4096), (2, 17, 4097))
#: device ms: the inputs of one timed run rotate over at least this many
#: bytes (4x the H100's 50 MB L2), so every call reads them from memory
ROTATE_BYTES = 200e6
#: device ms: back-to-back calls per run, and the sleep (GPU clock cycles a
#: call) queued ahead of them so the host has queued them all before the
#: first starts
DEVICE_CALLS = 20
SLEEP_CYCLES_PER_CALL = 200_000
#: one flash call bound by operations, not bytes: Yi-9B's heads at 2048
#: tokens, causal, bf16 (34.4 GFLOP against 37.7 MB)
FLASH_OPS_SHAPE = ((1, 32, 2048, 128), (1, 4, 2048, 128))
#: the SSM serving phase: falcon-mamba-7b at its published width
SSM_ARCH = "falcon-mamba-7b"
SSM_STATIC = dict(batch=4, prompt_len=512, new_tokens=32, decode_chunk=8)
#: one scan call of its prefill: a chunk of 256 tokens of the 4 prompts,
#: d_inner 8192, d_state 16
SCAN_PREFILL_SHAPE = (4, 256, 8192, 16)
#: the scan kernel against ref.ssm_scan: tests/test_kernels.py:139 in f32
#: (the two sum in another order, and the kernel fuses each step's
#: multiply-add); in bf16 both round one f32 result to bf16 once
SCAN_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
            "bfloat16": dict(rtol=1e-2, atol=1e-2)}
#: the lint phase: alternating passes of each original and fixed submission
#: (after one warm pass each)
LINT_PASSES = 5
#: the serve tenant: its floor lease and burst size, in logical clusters
TENANT = dict(floor=1, burst=8)


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


def rotation(tensors, nbytes):
    """Input sets for a device-ms run: ``tensors`` and copies of them, enough
    that one pass over the sets moves ``ROTATE_BYTES`` (a call moves
    ``nbytes``)."""
    copies = max(0, min(63, -(-int(ROTATE_BYTES) // max(int(nbytes), 1)) - 1))
    return [list(tensors)] + [[t.clone() for t in tensors]
                              for _ in range(copies)]


def device_ms(fn, sets):
    """Device time of one call of ``fn(*inputs)``: CUDA events around
    back-to-back calls over the rotating input ``sets``, divided by their
    count.  A sleep kernel queued first holds the card until the host has
    queued every call, so the host's launch path is off the clock."""
    import torch

    calls = max(DEVICE_CALLS, 2 * len(sets))
    for inputs in sets[:2]:
        fn(*inputs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * calls)
    start.record()
    for i in range(calls):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def flash_work(q_shape, kv_shape, causal, itemsize):
    """(bytes, operations) one attention call needs: q, k and v read once,
    o written once; two products of 2 operations per visible (row,
    column) pair and head dim, counted with this call's causal mask."""
    b, hq, sq, d = q_shape
    hkv, skv = kv_shape[1], kv_shape[2]
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * skv * d) * itemsize
    if causal:
        pairs = sum(min(max(r + skv - sq + 1, 0), skv) for r in range(sq))
    else:
        pairs = sq * skv
    return nbytes, 4 * b * hq * pairs * d


def flash_phase(check, report, time_ms):
    """The flash kernel against ``ref.attention`` on the card, and its
    times at the serving phase's prefill shape.  Returns that shape's row
    of the kernels line."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(43)
    f32, bf16 = torch.float32, torch.bfloat16

    def rnd(shape, dtype):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dtype).to(dev)

    def compare(qs, ks, dtype, causal, tag):
        q, k, v = rnd(qs, dtype), rnd(ks, dtype), rnd(ks, dtype)
        got = ops.attention(q, k, v, causal=causal, impl="kernel")
        want = ref.attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        tol = FLASH_TOL[str(dtype).split(".")[1]]
        g, w = got.double(), want.double()
        err = (g - w).abs().max().item()
        ok = (got.shape == want.shape and got.dtype == want.dtype
              and bool(torch.isfinite(g).all())
              and bool(((g - w).abs() <= tol["atol"]
                        + tol["rtol"] * w.abs()).all()))
        sq, skv = qs[2], ks[2]
        if causal and sq > skv:
            # rows that see no column: the mean of V, as ref.attention
            mean = v.double().mean(dim=2, keepdim=True).repeat_interleave(
                qs[1] // ks[1], dim=1).expand(-1, -1, sq - skv, -1)
            e = (g[:, :, :sq - skv] - mean).abs()
            ok = ok and bool((e <= tol["atol"]
                              + tol["rtol"] * mean.abs()).all())
        report["kernel_checks"].append(
            {"kernel": "flash_attention", "tag": tag, "dtype": str(dtype),
             "shapes": [list(qs), list(ks)], "causal": causal,
             "max_abs_err": err, "tol": tol, "ok": ok})
        check(ok, f"flash_attention {tag} q{list(qs)} kv{list(ks)} {dtype} "
                  f"causal={causal}: max_abs_err {err:.3g} outside {tol}")
        return (q, k, v), err

    print("== flash attention against ref.attention", flush=True)
    cases = []
    for b, h, s, d in ((1, 2, 128, 64), (2, 4, 256, 64), (1, 2, 100, 64),
                       (1, 8, 128, 128), (1, 1, 384, 80)):   # :78-113
        cases.append(((b, h, s, d), (b, h, s, d), f32, "sweep"))
    cases += [((2, 8, 128, 64), (2, 2, 128, 64), f32, "gqa 8:2"),
              ((1, 32, 200, 128), (1, 4, 200, 128), f32, "gqa 32:4"),
              ((1, 4, 37, 64), (1, 4, 300, 64), f32, "sq<skv"),
              ((2, 8, 64, 128), (2, 2, 200, 128), f32, "sq<skv gqa"),
              ((1, 2, 1, 80), (1, 2, 77, 80), f32, "sq=1"),
              ((4, 4, 96, 32), (4, 2, 96, 32), f32, "d32"),
              ((2, 4, 50, 32), (2, 4, 130, 32), f32, "d32 sq<skv"),
              ((1, 2, 40, 64), (1, 2, 9, 64), f32, "sq>skv"),
              ((2, 8, 300, 128), (2, 2, 70, 128), f32, "sq>skv gqa"),
              ((1, 3, 130, 80), (1, 1, 65, 80), f32, "sq>skv d80"),
              ((1, 8, 128, 128), (1, 8, 128, 128), bf16, "bf16"),
              ((1, 1, 384, 80), (1, 1, 384, 80), bf16, "bf16"),
              ((2, 8, 64, 128), (2, 2, 200, 128), bf16, "bf16 sq<skv gqa"),
              ((4, 4, 96, 32), (4, 2, 96, 32), bf16, "bf16 d32"),
              ((2, 4, 100, 64), (2, 4, 100, 64), bf16, "bf16 d64"),
              ((1, 2, 1, 80), (1, 2, 77, 80), bf16, "bf16 sq=1"),
              ((1, 2, 5, 128), (1, 2, 1, 128), bf16, "bf16 skv=1"),
              ((1, 2, 40, 64), (1, 2, 9, 64), bf16, "bf16 sq>skv"),
              ((2, 8, 300, 128), (2, 2, 70, 128), bf16, "bf16 sq>skv gqa"),
              ((1, 3, 130, 80), (1, 1, 65, 80), bf16, "bf16 sq>skv d80"),
              ((2, 4, 100, 32), (2, 4, 33, 32), bf16, "bf16 sq>skv d32")]
    for qs, ks, dtype, tag in cases:
        for causal in (True, False):
            _, err = compare(qs, ks, dtype, causal, tag)
            print(f"  {tag:16s} q{list(qs)} kv{list(ks)} {str(dtype):14s} "
                  f"causal={causal!s:5s}: max_abs_err {err:.3g}", flush=True)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    def timed(qs, ks, tag):
        (q, k, v), err = compare(qs, ks, bf16, True, tag)
        nbytes, nops = flash_work(qs, ks, True, 2)
        sets = rotation((q, k, v), nbytes)

        def kernel(q, k, v):
            return ops.attention(q, k, v, impl="kernel")

        row = {"kernel": "flash_attention", "tag": tag, "dtype": str(bf16),
               "shapes": [list(qs), list(ks)], "max_abs_err": err,
               "ms": time_ms(lambda: kernel(q, k, v)),
               "device_ms": device_ms(kernel, sets),
               "plain_ms": time_ms(lambda: ref.attention(q, k, v))}
        try:
            row["library_ms"] = time_ms(lambda: sdpa(q, k, v))
            row["library_device_ms"] = device_ms(sdpa, sets)
            # SDPA's own distance to ref.attention: the noise floor of bf16
            row["library_max_abs_err"] = (
                sdpa(q, k, v).double()
                - ref.attention(q, k, v).double()).abs().max().item()
        except TypeError:                   # a torch without enable_gqa
            row["library_ms"] = row["library_max_abs_err"] = None
            row["library_device_ms"] = None
        del sets
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / PEAK_OPS_PER_S["bfloat16"] * 1e3
        row["bound_ms"], row["bound_by"] = (
            (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))
        report["kernel_times"].append(row)
        lib = ("-" if row["library_ms"] is None else
               f"{row['library_ms']:.4f} ms (device "
               f"{row['library_device_ms']:.4f}; max_abs_err "
               f"{row['library_max_abs_err']:.3g})")
        print(f"  time flash_attention {tag} bf16 q{list(qs)} kv{list(ks)}: "
              f"kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}; "
              f"max_abs_err {err:.3g}), plain "
              f"{row['plain_ms']:.4f} ms, sdpa {lib}, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {nbytes} B, "
              f"{nops} ops)", flush=True)
        return row

    b, st = SERVE_STATIC["batch"], SERVE_STATIC["prompt_len"]
    row = timed((b, 32, st, 128), (b, 4, st, 128), "prefill")  # Yi-9B's
    timed(*FLASH_OPS_SHAPE, "operations-bound")
    return row


def device_busy(fn, reps):
    """Device time over host wall time of ``reps`` calls of ``fn`` in a
    ``torch.profiler`` trace (after one warm-up call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / reps
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    dev_us = sum(r[0] for r in rows) / reps
    return {"wall_us": wall_us, "device_us": dev_us,
            "busy_share": dev_us / wall_us,
            "launches": sum(r[2] for r in rows) // reps,
            "top": [(k, us / reps, c // reps) for us, k, c in rows[:4]]}


def serving_phase(check, report):
    """Yi-9B at its published width through ``ServeEngine`` on the card.
    Returns what the tenant phase reuses: the launch counts of the serving
    run, the config, the model (still on the card), the prompts, the
    ``step`` mode's greedy tokens, ``max_len`` and the peak device
    memory."""
    import numpy as np
    import torch
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.kernels import build
    from repro_torch.launch.serve import continuous_trace
    from repro_torch.models import CallConfig, get, init_params, prefill
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.engine import build_sampling_step

    dev = torch.device("cuda")
    cfg = get(SERVE_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab_size)
          == (48, 4096, 32, 4, 128, 11008, 64000),
          f"{cfg.name} is not at its published width: {cfg}")
    print(f"== serving: {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}; {cfg.param_dtype} weights, "
          f"{cfg.compute_dtype} compute)", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, generator=torch.Generator(device=dev)
                        .manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    check(n_params == 8_829_407_232, f"{n_params} parameters")
    print(f"  init: {n_params} parameters, {param_bytes} B on the card in "
          f"{init_s:.2f} s", flush=True)

    st = SERVE_STATIC
    prompts = SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, batch_size=st["batch"],
        seq_len=st["prompt_len"], seed=0), cfg).batch(0)["tokens"]
    max_len = st["prompt_len"] + st["new_tokens"] + 1
    mn = SERVE_MANY
    reqs, arrivals, lens = continuous_trace(
        mn["requests"], mn["lo"], mn["hi"], mn["new_tokens"],
        mn["arrival_rate"], cfg.vocab_size, seed=0)
    check(max(lens) + mn["new_tokens"] + 1 <= mn["max_len"],
          f"trace lengths {lens.tolist()} exceed max_len {mn['max_len']}")

    # -- the main path, counted ------------------------------------------
    outs, stats, wall = {}, {}, {}
    prefills = 0
    torch.cuda.synchronize()
    build.reset_counts()
    for mode in ("step", "chunk", "host"):
        eng = ServeEngine(cfg, model, ServeConfig(
            batch=st["batch"], max_len=max_len, decode_mode=mode,
            decode_chunk=st["decode_chunk"]))
        t0 = time.perf_counter()
        outs[mode] = eng.generate(prompts, st["new_tokens"])
        torch.cuda.synchronize()
        wall[mode] = time.perf_counter() - t0
        stats[mode] = dict(eng.stats)
        prefills += 1
    eng = ServeEngine(cfg, model, ServeConfig(batch=mn["batch"],
                                              max_len=mn["max_len"]))
    t0 = time.perf_counter()
    many = eng.generate_many(reqs, arrival_steps=arrivals.tolist())
    torch.cuda.synchronize()
    many_s = time.perf_counter() - t0
    stats["continuous"] = dict(eng.stats)
    prefills += sum(1 for p, _ in reqs if p.size > 1)
    launches = build.launch_counts()

    want = cfg.n_layers * prefills
    check(launches["flash_attention"] == want,
          f"serving launched flash_attention {launches['flash_attention']} "
          f"times, not once per layer of each of {prefills} prefills "
          f"({want})")
    for mode, out in outs.items():
        check(out.shape == (st["batch"], st["new_tokens"])
              and out.min() >= 0 and out.max() < cfg.vocab_size,
              f"{mode} tokens of shape {out.shape}")
    for mode in ("chunk", "host"):
        check(np.array_equal(outs[mode], outs["step"]),
              f"{mode} mode emitted other greedy tokens than step mode")
    check(all(o.shape == (mn["new_tokens"],) and o.min() >= 0
              and o.max() < cfg.vocab_size for o in many),
          f"continuous outputs {[o.shape for o in many]}")
    check(stats["continuous"]["requests_retired"] == mn["requests"]
          and stats["continuous"]["prefill_inserts"] == mn["requests"],
          f"continuous stats {stats['continuous']}")
    total = sum(len(o) for o in many)
    for mode in outs:
        print(f"  generate {mode:5s}: batch {st['batch']} x "
              f"{st['prompt_len']} prompt tokens, {st['new_tokens']} new: "
              f"{wall[mode]:.3f} s wall; stats {stats[mode]}", flush=True)
    print(f"  step tokens, row 0: {outs['step'][0].tolist()}", flush=True)
    print(f"  generate_many: {mn['requests']} requests (prompts "
          f"{lens.tolist()}, arrivals {arrivals.tolist()}), {total} tokens "
          f"in {many_s:.3f} s = {total / many_s:.1f} tok/s; stats "
          f"{stats['continuous']}", flush=True)

    # -- prefill with the kernel against the plain attention -------------
    toks = torch.as_tensor(prompts).to(dev)
    calls = {impl: CallConfig(attn_impl=impl, attn_chunk=64)
             for impl in ("kernel", "plain", "chunked")}
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    prefill_cmp = {}
    for tag, c in (("bfloat16", cfg), ("float32", f32)):
        lg = {impl: prefill(model, c, {"tokens": toks}, max_len,
                            call)[0].double()
              for impl, call in calls.items()}
        torch.cuda.synchronize()
        lp = lg["plain"]
        row = {"max_abs_logit": lp.abs().max().item()}
        for impl in ("kernel", "chunked"):
            d = lg[impl] - lp
            row[impl] = {"max_abs_err": d.abs().max().item(),
                         "rel_l2": (d.norm() / lp.norm()).item()}
        tol = PREFILL_TOL[tag]
        d = lg["kernel"] - lp
        ok = (lg["kernel"].shape == (st["batch"], 1, cfg.vocab_size)
              and bool(torch.isfinite(lg["kernel"]).all()))
        if "rel_l2" in tol:
            ok = ok and row["kernel"]["rel_l2"] <= tol["rel_l2"]
        else:
            ok = ok and bool((d.abs() <= tol["atol"]
                              + tol["rtol"] * lp.abs()).all())
        check(ok, f"prefill logits in {tag} compute, kernel vs plain "
                  f"attention: {row['kernel']} outside {tol}")
        prefill_cmp[tag] = row
        print(f"  prefill logits, {tag} compute (max |logit| "
              f"{row['max_abs_logit']:.4g}): kernel vs plain max_abs_err "
              f"{row['kernel']['max_abs_err']:.4g}, relative L2 "
              f"{row['kernel']['rel_l2']:.4g}; chunked vs plain (another "
              f"f32 summation order) {row['chunked']['max_abs_err']:.4g}, "
              f"{row['chunked']['rel_l2']:.4g}; bar {tol}", flush=True)
        del lg, lp, d

    def prefill_s(impl):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(model, cfg, {"tokens": toks}, max_len, calls[impl])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    runs = {"kernel": [], "plain": []}
    for impl in ("kernel", "plain", "plain", "kernel", "kernel", "plain"):
        runs[impl].append(prefill_s(impl))
    prefill_ms = {impl: statistics.median(v) * 1e3
                  for impl, v in runs.items()}
    n_steps, n_prof = 16, 3
    _, cache = prefill(model, cfg, {"tokens": toks},
                       st["prompt_len"] + n_steps + n_prof + 4,
                       calls["kernel"])
    step = build_sampling_step(model, cfg, 0.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    tok = toks[:, -1:]
    for _ in range(2):
        tok, cache = step(cache, tok, gen)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(n_steps):
        tok, cache = step(cache, tok, gen)
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end) / n_steps
    peak = torch.cuda.max_memory_allocated()
    print(f"  prefill (batch {st['batch']} x {st['prompt_len']}): kernel "
          f"{prefill_ms['kernel']:.3f} ms, plain {prefill_ms['plain']:.3f} "
          f"ms (median of 3, host clock); decode step (batch "
          f"{st['batch']}, step mode): {decode_ms:.3f} ms per step; peak "
          f"device memory {peak} B", flush=True)

    # -- where a prefill's and a decode step's time goes -----------------
    def step_once():
        nonlocal tok, cache
        tok, cache = step(cache, tok, gen)

    busy = {"prefill": device_busy(
                lambda: prefill(model, cfg, {"tokens": toks}, max_len,
                                calls["kernel"]), 1),
            "decode_step": device_busy(step_once, n_prof)}
    for what, b in busy.items():
        print(f"  profile {what}: wall {b['wall_us']:.1f} us (profiled), "
              f"device {b['device_us']:.1f} us, busy share "
              f"{b['busy_share']:.3f}, {b['launches']} device ops; top "
              + "; ".join(f"{k[:40]} {us:.1f} us x{c}"
                          for k, us, c in b["top"]), flush=True)
    report["serving"] = {
        "arch": cfg.name, "n_params": n_params, "param_bytes": param_bytes,
        "init_s": init_s, "static": SERVE_STATIC, "continuous": SERVE_MANY,
        "prompt_lens": lens.tolist(), "arrivals": arrivals.tolist(),
        "wall_s": wall, "continuous_s": many_s,
        "continuous_tok_per_s": total / many_s, "stats": stats,
        "prefill_ms": prefill_ms, "prefill_runs_s": runs,
        "decode_ms_per_step": decode_ms,
        "prefill_logits": prefill_cmp, "busy": busy,
        "max_memory_allocated": peak, "launches": launches,
        "prefills": prefills}
    del cache
    torch.cuda.empty_cache()
    return {"launches": launches, "cfg": cfg, "model": model,
            "prompts": prompts, "tokens": outs["step"], "max_len": max_len,
            "peak": peak}


def scan_work(shape, itemsize, h0, state):
    """(bytes, operations) one scan call needs: a, b (B, S, D, N) and c
    (B, S, N) read once, y (B, S, D) written once, h0 and the final state
    (B, D, N) f32 once each where given; two multiply-adds per state and
    step."""
    b, s, d, n = shape
    nbytes = (2 * b * s * d * n + b * s * n + b * s * d) * itemsize
    nbytes += (int(h0) + int(state)) * b * d * n * 4
    return nbytes, 4 * b * s * d * n


def scan_phase(check, report, time_ms):
    """The scan kernel against ``ref.ssm_scan`` on the card, and its times
    at the serving phase's prefill chunk.  Returns that shape's row of the
    kernels line."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(44)
    f32, bf16 = torch.float32, torch.bfloat16

    def compare(a, b, c, h0, tag):
        """y (and the final state, with h0) of the kernel against the
        plain version; returns the larger error."""
        state = h0 is not None
        got = ops.ssm_scan(a, b, c, h0=h0, return_state=state,
                           impl="kernel")
        want = ref.ssm_scan(a, b, c, h0=h0, return_state=state)
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if state else [(got, want)]
        tol = SCAN_TOL[str(a.dtype).split(".")[1]]
        ok, err = True, 0.0
        for i, (g, w) in enumerate(pairs):
            t = tol if i == 0 else SCAN_TOL["float32"]   # the state is f32
            g64, w64 = g.double(), w.double()
            e = (g64 - w64).abs().max().item()
            err = max(err, e)
            ok = ok and (g.shape == w.shape and g.dtype == w.dtype
                         and bool(torch.isfinite(g64).all())
                         and bool(((g64 - w64).abs() <= t["atol"]
                                   + t["rtol"] * w64.abs()).all()))
        shape = list(a.shape)
        report["kernel_checks"].append(
            {"kernel": "ssm_scan", "tag": tag, "dtype": str(a.dtype),
             "shapes": [shape, list(c.shape)], "h0": state,
             "max_abs_err": err, "tol": tol, "ok": ok})
        check(ok, f"ssm_scan {tag} {shape} {a.dtype} h0={state}: "
                  f"max_abs_err {err:.3g} outside {tol}")
        print(f"  {tag:14s} {shape} {str(a.dtype):14s} h0={state!s:5s}: "
              f"max_abs_err {err:.3g}", flush=True)
        return err

    def inputs(shape, dtype):
        bsz, s, d, n = shape
        a = rng.uniform(0.7, 0.999, shape)     # decays in (0, 1)
        b = rng.standard_normal(shape) * 0.1
        c = rng.standard_normal((bsz, s, n))
        h0 = rng.standard_normal((bsz, d, n))
        return ([torch.from_numpy(x).to(dtype).to(dev) for x in (a, b, c)]
                + [torch.from_numpy(h0).to(f32).to(dev)])

    print("== SSM scan against ref.ssm_scan", flush=True)
    cases = [((1, 64, 128, 16), f32, "sweep"),          # test_kernels.py
             ((2, 100, 64, 16), f32, "sweep"),          # :126-130
             ((1, 33, 512, 8), f32, "sweep"),
             ((3, 1, 77, 16), f32, "S=1"),
             ((2, 50, 40, 32), f32, "N=32"),
             ((1, 40, 33, 64), f32, "N=64"),
             ((2, 70, 37, 16), f32, "D=37"),
             ((1, 64, 128, 16), bf16, "bf16"),
             ((2, 33, 37, 8), bf16, "bf16 D=37")]
    for shape, dtype, tag in cases:
        a, b, c, h0 = inputs(shape, dtype)
        compare(a, b, c, None, tag)
        compare(a, b, c, h0, tag)

    shape = SCAN_PREFILL_SHAPE
    bsz, chunk, d, n = shape
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.rand(shape, generator=g, device=dev) * 0.299 + 0.7
    b = torch.randn(shape, generator=g, device=dev) * 0.1
    c = torch.randn((bsz, chunk, n), generator=g, device=dev)
    h0 = torch.randn((bsz, d, n), generator=g, device=dev)
    err = compare(a, b, c, h0, "prefill")
    nbytes, nops = scan_work(shape, 4, True, True)

    def kernel(a, b, c, h0):
        return ops.ssm_scan(a, b, c, h0=h0, return_state=True, impl="kernel")

    row = {"kernel": "ssm_scan", "tag": "prefill chunk", "dtype": str(f32),
           "shapes": [list(shape), list(c.shape)], "max_abs_err": err,
           "ms": time_ms(lambda: kernel(a, b, c, h0)),
           "device_ms": device_ms(kernel, rotation((a, b, c, h0), nbytes)),
           "plain_ms": time_ms(lambda: ref.ssm_scan(a, b, c, h0=h0,
                                                    return_state=True)),
           # no single PyTorch call scans
           "library_ms": None, "library_device_ms": None}
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S["float32"] * 1e3
    row["bound_ms"], row["bound_by"] = ((t_bytes, "bytes") if t_bytes >= t_ops
                                        else (t_ops, "operations"))
    report["kernel_times"].append(row)
    print(f"  time ssm_scan prefill chunk f32 {list(shape)}, h0 and final "
          f"state: kernel {row['ms']:.4f} ms (device "
          f"{row['device_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
          f"library - (none), bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {nbytes} B, {nops} ops)", flush=True)
    del a, b, c, h0
    return row


def ssm_serving_phase(check, report):
    """falcon-mamba-7b at its published width through ``ServeEngine`` on
    the card.  Returns the launch counts of the serving run."""
    import numpy as np
    import torch
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.kernels import build
    from repro_torch.models import CallConfig, get, init_params, prefill
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.engine import build_sampling_step

    dev = torch.device("cuda")
    cfg = get(SSM_ARCH)
    s1 = cfg.ssm
    check((cfg.family, cfg.n_layers, cfg.d_model, cfg.d_inner, s1.d_state,
           s1.d_conv, s1.dt_rank or -(-cfg.d_model // 16), cfg.vocab_size,
           cfg.tie_embeddings)
          == ("ssm", 64, 4096, 8192, 16, 4, 256, 65024, False),
          f"{cfg.name} is not at its published width: {cfg}")
    print(f"== serving: {cfg.name} ({cfg.n_layers} Mamba-1 layers, d "
          f"{cfg.d_model}, d_inner {cfg.d_inner}, N {s1.d_state}, conv "
          f"{s1.d_conv}, scan chunk {s1.chunk}, vocab {cfg.vocab_size}; "
          f"{cfg.param_dtype} weights, {cfg.compute_dtype} compute)",
          flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, generator=torch.Generator(device=dev)
                        .manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    check(n_params == 7_272_665_088, f"{n_params} parameters")
    print(f"  init: {n_params} parameters, {param_bytes} B on the card in "
          f"{init_s:.2f} s", flush=True)

    st = SSM_STATIC
    prompts = SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, batch_size=st["batch"],
        seq_len=st["prompt_len"], seed=0), cfg).batch(0)["tokens"]
    max_len = st["prompt_len"] + st["new_tokens"] + 1

    # -- the main path, counted ------------------------------------------
    outs, stats, wall = {}, {}, {}
    torch.cuda.synchronize()
    build.reset_counts()
    for mode in ("step", "chunk", "host"):
        eng = ServeEngine(cfg, model, ServeConfig(
            batch=st["batch"], max_len=max_len, decode_mode=mode,
            decode_chunk=st["decode_chunk"]))
        t0 = time.perf_counter()
        outs[mode] = eng.generate(prompts, st["new_tokens"])
        torch.cuda.synchronize()
        wall[mode] = time.perf_counter() - t0
        stats[mode] = dict(eng.stats)
    launches = build.launch_counts()

    chunks = -(-st["prompt_len"] // s1.chunk)
    want = cfg.n_layers * chunks * len(outs)
    check(launches["ssm_scan"] == want,
          f"serving launched ssm_scan {launches['ssm_scan']} times, not once "
          f"per chunk of each layer of {len(outs)} prefills ({want})")
    for mode, out in outs.items():
        check(out.shape == (st["batch"], st["new_tokens"])
              and out.min() >= 0 and out.max() < cfg.vocab_size,
              f"{mode} tokens of shape {out.shape}")
    for mode in ("chunk", "host"):
        check(np.array_equal(outs[mode], outs["step"]),
              f"{mode} mode emitted other greedy tokens than step mode")
    try:
        eng.generate_many([(prompts[0], 2)])
        raised = False
    except NotImplementedError:
        raised = True
    check(raised, "generate_many did not raise for the ssm family")
    for mode in outs:
        print(f"  generate {mode:5s}: batch {st['batch']} x "
              f"{st['prompt_len']} prompt tokens, {st['new_tokens']} new: "
              f"{wall[mode]:.3f} s wall; stats {stats[mode]}", flush=True)
    print(f"  step tokens, row 0: {outs['step'][0].tolist()}", flush=True)
    print("  generate_many: raises NotImplementedError, as the reference's",
          flush=True)

    # -- prefill with the kernel against the plain scan ------------------
    toks = torch.as_tensor(prompts).to(dev)
    calls = {impl: CallConfig(ssm_impl=impl) for impl in ("kernel", "plain")}
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    prefill_cmp = {}
    for tag, c in (("bfloat16", cfg), ("float32", f32)):
        lg = {impl: prefill(model, c, {"tokens": toks}, max_len,
                            call)[0].double()
              for impl, call in calls.items()}
        torch.cuda.synchronize()
        lp = lg["plain"]
        d = lg["kernel"] - lp
        row = {"max_abs_logit": lp.abs().max().item(),
               "kernel": {"max_abs_err": d.abs().max().item(),
                          "rel_l2": (d.norm() / lp.norm()).item()}}
        tol = PREFILL_TOL[tag]
        ok = (lg["kernel"].shape == (st["batch"], 1, cfg.vocab_size)
              and bool(torch.isfinite(lg["kernel"]).all()))
        if "rel_l2" in tol:
            ok = ok and row["kernel"]["rel_l2"] <= tol["rel_l2"]
        else:
            ok = ok and bool((d.abs() <= tol["atol"]
                              + tol["rtol"] * lp.abs()).all())
        check(ok, f"{cfg.name} prefill logits in {tag} compute, kernel vs "
                  f"plain scan: {row['kernel']} outside {tol}")
        prefill_cmp[tag] = row
        print(f"  prefill logits, {tag} compute (max |logit| "
              f"{row['max_abs_logit']:.4g}): kernel vs plain scan "
              f"max_abs_err {row['kernel']['max_abs_err']:.4g}, relative L2 "
              f"{row['kernel']['rel_l2']:.4g}; bar {tol}", flush=True)
        del lg, lp, d

    def prefill_s(impl):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(model, cfg, {"tokens": toks}, max_len, calls[impl])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    runs = {"kernel": [], "plain": []}
    for impl in ("kernel", "plain", "plain", "kernel", "kernel", "plain"):
        runs[impl].append(prefill_s(impl))
    prefill_ms = {impl: statistics.median(v) * 1e3
                  for impl, v in runs.items()}
    n_steps, n_prof = 16, 3
    _, cache = prefill(model, cfg, {"tokens": toks}, max_len,
                       calls["kernel"])
    step = build_sampling_step(model, cfg, 0.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    tok = toks[:, -1:]
    for _ in range(2):
        tok, cache = step(cache, tok, gen)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(n_steps):
        tok, cache = step(cache, tok, gen)
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end) / n_steps
    peak = torch.cuda.max_memory_allocated()
    print(f"  prefill (batch {st['batch']} x {st['prompt_len']}): kernel "
          f"{prefill_ms['kernel']:.3f} ms, plain {prefill_ms['plain']:.3f} "
          f"ms (median of 3, host clock); decode step (batch "
          f"{st['batch']}, step mode): {decode_ms:.3f} ms per step; peak "
          f"device memory {peak} B", flush=True)

    # -- where a prefill's and a decode step's time goes -----------------
    def step_once():
        nonlocal tok, cache
        tok, cache = step(cache, tok, gen)

    busy = {"prefill": device_busy(
                lambda: prefill(model, cfg, {"tokens": toks}, max_len,
                                calls["kernel"]), 1),
            "decode_step": device_busy(step_once, n_prof)}
    for what, b in busy.items():
        print(f"  profile {what}: wall {b['wall_us']:.1f} us (profiled), "
              f"device {b['device_us']:.1f} us, busy share "
              f"{b['busy_share']:.3f}, {b['launches']} device ops; top "
              + "; ".join(f"{k[:40]} {us:.1f} us x{c}"
                          for k, us, c in b["top"]), flush=True)
    report["ssm_serving"] = {
        "arch": cfg.name, "n_params": n_params, "param_bytes": param_bytes,
        "init_s": init_s, "static": SSM_STATIC, "wall_s": wall,
        "stats": stats, "prefill_ms": prefill_ms, "prefill_runs_s": runs,
        "decode_ms_per_step": decode_ms, "prefill_logits": prefill_cmp,
        "busy": busy, "max_memory_allocated": peak, "launches": launches,
        "tokens_row0": outs["step"][0].tolist()}
    del model, cache
    torch.cuda.empty_cache()
    return launches


def _intervals_ms(intervals):
    """Merge (start, end) intervals; returns the sorted disjoint list."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def copy_kernel_overlap_ms(prof):
    """(ms in which a host-to-device copy ran while a kernel ran, ms of
    host-to-device copies, ms of kernels) from a ``torch.profiler`` trace,
    or ``None`` when the trace holds no device events."""
    from torch.autograd import DeviceType
    copies, kernels = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start / 1e3, e.time_range.end / 1e3)
        if "HtoD" in e.name:
            copies.append(span)
        elif "Memcpy" not in e.name and "Memset" not in e.name:
            kernels.append(span)
    if not copies and not kernels:
        return None
    c, k = _intervals_ms(copies), _intervals_ms(kernels)
    both, i, j = 0.0, 0, 0
    while i < len(c) and j < len(k):
        both += max(0.0, min(c[i][1], k[j][1]) - max(c[i][0], k[j][0]))
        if c[i][1] < k[j][1]:
            i += 1
        else:
            j += 1
    return (both, sum(b - a for a, b in c), sum(b - a for a, b in k))


def session_phase(check, report, device=None, sizes=None,
                  overlap_sizes=None):
    """The session layer on the card: ``Session()`` with 32 logical
    clusters, every job at the offload phase's larger size.

    1. AUTO single submit, a list of 8, ``stage()`` + a RESIDENT submit
       per job, each result at rtol=atol=1e-9 against ``make_instance``;
       the kernel of each job launched once per dispatch.
    2. The overlap: 8 fresh singles of covariance and atax with AUTO's
       window open (depth 2), then with it pinned to 1 — wall time and the
       ms in which host-to-device copies ran during a kernel.
    3. ``submit_graph``: an axpy chain and diamond and a matmul diamond,
       bit-identical to one-by-one submits; d2h only at fetch nodes.
    4. One retry-policy submit under a dropped arrival, recovered in the
       attempts the CPU test pins.
    5. The session's host cost per single submit against a bare
       ``OffloadRuntime.offload``.

    ``device``/``sizes`` default to the card and the offload phase's
    larger sizes (a CPU rehearsal passes smaller ones).  Returns the
    kernels' launch counts over the phase.
    """
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import (
        FaultInjector, FaultKind, FaultPlan, FaultSpec, GraphNode,
        OffloadPolicy, OffloadRuntime, Ref, Residency, RetryPolicy, Session,
    )
    from repro_torch.core import jobs
    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    sizes = sizes or {k: v[1] for k, v in OFFLOAD_SIZES.items()}
    overlap_sizes = overlap_sizes or {"covariance": sizes["covariance"],
                                      "atax": sizes["atax"]}
    out = report.setdefault("session", {})
    build.reset_counts()

    def held(tag, got, want):
        got, want = np.asarray(got), np.asarray(want)
        err = float(np.max(np.abs(got - want))) if got.size else 0.0
        ok = got.shape == want.shape and bool(np.allclose(got, want,
                                                          **JOB_TOL))
        check(ok, f"session {tag}: off by {err:.3g}")
        return err

    def decision(d):
        return {"staging": d.staging.value, "fuse": d.fuse,
                "window": d.window, "residency": d.residency.value}

    print("== session: Session() on the card, every job at the larger "
          "size", flush=True)
    out["jobs"] = []
    explained = False
    for name in jobs.PAPER_JOBS:
        job = jobs.PAPER_JOBS[name](*sizes[name])
        insts, exps = jobs.make_instances(job, 9, seed0=20)
        before = build.launch_counts()
        sess = Session(device) if device is not None else Session()
        check(sess.num_clusters == 32 and (device is not None
                                           or sess.device.type == "cuda"),
              f"session {name}: not 32 clusters on the card")
        t0 = time.perf_counter()
        h = sess.submit(job, insts[0])
        err = held(f"{name} single", h.wait(), exps[0])
        single_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        hm = sess.submit(job, insts[1:])
        errs = [held(f"{name} list {i}", r, e)
                for i, (r, e) in enumerate(zip(hm.wait(), exps[1:]))]
        list_ms = (time.perf_counter() - t0) * 1e3
        staged = sess.stage(job, insts[0])
        hr = sess.submit(job, Residency.RESIDENT)
        errs.append(held(f"{name} resident", hr.wait(), exps[0]))
        if device is None:
            torch.cuda.synchronize()
        after = build.launch_counts()
        stats = sess.stats
        delta = {k: after[k] - before[k] for k in after}
        want = {k: (stats.dispatches if k == name else 0) for k in KERNEL_JOBS}
        got = {k: delta[k] for k in KERNEL_JOBS}
        check(got == want, f"session {name}: kernel launches {got} for "
                           f"{stats.dispatches} dispatches")
        row = {"job": job.spec.name, "single": decision(h.decision),
               "list": decision(hm.decision), "stage": decision(staged),
               "resident": decision(hr.decision),
               "max_abs_err": max([err] + errs), "single_ms": single_ms,
               "list_ms": list_ms, "launches": got,
               "stats": dataclasses.asdict(stats)}
        out["jobs"].append(row)
        print(f"  {job.spec.name:28s} single {row['single']}  list "
              f"{row['list']}  resident {row['resident']}; err "
              f"{row['max_abs_err']:.2g}; single {single_ms:.2f} ms, list "
              f"of 8 {list_ms:.2f} ms; launches {got}", flush=True)
        print(f"    stats {dict((k, v) for k, v in row['stats'].items() if v)}",
              flush=True)
        if name == "covariance" and not explained:
            print("    " + str(hm.explain()).replace("\n", "\n    "),
                  flush=True)
            explained = True
        sess.close()
        del sess, h, hm, hr
    if device is None:
        torch.cuda.empty_cache()

    print("== session: 8 fresh singles, window open vs pinned to 1",
          flush=True)
    out["overlap"] = []
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device is None else [])

    def singles(sess, job, insts, pol, serial):
        """8 singles: all submitted, then all waited (``serial``: each
        waited before the next is submitted); returns results, wall ms."""
        t0 = time.perf_counter()
        if serial:
            res = [sess.submit(job, ops, policy=pol).wait() for ops in insts]
        else:
            hs = [sess.submit(job, ops, policy=pol) for ops in insts]
            res = [h.wait() for h in hs]
        return res, (time.perf_counter() - t0) * 1e3

    variants = (("open", OffloadPolicy(), False),
                ("window=1", OffloadPolicy(window=1), False),
                ("submit+wait", OffloadPolicy(window=1), True))
    rounds = 5
    for name, size in overlap_sizes.items():
        job = jobs.PAPER_JOBS[name](*size)
        insts, exps = jobs.make_instances(job, 8, seed0=40)
        sessions = {label: (Session(device) if device is not None
                            else Session()) for label, _, _ in variants}
        walls = {label: [] for label, _, _ in variants}
        errs = {label: [] for label, _, _ in variants}
        # one pass each to allocate the pinned and device buffers its
        # window holds, then the variants in turns (the host's noise moves
        # a pass by tens of percent between calls, PERF.md §7)
        for rnd in range(rounds + 1):
            for label, pol, serial in variants:
                res, wall = singles(sessions[label], job, insts, pol,
                                    serial)
                errs[label] += [held(f"overlap {name} {label} {i}", r, e)
                                for i, (r, e) in enumerate(zip(res, exps))]
                if rnd:
                    walls[label].append(wall)
        for label, pol, serial in variants:
            sess = sessions[label]
            with profile(activities=activities) as prof:
                res, _ = singles(sess, job, insts, pol, serial)
            ov = copy_kernel_overlap_ms(prof)
            stream = next(iter(sess._streams.values()))
            row = {"job": job.spec.name, "policy": label,
                   "window": stream.window,
                   "wall_ms": statistics.median(walls[label]),
                   "walls_ms": walls[label],
                   "max_abs_err": max(errs[label]),
                   "h2d_during_kernel_ms": None if ov is None else ov[0],
                   "h2d_ms": None if ov is None else ov[1],
                   "kernel_ms": None if ov is None else ov[2],
                   "window_stalls": stream.stats["window_stalls"]}
            out["overlap"].append(row)
            ov_s = ("not measured (no device events in the trace)"
                    if ov is None else
                    f"profiled pass: h2d during kernels {ov[0]:.3f} ms of "
                    f"h2d {ov[1]:.3f} ms, kernels {ov[2]:.3f} ms")
            print(f"  {job.spec.name:24s} {label:11s} window "
                  f"{row['window']}: 8 singles, median of {rounds} "
                  f"{row['wall_ms']:.2f} ms wall "
                  f"({', '.join(f'{w:.1f}' for w in walls[label])}); "
                  f"{ov_s}", flush=True)
            sess.close()
        del sessions, res
        if device is None:
            torch.cuda.empty_cache()
    walls = {(r["job"], r["policy"]): r["wall_ms"] for r in out["overlap"]}
    for name, size in overlap_sizes.items():
        jname = jobs.PAPER_JOBS[name](*size).spec.name
        ratio = walls[(jname, "open")] / walls[(jname, "window=1")]
        out.setdefault("open_over_closed", {})[jname] = ratio
        print(f"  {jname}: open / window=1 wall = {ratio:.3f} (submit+wait "
              f"/ window=1 = {walls[(jname, 'submit+wait')] / walls[(jname, 'window=1')]:.3f})",
              flush=True)

    print("== session: submit_graph at full size", flush=True)
    out["graphs"] = []

    def graph_case(tag, job, build_nodes, sequential):
        sess = Session(device) if device is not None else Session()
        nodes = build_nodes()
        gh = sess.submit_graph(nodes)
        res = gh.wait()
        st = sess.stats
        fetched = sum(np.asarray(v).nbytes for v in res.values())
        check(st.d2h_bytes == fetched,
              f"graph {tag}: d2h {st.d2h_bytes} != fetched {fetched}")
        seq = sequential()
        same = all(np.array_equal(np.asarray(res[k]), np.asarray(seq[k]))
                   for k in res)
        check(same and sorted(res) == sorted(seq),
              f"graph {tag}: not bit-identical to one-by-one submits")
        row = {"graph": tag, "fetched": sorted(map(str, res)),
               "bit_identical": same, "issue_order": gh.issue_order,
               "max_inflight": gh.max_inflight,
               "forwarded": {f"{a},{b},{c}": v
                             for (a, b, c), v in gh.forwarded.items()},
               "stats": dataclasses.asdict(st)}
        out["graphs"].append(row)
        print(f"  {tag:18s} fetched {row['fetched']}: bit-identical {same}; "
              f"d2h {st.d2h_bytes} B (fetch nodes only), forwards "
              f"{st.forwards}, forward_bytes {st.forward_bytes}, renames "
              f"{st.renames}; issue {gh.issue_order}, max in flight "
              f"{gh.max_inflight}", flush=True)
        sess.close()

    def one_by_one(plan):
        """Run (node name, job, operands-with-names, selection) one submit
        at a time, fetching every result to the host and resubmitting it."""
        sess = Session(device) if device is not None else Session()
        done = {}
        for key, job, ops, sel in plan:
            ops = {k: (done[v] if isinstance(v, str) else v)
                   for k, v in ops.items()}
            done[key] = sess.submit(job, ops, **sel).wait()
        sess.close()
        return done

    axpy = jobs.make_axpy(*sizes["axpy"])
    aops, _ = axpy.make_instance(0)
    K = 8
    graph_case(
        "axpy chain K=8", axpy,
        lambda: [GraphNode(axpy, aops, name="n0")] + [
            GraphNode(axpy, {"x": aops["x"], "y": Ref(f"n{k - 1}")},
                      name=f"n{k}") for k in range(1, K)],
        lambda: {f"n{K - 1}": one_by_one(
            [("n0", axpy, dict(aops), {})]
            + [(f"n{k}", axpy, {"x": aops["x"], "y": f"n{k - 1}"}, {})
               for k in range(1, K)])[f"n{K - 1}"]})
    half = [list(range(16)), list(range(16, 32))]
    graph_case(
        "axpy diamond", axpy,
        lambda: [GraphNode(axpy, aops, name="src"),
                 GraphNode(axpy, {"x": aops["x"], "y": Ref("src")},
                           name="l", clusters=half[0]),
                 GraphNode(axpy, {"x": aops["x"], "y": Ref("src")},
                           name="r", clusters=half[1]),
                 GraphNode(axpy, {"x": Ref("l"), "y": Ref("r")},
                           name="join")],
        lambda: {"join": one_by_one(
            [("src", axpy, dict(aops), {}),
             ("l", axpy, {"x": aops["x"], "y": "src"},
              {"clusters": half[0]}),
             ("r", axpy, {"x": aops["x"], "y": "src"},
              {"clusters": half[1]}),
             ("join", axpy, {"x": "l", "y": "r"}, {})])["join"]})
    mm = jobs.make_matmul(*sizes["matmul"])
    mops, _ = mm.make_instance(1)
    graph_case(
        "matmul diamond", mm,
        lambda: [GraphNode(mm, mops, name="m0"),
                 GraphNode(mm, {"A": Ref("m0"), "B": mops["B"]}, name="l",
                           clusters=half[0]),
                 GraphNode(mm, {"A": mops["A"], "B": Ref("m0")}, name="r",
                           clusters=half[1]),
                 GraphNode(mm, {"A": Ref("l"), "B": Ref("r")},
                           name="join")],
        lambda: {"join": one_by_one(
            [("m0", mm, dict(mops), {}),
             ("l", mm, {"A": "m0", "B": mops["B"]}, {"clusters": half[0]}),
             ("r", mm, {"A": mops["A"], "B": "m0"}, {"clusters": half[1]}),
             ("join", mm, {"A": "l", "B": "r"}, {})])["join"]})

    print("== session: a retry-policy submit under a dropped arrival",
          flush=True)
    inj = FaultInjector(FaultPlan([FaultSpec(FaultKind.LOST_ARRIVAL,
                                             at_dispatch=0, count=1)]))
    sess = (Session(device, faults=inj, policy=OffloadPolicy(
        retry=RetryPolicy())) if device is not None else
        Session(faults=inj, policy=OffloadPolicy(retry=RetryPolicy())))
    aops, aexp = axpy.make_instance(3)
    # n=8: the ladder's bisection probe (an axpy of faults.PROBE_N = 840
    # elements, as in the reference) splits over at most 8 clusters
    err = held("retry", sess.submit(axpy, dict(aops), n=8).wait(), aexp)
    hl = sess.health()
    rungs = (hl.deadline_trips, hl.retries, hl.probes, hl.backups)
    # tests/test_torch_fabric.py pins the same rungs for a lost arrival
    check(rungs == (1, 1, 1, 0) and hl.jobs_ok == 1 and hl.jobs_failed == 0,
          f"retry: rungs {rungs}, ok {hl.jobs_ok}, failed {hl.jobs_failed}")
    out["retry"] = {"rungs": rungs, "jobs_ok": hl.jobs_ok,
                    "max_abs_err": err,
                    "health": dataclasses.asdict(hl)}
    print(f"  axpy n=8: recovered, err {err:.2g}; (trips, retries, probes, "
          f"backups) = {rungs}", flush=True)
    sess.close()

    print("== session: host cost of a single submit", flush=True)
    small = jobs.make_axpy()
    sops, _ = small.make_instance(0)
    sess = Session(device) if device is not None else Session()
    rt = OffloadRuntime(device) if device is not None else OffloadRuntime()
    sess.stage(small, sops)
    rt.plan(small, sops, n=32).stage(sops)
    costs = {}
    for label, fn in (
            ("session", lambda: sess.submit(small, Residency.RESIDENT,
                                            policy=OffloadPolicy(window=1))),
            ("runtime", lambda: rt.offload(small, Residency.RESIDENT,
                                           n=32))):
        for _ in range(5):
            fn().wait()
        submit_us, total_us = [], []
        for _ in range(100):
            t0 = time.perf_counter()
            h = fn()
            t1 = time.perf_counter()
            h.wait()
            t2 = time.perf_counter()
            submit_us.append((t1 - t0) * 1e6)
            total_us.append((t2 - t0) * 1e6)
        costs[label] = {"submit_us": statistics.median(submit_us),
                        "submit_wait_us": statistics.median(total_us)}
    costs["session_over_runtime_us"] = (
        costs["session"]["submit_us"] - costs["runtime"]["submit_us"])
    out["host_cost"] = costs
    print(f"  axpy default n=32 resident: session submit "
          f"{costs['session']['submit_us']:.1f} us (+wait "
          f"{costs['session']['submit_wait_us']:.1f}), runtime offload "
          f"{costs['runtime']['submit_us']:.1f} us (+wait "
          f"{costs['runtime']['submit_wait_us']:.1f}); session adds "
          f"{costs['session_over_runtime_us']:.1f} us a submit", flush=True)
    sess.close()
    if device is None:
        torch.cuda.synchronize()
    launches = build.launch_counts()
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print("session kernels: " + " ".join(f"{k}={v}"
                                         for k, v in launches.items()))
    print(f"session phase: {out['seconds']:.1f} s", flush=True)
    return launches


def lint_phase(check, report, device=None, sizes=None):
    """The perf linter on the card: ``Session(lint=True)`` with 32 logical
    clusters, one submission per ``OFLP1##`` code where a fixture of
    ``tests/test_perflint.py`` applies, at the offload phase's larger
    sizes where the code fires there (OFLP102 and OFLP105 fire only where
    the dispatch constant dominates: at the jobs' default sizes).

    For each finding its fix is applied and the original and the fixed
    submission run in turn: one warm pass each, then ``LINT_PASSES``
    alternating passes; the model's cycles (current, fixed) stand beside
    the card's median ms (current, fixed).  Checks: each expected code is
    found, the fixed results equal the original's (jobs at
    rtol=atol=1e-9, graphs bit-identical) and the expected values, and
    the four job kernels launched.  Whether the card agrees with the
    model's sign is recorded, not checked.  ``device``/``sizes`` default
    to the card and the larger sizes (a CPU rehearsal passes smaller
    ones).  Returns the kernels' launch counts over the phase.
    """
    import numpy as np
    import torch
    from repro_torch.analysis import perflint
    from repro_torch.api import AUTO, GraphNode, Ref, Session, Staging
    from repro_torch.core import jobs
    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    sizes = sizes or {k: v[1] for k, v in OFFLOAD_SIZES.items()}
    out = report.setdefault("lint", {"cases": []})
    build.reset_counts()
    sess = Session(device, num_clusters=32, lint=True)
    check(sess.num_clusters == 32 and (device is not None
                                       or sess.device.type == "cuda"),
          "lint: the session is not 32 clusters on the card")
    print("== lint: Session(lint=True) on the card, each OFLP1## fix run "
          "against its original", flush=True)

    def sync():
        if device is None:
            torch.cuda.synchronize()

    def held(tag, got, want, exact=False):
        """Results of two submissions, or of one and its expected value:
        dicts of graph results bit-identical, jobs at 1e-9."""
        if isinstance(got, dict):
            ok = sorted(got) == sorted(want) and all(
                np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes()
                for k in got)
            check(ok, f"lint {tag}: graph results not bit-identical")
            return 0.0
        got, want = np.asarray(got), np.asarray(want)
        err = float(np.max(np.abs(got - want))) if got.size else 0.0
        ok = got.shape == want.shape and (
            np.array_equal(got, want) if exact
            else bool(np.allclose(got, want, **JOB_TOL)))
        check(ok, f"lint {tag}: off by {err:.3g}")
        return err

    def case(code, tag, original, fixed_from, expected):
        """``original()`` -> (results, findings) submits and waits;
        ``fixed_from(finding)`` -> the fixed submission, the same way."""
        res, findings = original()
        codes = sorted({f.code for f in findings})
        f = next((f for f in findings if f.code == code), None)
        check(f is not None, f"lint {tag}: {code} not among {codes}")
        if f is None:
            return
        fixed = fixed_from(f, findings)
        fres, _ = fixed()
        err = held(f"{tag} fixed vs original", fres, res)
        if expected is not None:
            err = max(err, held(f"{tag} vs expected", res, expected))
        ms = {"current": [], "fixed": []}
        for _ in range(LINT_PASSES):
            for label, fn in (("current", original), ("fixed", fixed)):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                ms[label].append((time.perf_counter() - t0) * 1e3)
        med = {k: statistics.median(v) for k, v in ms.items()}
        row = {"code": code, "case": tag, "codes": codes,
               "fix": dataclasses.asdict(f.fix),
               "current_cycles": f.predicted_cycles,
               "fixed_cycles": f.optimal_cycles,
               "model_ratio": f.optimal_cycles / f.predicted_cycles,
               "current_ms": med["current"], "fixed_ms": med["fixed"],
               "card_ratio": med["fixed"] / med["current"],
               "passes_ms": ms, "max_abs_err": err,
               "card_agrees": med["fixed"] < med["current"]}
        out["cases"].append(row)
        print(f"  {code} {tag:34s} fix {f.fix.field}={f.fix.value!r}: model "
              f"{f.predicted_cycles:.0f} -> {f.optimal_cycles:.0f} cycles "
              f"(x{row['model_ratio']:.3f}); card {med['current']:.3f} -> "
              f"{med['fixed']:.3f} ms (x{row['card_ratio']:.3f}, median of "
              f"{LINT_PASSES}); agrees {row['card_agrees']}; codes {codes}",
              flush=True)

    def submit(job, ops, pol, **sel):
        def run():
            h = sess.submit(job, ops, policy=pol, **sel)
            return h.wait(), h.findings
        return run

    # OFLP101: staging=direct pinned for a replicated 16 MiB operand
    cov = jobs.make_covariance(*sizes["covariance"])
    cops, cexp = cov.make_instance(0)
    pol = AUTO.pinned(staging=Staging.DIRECT)
    case("OFLP101", f"{cov.spec.name} n=32 staging=direct",
         submit(cov, cops, pol, n=32),
         lambda f, fs: submit(cov, cops,
                              perflint.suggested_policy([f], pol), n=32),
         cexp)

    # OFLP102: an under-fused list (fuse=1 pinned) of 16 small axpys
    small = jobs.make_axpy()
    insts, exps = jobs.make_instances(small, 16, seed0=50)
    pol = AUTO.pinned(fuse=1)
    case("OFLP102", f"{small.spec.name} list of 16 fuse=1",
         submit(small, insts, pol, n=32),
         lambda f, fs: submit(small, insts,
                              perflint.suggested_policy([f], pol), n=32),
         np.stack(exps))

    # OFLP103: window=1 pinned on a list of 8 covariance jobs
    insts, exps = jobs.make_instances(cov, 8, seed0=60)
    pol = AUTO.pinned(window=1)
    case("OFLP103", f"{cov.spec.name} list of 8 window=1",
         submit(cov, insts, pol, n=32),
         lambda f, fs: submit(cov, insts,
                              perflint.suggested_policy([f], pol), n=32),
         np.stack(exps))

    # OFLP104: the serial reshard graph, wide -> narrow -> wide
    axpy = jobs.make_axpy(*sizes["axpy"])
    aops, _ = axpy.make_instance(0)
    nodes = [GraphNode(axpy, aops, name="wide"),
             GraphNode(axpy, {"x": aops["x"], "y": Ref("wide")},
                       name="narrow", clusters=list(range(16))),
             GraphNode(axpy, {"x": aops["x"], "y": Ref("narrow")},
                       name="tail")]

    def graph(ns):
        def run():
            gh = sess.submit_graph(ns)
            return gh.wait(), gh.findings
        return run

    case("OFLP104", f"{axpy.spec.name} serial reshard graph", graph(nodes),
         lambda f, fs: graph(perflint.apply(
             [g for g in fs if g.code == "OFLP104"], nodes=nodes).nodes),
         None)

    # OFLP105: a misaligned selection of 16 clusters
    mm = jobs.make_matmul()
    mops, mexp = mm.make_instance(0)
    mis = list(range(1, 17))
    case("OFLP105", f"{mm.spec.name} clusters 1..16",
         submit(mm, mops, AUTO, clusters=mis),
         lambda f, fs: submit(mm, mops, AUTO, clusters=list(
             perflint.apply([f], clusters=mis).clusters)),
         mexp)

    # OFLP106: a stage() whose residency no submit redispatches
    atax = jobs.make_atax(*sizes["atax"])
    xops, xexp = atax.make_instance(0)

    def staged_then_fresh():
        sess.stage(atax, xops, n=32)
        res = sess.submit(atax, xops, n=32).wait()
        return res, perflint.lint_session(sess)

    case("OFLP106", f"{atax.spec.name} stage() never reused",
         staged_then_fresh,
         lambda f, fs: submit(atax, xops, AUTO, n=32), xexp)

    # OFLP107: a fused list with donation off
    insts, exps = jobs.make_instances(axpy, 8, seed0=70)
    case("OFLP107", f"{axpy.spec.name} list of 8, donation off",
         submit(axpy, insts, AUTO, n=32),
         lambda f, fs: submit(axpy, insts,
                              perflint.suggested_policy([f], AUTO), n=32),
         np.stack(exps))

    sess.close()
    sync()
    launches = build.launch_counts()
    found = sorted({r["code"] for r in out["cases"]})
    check(found == [f"OFLP10{i}" for i in range(1, 8)],
          f"lint: codes run {found}")
    for name in KERNEL_JOBS:
        check(launches[name] > 0,
              f"the lint phase never launched the {name} kernel")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    agree = [r["code"] for r in out["cases"] if r["card_agrees"]]
    print(f"lint: the card agrees with the model's sign on {len(agree)} of "
          f"{len(out['cases'])} fixes ({', '.join(agree)})", flush=True)
    print("lint kernels: " + " ".join(f"{k}={v}"
                                      for k, v in launches.items()))
    print(f"lint phase: {out['seconds']:.1f} s", flush=True)
    return launches


def backup_phase(check, report, device=None, size=None):
    """``BackupOffload`` on the card: 32 logical clusters, primary 0-15,
    backup 16-31, the covariance job at the offload phase's larger size.
    Healthy runs, then a ``delay_hook`` that forces one reissue: every
    result within 1e-9 of ``expected``, the covariance kernel launched
    once a healthy run and twice (primary and backup) a reissued one, and
    overlapping sets refused.  The two windows are logical clusters of
    one card: the backup queues behind the primary, it does not race it
    on other hardware."""
    import numpy as np
    import torch
    from repro_torch.core import jobs
    from repro_torch.core.offload import OffloadRuntime
    from repro_torch.ft import BackupOffload, StepWatchdog, WatchdogConfig
    from repro_torch.kernels import build

    size = size or OFFLOAD_SIZES["covariance"][1]
    out = report.setdefault("backup", {})
    job = jobs.make_covariance(*size)
    rt = OffloadRuntime(device)
    primary, backup = list(range(16)), list(range(16, 32))
    print(f"== backup: BackupOffload, {job.spec.name}, primary clusters "
          f"0-15, backup 16-31", flush=True)
    ops, _ = job.make_instance(0)
    for sel in (primary, backup):           # each window's plan, warm
        rt.offload(job, ops, clusters=sel).wait()
    delays = []
    # the deadline's floor keeps a healthy dispatch far inside it
    bo = BackupOffload(rt, StepWatchdog(WatchdogConfig(min_deadline_s=5.0),
                                        estimate=0.02),
                       delay_hook=lambda h: delays.pop() if delays else 0.0)

    def run(seed, tag):
        before = build.launch_counts()["covariance"]
        if device is None:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, exp = bo.run(job, seed, primary=primary, backup=backup)
        ms = (time.perf_counter() - t0) * 1e3
        if device is None:
            torch.cuda.synchronize()
        err = float(np.max(np.abs(np.asarray(res) - exp)))
        check(bool(np.allclose(res, exp, **JOB_TOL)),
              f"backup {tag} run: off by {err:.3g}")
        return ms, err, build.launch_counts()["covariance"] - before

    healthy = [run(seed, "healthy") for seed in (1, 2, 3)]
    check(bo.reissues == 0 and all(n == 1 for _, _, n in healthy),
          f"backup healthy runs: {bo.reissues} reissues, launches "
          f"{[n for _, _, n in healthy]}")
    delays.append(10.0)
    re_ms, re_err, re_n = run(4, "reissued")
    check(bo.reissues == 1 and re_n == 2,
          f"backup: {bo.reissues} reissues, {re_n} covariance launches in "
          f"the reissued run")
    try:
        bo.run(job, 5, primary=primary, backup=[15, 16])
        refused = False
    except ValueError:
        refused = True
    check(refused, "backup: overlapping primary and backup sets accepted")
    out.update({"job": job.spec.name, "healthy_ms": [h[0] for h in healthy],
                "reissued_ms": re_ms, "reissues": bo.reissues,
                "max_abs_err": max([re_err] + [h[1] for h in healthy]),
                "overlap_refused": refused,
                "outstanding": sorted(rt.unit.outstanding().items())})
    check(out["outstanding"] == [],
          f"backup: completion unit left {out['outstanding']}")
    print(f"  healthy {', '.join(f'{h[0]:.2f}' for h in healthy)} ms "
          f"(1 covariance launch each); reissued {re_ms:.2f} ms ({re_n} "
          f"launches); reissues {bo.reissues}; err {out['max_abs_err']:.2g}; "
          f"overlap refused {refused}", flush=True)
    del rt, bo


def tenant_phase(check, report, served, device=None):
    """The lease-holding serve tenant at full width: a
    ``FabricScheduler`` of 32 logical clusters on the card and a
    ``ServeTenant`` that adopts the serving phase's Yi-9B model (floor
    ``TENANT["floor"]``, burst ``TENANT["burst"]``).  A ``generate``
    burst of the serving phase's prompts, an offload ``Session`` on a
    lease of the head-room running one covariance submit, the floor
    window failed, a second burst.  Checks: both bursts' greedy tokens
    are the serving phase's ``ServeEngine`` tokens, the flash kernel ran
    once per layer of each burst's prefill, one failover, no lease left
    after ``close()``, and the peak device memory under the serving
    phase's peak plus the window engines' caches (no second copy of the
    weights)."""
    import numpy as np
    import torch
    from repro_torch.core import jobs
    from repro_torch.core.fabric import FabricScheduler
    from repro_torch.kernels import build
    from repro_torch.models import init_cache
    from repro_torch.serve import ServeConfig, ServeTenant

    cfg, model = served["cfg"], served["model"]
    st = SERVE_STATIC
    out = report.setdefault("tenant", {})
    print(f"== tenant: ServeTenant over the serving phase's {cfg.name} "
          f"(floor {TENANT['floor']}, burst {TENANT['burst']} of 32 "
          f"clusters)", flush=True)

    def sync():
        if device is None:
            torch.cuda.synchronize()

    sync()
    if device is None:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    sched = FabricScheduler(device)
    check(sched.num_clusters == 32, "tenant: the fabric is not 32 clusters")
    scfg = ServeConfig(batch=st["batch"], max_len=served["max_len"])
    tenant = ServeTenant(sched, cfg, model, scfg, floor=TENANT["floor"],
                         burst=TENANT["burst"])
    host_us = {"grow": [], "shrink": []}
    for name in ("_grow", "_shrink"):
        def timed(fn=getattr(tenant, name), key=name[1:]):
            t0 = time.perf_counter()
            fn()
            host_us[key].append((time.perf_counter() - t0) * 1e6)
        setattr(tenant, name, timed)

    def burst():
        sync()
        t0 = time.perf_counter()
        toks = tenant.generate(served["prompts"], st["new_tokens"])
        sync()
        return toks, time.perf_counter() - t0

    build.reset_counts()
    toks1, s1 = burst()
    free_between = len(sched.free_clusters())
    check(tenant.lease.n == TENANT["floor"] and tenant.peak_burst
          == TENANT["burst"], f"tenant: lease {tenant.lease.clusters}, "
                              f"peak burst {tenant.peak_burst}")

    # an offload tenant takes the head-room between bursts
    cov = jobs.make_covariance(*OFFLOAD_SIZES["covariance"][1])
    cops, cexp = cov.make_instance(0)
    sess = sched.session("offload", n=16)
    off_window = sess.lease.clusters
    t0 = time.perf_counter()
    got = sess.submit(cov, cops).wait()
    off_ms = (time.perf_counter() - t0) * 1e3
    off_err = float(np.max(np.abs(got - cexp)))
    check(bool(np.allclose(got, cexp, **JOB_TOL))
          and not set(off_window) & set(tenant.lease.clusters),
          f"tenant: offload on {off_window} off by {off_err:.3g}")
    sess.close()

    floor_window = tenant.lease.clusters
    sched.fail_clusters(list(floor_window))
    toks2, s2 = burst()
    launches = build.launch_counts()
    peak = torch.cuda.max_memory_allocated() if device is None else 0
    failovers = sched.health().failovers
    windows = tenant.windows
    stats = tenant.stats
    tenant.close()
    leases = sched.leases

    want = served["tokens"]
    for i, toks in enumerate((toks1, toks2)):
        check(np.array_equal(toks, want),
              f"tenant burst {i + 1}: greedy tokens differ from the "
              f"serving phase's ServeEngine")
    check(launches["flash_attention"] == 2 * cfg.n_layers,
          f"tenant: flash_attention launched {launches['flash_attention']} "
          f"times over two bursts of {cfg.n_layers} layers")
    check(failovers == 1 and leases == (),
          f"tenant: failovers {failovers}, leases left {leases}")
    cache = init_cache(cfg, st["batch"], served["max_len"], device="meta")
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values()
                      if isinstance(t, torch.Tensor))
    bound = served["peak"] + len(windows) * cache_bytes
    if device is None:
        check(peak <= bound, f"tenant: peak {peak} B over {bound} B (the "
                             f"serving peak and {len(windows)} caches)")
    out.update({"windows": [list(w) for w in windows],
                "peak_burst": tenant.peak_burst, "stats": stats,
                "burst_s": [s1, s2], "free_between_bursts": free_between,
                "offload_window": list(off_window), "offload_ms": off_ms,
                "offload_err": off_err, "failed_window": list(floor_window),
                "failovers": failovers, "launches": launches,
                "grow_us": host_us["grow"], "shrink_us": host_us["shrink"],
                "peak_bytes": peak, "peak_bound_bytes": bound,
                "serving_peak_bytes": served["peak"],
                "cache_bytes": cache_bytes})
    grow_shrink = [g + s for g, s in zip(host_us["grow"], host_us["shrink"])]
    print(f"  bursts {s1:.3f} s, {s2:.3f} s wall; windows "
          f"{out['windows']}, peak burst {tenant.peak_burst}, free between "
          f"bursts {free_between}; offload covariance on {list(off_window)}"
          f" {off_ms:.2f} ms (err {off_err:.2g}); failed {list(floor_window)}"
          f", failovers {failovers}", flush=True)
    print(f"  host us of _grow + _shrink a burst: "
          f"{', '.join(f'{u:.1f}' for u in grow_shrink)}; flash launches "
          f"{launches['flash_attention']}; peak device memory {peak} B "
          f"(serving phase {served['peak']} B, bound {bound} B)", flush=True)
    print(f"  stats {stats}", flush=True)
    return launches


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
    from repro_torch.kernels.atax import card_plan as atax_plan

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

    # the tensor-core instructions in the built code (cuobjdump -sass)
    census = build.sass_census(built.path)
    with open(os.path.join(args.out, "sass_census.json"), "w") as f:
        json.dump(census, f, indent=1)
    report["sass_census"] = census
    for role, needs in SASS_NEEDS.items():
        found = {fn: c for fn, c in census.items() if role in fn}
        check(bool(found) and all(any(c[op] for op in needs)
                                  for c in found.values()),
              f"SASS: {role} lacks {' or '.join(needs)}: {found}")
        for fn, c in found.items():
            print(f"  sass {role}: " + ", ".join(
                f"{op} {n}" for op, n in c.items() if n), flush=True)

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
        for these shapes (timed as a yardstick only), as a function of the
        inputs."""
        if name == "axpy":
            return lambda x, y: torch.add(y, x, alpha=2.5)
        if name == "matmul":
            return torch.matmul
        if name == "atax":       # two calls: A^T (A x)
            if tensors[0].ndim == 2:
                return lambda a, x: torch.mv(a.T, torch.mv(a, x))
            if tensors[0].ndim == 3:
                return lambda a, x: torch.bmm(
                    a.mT, torch.bmm(a, x.unsqueeze(-1)))
            return None
        if tensors[0].ndim != 2:
            return None          # no single batched call for covariance
        return torch.cov

    def held(name, tag, got, want, tol, shapes):
        """Record and check one kernel result against its plain version;
        fp64 covariance must also be exactly symmetric."""
        torch.cuda.synchronize()
        g, w = got.double(), want.double()
        err = (g - w).abs().max().item() if g.numel() else 0.0
        ok = (got.shape == want.shape and got.dtype == want.dtype
              and bool(((g - w).abs() <= tol["atol"]
                        + tol["rtol"] * w.abs()).all()))
        if name == "covariance":
            ok = ok and (torch.equal(got, got.mT)
                         if got.dtype == torch.float64 else
                         bool(((g - g.mT).abs() <= 1e-5
                               + 1e-5 * g.abs()).all()))
        row = {"kernel": name, "tag": tag, "dtype": str(got.dtype),
               "shapes": shapes, "max_abs_err": err, "tol": tol, "ok": ok}
        report["kernel_checks"].append(row)
        check(ok, f"{name} {tag} {shapes} {got.dtype}: kernel vs plain "
                  f"max_abs_err {err:.3g} outside {tol}")
        return err

    def compare(name, tensors, tol, tag):
        return held(name, tag, call(name, tensors, "kernel"),
                    call(name, tensors, "plain"), tol,
                    [list(t.shape) for t in tensors])

    def timed(name, tensors, tag):
        dtype = tensors[0].dtype
        sets = rotation(tensors, work(name, [tuple(t.shape) for t in tensors],
                                      dtype)[0])

        def kernel(*ts):
            return call(name, ts, "kernel")

        row = {"kernel": name, "tag": tag, "dtype": str(dtype),
               "shapes": [list(t.shape) for t in tensors],
               "ms": time_ms(lambda: kernel(*tensors)),
               "device_ms": device_ms(kernel, sets),
               "plain_ms": time_ms(lambda: call(name, tensors, "plain"))}
        lib = library(name, tensors)
        row["library_ms"] = (time_ms(lambda: lib(*tensors))
                             if lib is not None else None)
        row["library_device_ms"] = (device_ms(lib, sets)
                                    if lib is not None else None)
        del sets
        row["bound_ms"], row["bound_by"] = bound(name, tensors, dtype)
        if name == "atax":
            # the launch plan (its wave is the card's own count of the
            # clusters it holds at once), and the same bits from two calls
            *lead, m, n = tensors[0].shape
            p = atax_plan(tensors[0].get_device(), int(np.prod(lead)), m, n,
                          dtype)
            row["plan"] = dataclasses.asdict(p)
            print(f"  atax plan {tag} {row['shapes']} {dtype}: {p}; "
                  f"cudaOccupancyMaxActiveClusters {p.wave}", flush=True)
            same = torch.equal(kernel(*tensors), kernel(*tensors))
            row["bit_identical"] = same
            check(same, f"atax {tag} {row['shapes']} {dtype}: two calls "
                        f"differ")
        report["kernel_times"].append(row)
        lib_s = ("-" if row["library_ms"] is None
                 else f"{row['library_ms']:.4f} (device "
                      f"{row['library_device_ms']:.4f})")
        print(f"  time {name:10s} {tag:22s} {str(dtype):14s} "
              f"{row['shapes']}: kernel {row['ms']:.4f} ms (device "
              f"{row['device_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
              f"library {lib_s} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
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
        if name in ("matmul", "atax"):    # the other cluster counts' shards
            for n in (1, 8):
                timed(name, job_shapes(name, OFFLOAD_SIZES[name][1], n),
                      f"job large n={n}")
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

    print("== kernels: the fp64 SYRK's, axpy's and atax's hard cases",
          flush=True)
    f64 = torch.float64
    hard = len(report["kernel_checks"])
    hard_rng = np.random.default_rng(45)

    def hard_rnd(shape, dtype):        # the large shapes keep their draws
        return torch.from_numpy(
            hard_rng.standard_normal(shape)).to(dtype).to(dev)

    # M off the 16/32/64 tiles, N off the 16-deep panels
    for m in (1, 2, 17, 33, 65, 130):
        for n in (2, 17, 100):
            compare("covariance", [hard_rnd((3, m, n), f64)], JOB_TOL,
                    "ragged")
    # a large mean: the zero fill past N, left unmasked after centring,
    # would add (padded k) * mu_i * mu_j ~ 1e6 to every entry
    for shape in ((3, 65, 100), (2, 130, 17), (1, 33, 2)):
        compare("covariance", [hard_rnd(shape, f64) + 1e3], JOB_TOL,
                "offset +1e3")
    # one element off a 16-byte boundary: the 8-byte copies
    for shape in ((3, 33, 100), (2, 65, 17)):
        view = hard_rnd(1 + int(np.prod(shape)), f64)[1:].view(shape)
        compare("covariance", [view], JOB_TOL, "view off 16 B")
    # axpy: ragged lengths, and x, y at offsets (elements) from the
    # allocator's 512-byte alignment; z is fresh, so the 16-byte packs run
    # only at (0, 0), the rest one element at a time
    axpy_count = build.KERNELS["axpy"]
    from repro_torch.kernels.axpy import axpy as axpy_wrapper
    for dt in (f64, f32, bf16):
        tol = JOB_TOL if dt == f64 else elem_tol[dt]
        for n in (1, 7, 4097, (1 << 20) + 3):
            compare("axpy", [hard_rnd(n, dt), hard_rnd(n, dt)], tol,
                    "length")
            for offs in ((1, 1), (3, 3), (1, 2), (0, 1)):
                x, y = (hard_rnd(n + 3, dt)[o:o + n] for o in offs)
                before = axpy_count.launches
                got = axpy_wrapper(x, y, 2.5)
                check(axpy_count.launches == before + 1,
                      f"axpy offsets {offs}: not one launch")
                held("axpy", f"offsets {offs}", got, ref.axpy(x, y, 2.5),
                     tol, [[n], [n], [n]])
    # atax: every case one launch of the kernel, held to its plain version
    atax_count = build.KERNELS["atax"]
    from repro_torch.kernels.atax import atax as atax_wrapper
    atax_rng = np.random.default_rng(46)
    atax_tol = {f64: JOB_TOL, f32: dict(rtol=2e-3, atol=2e-3),
                bf16: dict(rtol=1e-2, atol=1e-2)}

    def atax_rnd(shape, dtype):
        return torch.from_numpy(
            atax_rng.standard_normal(shape)).to(dtype).to(dev)

    def atax_case(a, x, tag):
        before = atax_count.launches
        got = atax_wrapper(a, x)
        check(atax_count.launches == before + 1,
              f"atax {tag} {list(a.shape)}: not one launch")
        held("atax", tag, got, ref.atax(a, x), atax_tol[a.dtype],
             [list(a.shape), list(x.shape)])

    for dt in (f64, f32, bf16):
        for m in ATAX_HARD_M:
            for n in ATAX_HARD_N:
                for b in (1, 3):
                    atax_case(atax_rnd((b, m, n), dt), atax_rnd((b, n), dt),
                              "ragged")
        for b, m, n in ATAX_VIEWS:
            a = atax_rnd(b * m * n + 1, dt)[1:].view(b, m, n)
            x = atax_rnd(b * n + 1, dt)[1:].view(b, n)
            atax_case(a, x, "view off 16 B")
    print(f"  {len(report['kernel_checks']) - hard} hard-case comparisons "
          f"done", flush=True)

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
                    results = [got] + [w[0] for w in warm + res]
                    match = all(np.allclose(r, expected, **JOB_TOL)
                                for r in results)
                    if name == "covariance":     # exactly symmetric
                        match = match and all(
                            np.array_equal(r, np.swapaxes(r, -1, -2))
                            for r in results)
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
            if name == "covariance":             # exactly symmetric
                ok = ok and all(np.array_equal(o, o.T) for o in outs)
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

    # -- 3c. the session layer over the same runtime ----------------------
    session_launches = session_phase(check, report)
    for name in KERNEL_JOBS:
        check(session_launches[name] > 0,
              f"the session path never launched the {name} kernel")
    torch.cuda.empty_cache()

    # -- 3d-3e. the perf linter's fixes, then BackupOffload ---------------
    lint_phase(check, report)
    torch.cuda.empty_cache()
    backup_phase(check, report)
    torch.cuda.empty_cache()

    # -- 4-5. flash attention, the serving path, the serve tenant ---------
    flash_row = flash_phase(check, report, time_ms)
    torch.cuda.empty_cache()
    served = serving_phase(check, report)
    serve_launches = served["launches"]
    tenant_phase(check, report, served)
    del served

    # -- 6-7. the SSM scan, then serving falcon-mamba ----------------------
    torch.cuda.empty_cache()
    scan_row = scan_phase(check, report, time_ms)
    torch.cuda.empty_cache()
    ssm_launches = ssm_serving_phase(check, report)

    # -- 8. what the main paths launched, and the result lines ---------------
    launches["flash_attention"] = serve_launches["flash_attention"]
    launches["ssm_scan"] = ssm_launches["ssm_scan"]
    print("kernels: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    for name in KERNEL_JOBS + ("flash_attention", "ssm_scan"):
        check(launches[name] > 0,
              f"its main path never launched the {name} kernel")
    line = []
    rows = dict(main_rows, flash_attention=flash_row, ssm_scan=scan_row)
    for name in KERNEL_JOBS + ("flash_attention", "ssm_scan"):
        k = build.KERNELS[name]
        row = rows[name]
        line.append({"name": name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": launches[name],
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"],
                     "device_ms": row["device_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"],
                     "library_device_ms": row["library_device_ms"],
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
