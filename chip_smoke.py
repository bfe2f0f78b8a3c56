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
   The resident dispatches of this phase replay captured CUDA graphs
   (``core/graphs.py``), and the counts include their launches.  Then
   the resident dispatch as a graph against the same dispatch run eagerly
   (``graphs_offload_phase``: six jobs x {baseline, extended} x n at the
   larger sizes; results at 1e-9 and bit-identical to eager, traces
   equal, each graph one chain of dependent nodes with the baseline's
   2(n-1) hops in it, read from libcuda; resident ms alternated), the
   session layer (``session_phase``), the perf linter
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
   weights.  Then the decode programs as graphs (``graphs_phase``): every
   mode's captured tokens, and ``generate_many``'s, identical to an
   engine running the same bodies eagerly, seeded temperature draws
   too; decode ms per step, eager body against the captured step and
   chunk graphs, alternated, with busy shares, capture seconds, pool
   bytes, node counts and the bytes a step must move.
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
   times, peak memory and busy shares; then ``graphs_phase`` as for
   Yi-9B.
8. Serving zamba2-2.7b (the fourth main path, the hybrid family): 54
   Mamba-2 layers (d 2560, d_inner 5120 = 80 heads x 64, N 64) and the
   shared attention block (32/32 heads of 80) after every 6th, at its
   published width (2,422,670,240 float32 weights from a seeded
   generator, bf16 compute), the same prompts and modes as falcon-mamba;
   every prefill must run the scan kernel 108 times (a chunk of 256 of
   every layer) and the flash kernel 9 times; the prefill logits with both
   kernels against both plain versions; then ``graphs_phase``.  The flash
   and scan phases also time the two kernels at this model's shapes (q
   (4, 32, 512, 80) bf16; a, b (4, 256, 5120, 64) f32) and the expanded
   decay of one of its chunks; the flash phase also times musicgen-large's
   prefill call (q = kv = (4, 32, 512, 64) bf16, causal; step 10) and
   smollm-360m's forward on its trained weights (q (8, 15, 2048, 64), kv
   (8, 5, 2048, 64) bf16, causal; step 11).
9. Serving the MoE family (``moe_serving_phase``): deepseek-v2-lite-16b
   at its published width and depth, nothing cut (27 layers, d 2048; MLA
   with 16 heads, kv_lora 512, nope 128, rope 64, v 128; 64 routed
   experts top-6 of 1408 and 2 shared; 16,210,324,992 float32 weights
   from a seeded generator on the card, bf16 compute, the earlier models
   released and the free memory printed first; the engine narrows the
   weights each use casts to bf16 once, in their own storage, when it
   adopts them, so the card holds no second copy).  The same prompts
   and modes as falcon-mamba, routed without drops; ``generate_many``
   raises (MLA), as the reference's does; no flash or scan launch in the
   whole run ("auto" resolves to the plain attention for MLA's 192/128
   head dims).  Its decode step against the full-sequence path in float32
   compute (relative L2 within 1e-3; the bf16 figure printed), prefill
   and decode times, peak memory, the top device ops of a prefill and a
   captured step, then ``graphs_phase``.  Then the same prompts through
   ``generate`` as the long-prompt cell calls it (attn_impl "chunked",
   chunk 512): the MLA kernel launched once a layer in its prefill (27),
   counted from 0 and summed into the kernels line.  Then llama4-scout-17b-a16e at
   its reduced size (MoE with GQA; the full model is 431 GB of f32):
   ``generate`` in every mode and ``generate_many`` (the MoE ragged step),
   one flash launch a layer a prefill, its prefill logits with the flash
   kernel against the plain attention in bf16 and f32 compute (q (4, 4,
   512, 32) against k/v (4, 2, 512, 32)), and its ``graphs_phase``.  (The
   session phase's retry runs at n = 8 and n = 32: the bisection probe is
   sized by ``faults.probe_size``.)
10. Serving the modality frontends (``frontend_serving_phase``), each at
   its published width and depth (float32 weights from a seeded generator
   on the card, bf16 compute), the same prompts and modes as falcon-mamba,
   ``generate_many`` raising as the reference's does, then each model's
   ``graphs_phase``: paligemma-3b (18 layers, d 2048, 8/1 heads of 256,
   2,508,662,784 weights) with 256 positions of precomputed patches from
   the prompts' stream before each prompt under the prefix-LM mask, so its
   attention runs plain and no flash or scan launch moves over its phase;
   its decode step after the prefix against the full-sequence path in
   float32 compute (relative L2 within 1e-3; the bf16 figure printed).
   Then musicgen-large (48 layers, d 2048, 32 heads of 64, sinusoidal
   positions; 3,229,812,736 weights): 48 flash launches a prefill and its
   prefill logits with the kernel against the plain attention.
11. Training (``train_phase``, the training substrate): smollm-360m at
   its published width and depth (32 layers, d 960, 15/5 heads of 64,
   d_ff 2560, vocab 49152 tied; 361,821,120 float32 weights from a seeded
   generator on the card, bf16 compute) through ``repro_torch.train``'s
   ``build_train_step``: the synthetic stream's 8 x 2048 tokens a step,
   ``TrainConfig(base_lr=1e-3, warmup_steps=2, total_steps=20)``, the plain
   attention under autograd with remat (the kernels have no backward),
   8 logical data ways.  Steps 0-5 with finite losses and grad norms and
   the loss falling; a checkpoint after step 3 in the reference's format;
   from it, 2 microbatches against 1 (loss within 1e-4 relative, the
   gradients within 1e-2 relative L2) and AdamW timed on copies;
   ``restore`` and steps 4-5 replayed to the same loss bits;
   ``elastic_restore`` onto 2 data ways, every array bit-identical; the
   grad guard (the flash kernel through ``forward(attn_impl="auto")`` and
   the scan through ``ops.ssm_scan`` raise under autograd); one step's
   busy share (``torch.profiler``); then the trained weights' logits with
   the flash kernel against the plain attention under ``torch.no_grad``
   (relative L2 within 5 %, 32 launches).  It prints step ms (median of
   steps 1-5, CUDA events), tokens/s, AdamW ms, peak memory and the
   checkpoint's seconds beside the card's name and power limit.
12. The launch layer (``launch_phase``, ``repro_torch.launch``): the
   train CLI as a user starts it (``python -m repro_torch.launch.train``,
   smollm-360m at full width and depth, 8 x 2048 tokens a step, ``--mesh
   1x1``): run A trains 8 steps with a checkpoint every 3; run B resumes
   from a copy of A's step-6 checkpoint to step 8, and every array of its
   step-8 checkpoint must equal A's bit for bit.  Meanwhile the dry-run
   CLI counts smollm-360m's ``train_4k`` cell on ``meta`` and the report
   CLI must show its ``ok`` row.  Then the H100 roofline against the
   card: the CLI's train step counted by ``op_cost`` on ``meta`` and timed
   (median of 3 steps), its bound at most 1.05 x the step; ``op_cost``'s
   peak within [0.5, 2] x ``max_memory_allocated`` over the step; the
   prefill of 8 x 2048 tokens through the flash kernel against
   ``flashsub.substitute`` of the stub-attention count, bound at most
   1.05 x measured (128 flash launches in 4 prefills); a bf16 8192^3
   matmul under ``PEAK_FLOPS_BF16`` and a 4 GB copy under ``HBM_BW``; a
   checkpoint save and restore timed.
13. The chunked attention's per-chunk remat (``chunk_remat_phase``,
   ``CallConfig.attn_chunk_remat``): smollm-360m at full width and depth,
   4 x 4096 tokens a step (the ``train_4k`` cells' sequence) through
   ``build_train_step`` with the train CLI's config, the chunked attention
   (chunks of 512) under layer remat, the knob off and on, steps
   alternated after a warm-up each (median of 3, CUDA events): step ms,
   tokens/s, ``max_memory_allocated`` over each step's start, ``op_cost``'s
   FLOPs, bytes and peak of the same step on ``meta`` and the roofline's
   bound over the step (at most 1.05); the loss the same bits and the
   gradients of one step within 1e-5 relative L2, off against on; one
   decoder layer's forward and backward, its peak off against on; the
   peaks lower and the counted FLOPs higher with the knob on; no kernel
   launch (the kernels have no backward).
14. The walkthroughs (``examples_phase``): the five ``examples/torch_*.py``
   started together, each a process of its own with ``--device cuda``;
   rc 0 and their printed facts (every ``allclose=True``, OFL001, the
   bit-identical autofix, the resume, a falling loss); each process's
   axpy, flash and scan launches counted (not part of the main paths'
   counts below); the serving walkthrough's three models rebuilt here,
   every flash and scan call of their prefill (head dim 32, 16 query
   rows, one 16-token scan chunk) held against the plain version on its
   own inputs, as many as the walkthrough launched, and the prefill
   logits, kernels against plain versions.
15. The ``kernels:`` line with the counts (the flash kernel's from
   Yi-9B's, zamba2's, the reduced llama4's, musicgen's, the training
   phase's and the launch phase's runs, the scan's from falcon-mamba's
   and zamba2's), one JSON
   line of the kernels' numbers, the card line, and last ``{"ok": true,
   "device": {...}}``.

Any failed check exits non-zero without the last line.  Everything
measured is also written to ``DIR/chip_smoke.json`` (default
``chiprun_out/`` beside this file).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
#: the device ops a profile lists, by time
TOP_OPS = 10
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
MODEL_KERNELS = ("flash_attention", "ssm_scan", "decode_attention",
                 "mla_attention")
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
#: instance, by the kernel's name): the bf16 flash and MLA kernels a
#: tensor-core product, the fp64 matmul and covariance DMMA, atax the bulk
#: copy (cp.async.bulk) that brings its row panels in
SASS_NEEDS = {"flash_wgmma_kernel": ("HGMMA", "HMMA"),
              "mla_attention_kernel": ("HGMMA",),
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
#: the hybrid serving phase: zamba2-2.7b at its published width, and one
#: scan call of its prefill (a chunk of 256 tokens of the 4 prompts, D =
#: H·P = 80·64, N 64), and one flash call (its shared block's 32 heads of
#: 80 over the 512-token prompts)
HYBRID_ARCH = "zamba2-2.7b"
HYBRID_STATIC = dict(batch=4, prompt_len=512, new_tokens=32, decode_chunk=8)
HYBRID_SCAN_SHAPE = (4, 256, 5120, 64)
HYBRID_FLASH_SHAPE = ((4, 32, 512, 80), (4, 32, 512, 80))
#: the scan kernel against ref.ssm_scan: tests/test_kernels.py:139 in f32
#: (the two sum in another order, and the kernel fuses each step's
#: multiply-add); in bf16 both round one f32 result to bf16 once
#: the MoE family: deepseek-v2-lite-16b (MoE with MLA attention) at its
#: published width and depth, nothing cut (64.84 GB of f32 weights), then
#: llama4-scout-17b-a16e (MoE with GQA) at its reduced size only: the full
#: model's 107.8 G parameters are 431 GB of f32, more than one card holds
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_STATIC = dict(batch=4, prompt_len=512, new_tokens=32, decode_chunk=8)
MOE_GQA_ARCH = "llama4-scout-17b-a16e"
#: the modality frontends, each at its published width and depth:
#: paligemma-3b (the vision stub: 256 prefix positions of precomputed
#: patches under a prefix-LM mask, so its attention runs plain) and
#: musicgen-large (the audio stub: 32 heads of 64 through the flash kernel;
#: one flash call of its prefill below)
VISION_ARCH = "paligemma-3b"
AUDIO_ARCH = "musicgen-large"
FRONTEND_STATIC = dict(batch=4, prompt_len=512, new_tokens=32, decode_chunk=8)
AUDIO_FLASH_SHAPE = ((4, 32, 512, 64), (4, 32, 512, 64))
#: smollm-360m's trained-weights forward (train_phase): 15/5 heads of 64
TRAIN_FLASH_SHAPE = ((8, 15, 2048, 64), (8, 5, 2048, 64))
#: the MLA kernel at the long-prompt cell's longest call: (B, H, S),
#: q/k of 192 and v of 128, and DeepSeek-V2-Lite's softmax scale under its
#: YaRN (m(40, 0.707)² / sqrt(192)); the checks' shapes (B, H, Sq, Skv),
#: held to the f32 loop within MLA_REL_L2 (one bf16 rounding of an f32
#: result is about 1.6e-3 relative L2)
MLA_SHAPE = (4, 16, 13777)
MLA_SCALE = 1.5896321 / 192 ** 0.5
MLA_CHECKS = ((1, 2, 64, 64), (2, 4, 300, 300), (1, 2, 100, 300),
              (1, 2, 130, 65), (4, 16, 4871, 4871))
MLA_REL_L2 = 4e-3
#: at MLA_SHAPE, the share of outputs that are not the f32 loop's result
#: rounded to bf16: P split into a bf16 head and tail leaves 0.81 % (one
#: ulp each), P rounded to bf16 alone 37 % (measured on an H100), so this
#: bar holds the kernel to the split
MLA_OFF_ROUNDED = 2e-2
#: the bf16 peak the benchmark's shares read (bench/work.py)
MLA_PEAK_OPS_PER_S = 989.4e12
#: Yi-9B's batch-decode step: (rows, query heads, positions, KV heads, d)
DECODE_SHAPE = (256, 32, 1024, 4, 128)
#: every GQA/MHA configuration of the registry: (Hq, Hkv, d) and a name
DECODE_REGISTRY = (((40, 10, 128), "phi3"), ((64, 8, 128), "qwen1.5"),
                   ((15, 5, 64), "smollm"), ((40, 8, 128), "llama4"),
                   ((8, 1, 256), "paligemma"), ((32, 32, 80), "zamba2"),
                   ((32, 32, 64), "musicgen"), ((4, 2, 32), "reduced"),
                   ((4, 1, 32), "reduced 4:1"))
#: a decode step's logits against the full-sequence path's (deepseek's
#: MLA step, paligemma's step after its prefix), float32 compute, as a
#: relative L2 distance (the bar of the same comparison in
#: tests/test_models_smoke.py:70-72)
DECODE_TOL = 1e-3
SCAN_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
            "bfloat16": dict(rtol=1e-2, atol=1e-2)}
#: the training phase: smollm-360m at full width and depth, the synthetic
#: stream's batches of 8 x 2048 tokens, 8 logical data ways (a row a way)
TRAIN_ARCH = "smollm-360m"
TRAIN_DATA = dict(batch_size=8, seq_len=2048, seed=0)
TRAIN_CFG = dict(base_lr=1e-3, warmup_steps=2, total_steps=20)
TRAIN_STEPS = 6            # steps 0-5; the checkpoint after step 3
TRAIN_SAVE = 4
TRAIN_MESH = (("data", "model"), (8, 1))
TRAIN_ELASTIC_WAYS = 2
TRAIN_EVAL_BATCH = 6
#: microbatching: the loss at the reference's bar
#: (tests/test_substrate.py:71), the gradients as a relative L2
TRAIN_MB_TOL = dict(loss_rel=1e-4, grad_rel_l2=1e-2)
#: the launch phase: the train CLI's smollm-360m at train_phase's shape,
#: run A's 8 steps (a checkpoint every 3) and run B resumed at step 6; the
#: peaks' product and copy; a roofline bound may be at most 1.05 x the
#: measured time, op_cost's peak within [0.5, 2] x the card's
LAUNCH_ARCH = "smollm-360m"
LAUNCH = dict(batch=8, seq=2048, steps=8, ckpt_every=3, resume_at=6,
              matmul_n=8192, copy_bytes=4_000_000_000)
LAUNCH_ROOF_MAX = 1.05
LAUNCH_MEM_RATIO = (0.5, 2.0)
#: the chunked attention's per-chunk remat: smollm-360m at the train_4k
#: cells' sequence, 4 x 4096 tokens a step (the 16,384 of train_phase's 8 x
#: 2048), the train CLI's config; steps alternated off / on after one
#: warm-up each; the two settings' gradients of one step as a relative L2
#: (the forward and loss are the same bits; atomics in the embedding's
#: backward may reorder sums)
CHUNK_REMAT_ARCH = "smollm-360m"
CHUNK_REMAT = dict(batch=4, seq=4096, chunk=512, steps=3)
CHUNK_REMAT_GRAD_REL = 1e-5
#: the walkthroughs of the port, each run as a script on the card (all
#: but the model validation, which touches no device, with ``--device``)
EXAMPLES = ("torch_offload_model_validation", "torch_quickstart",
            "torch_job_graph", "torch_serve_batch", "torch_train_lm")
#: the lint phase: alternating passes of each original and fixed submission
#: (after one warm pass each)
LINT_PASSES = 5
#: the serve tenant: its floor lease and burst size, in logical clusters
TENANT = dict(floor=1, burst=8)
#: the graphs phases: alternated timing passes (eager, captured, captured,
#: eager) of each resident dispatch; decode steps timed a pass; the seeded
#: temperature run
GRAPH_PASSES = 3
GRAPH_STEPS = 16
GRAPH_TEMP = dict(temperature=1.5, seed=11, new_tokens=10)


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


def held_attention(check, report, q, k, v, causal, tag):
    """The flash kernel on ``q, k, v`` against ``ref.attention`` on the
    same inputs within ``FLASH_TOL``, recorded and checked; returns the
    largest error."""
    import torch
    from repro_torch.kernels import ops, ref

    got = ops.attention(q, k, v, causal=causal, impl="kernel")
    want = ref.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = FLASH_TOL[str(q.dtype).split(".")[1]]
    g, w = got.double(), want.double()
    err = (g - w).abs().max().item()
    ok = (got.shape == want.shape and got.dtype == want.dtype
          and bool(torch.isfinite(g).all())
          and bool(((g - w).abs() <= tol["atol"]
                    + tol["rtol"] * w.abs()).all()))
    qs, ks = list(q.shape), list(k.shape)
    sq, skv = qs[2], ks[2]
    if causal and sq > skv:
        # rows that see no column: the mean of V, as ref.attention
        mean = v.double().mean(dim=2, keepdim=True).repeat_interleave(
            qs[1] // ks[1], dim=1).expand(-1, -1, sq - skv, -1)
        e = (g[:, :, :sq - skv] - mean).abs()
        ok = ok and bool((e <= tol["atol"]
                          + tol["rtol"] * mean.abs()).all())
    report["kernel_checks"].append(
        {"kernel": "flash_attention", "tag": tag, "dtype": str(q.dtype),
         "shapes": [qs, ks], "causal": causal,
         "max_abs_err": err, "tol": tol, "ok": ok})
    check(ok, f"flash_attention {tag} q{qs} kv{ks} {q.dtype} "
              f"causal={causal}: max_abs_err {err:.3g} outside {tol}")
    return err


def held_scan(check, report, a, b, c, h0, tag, return_state=None):
    """The scan kernel on ``a, b, c`` (and ``h0``) against
    ``ref.ssm_scan`` on the same inputs within ``SCAN_TOL`` (the final
    state, f32, at the f32 bar), recorded, checked and printed; the state
    is returned when ``return_state`` says so (by default, with ``h0``).
    Returns the larger error."""
    import torch
    from repro_torch.kernels import ops, ref

    state = h0 is not None if return_state is None else return_state
    got = ops.ssm_scan(a, b, c, h0=h0, return_state=state, impl="kernel")
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
         "shapes": [shape, list(c.shape)], "h0": h0 is not None,
         "state": state, "max_abs_err": err, "tol": tol, "ok": ok})
    check(ok, f"ssm_scan {tag} {shape} {a.dtype} h0={h0 is not None}: "
              f"max_abs_err {err:.3g} outside {tol}")
    print(f"  {tag:14s} {shape} {str(a.dtype):14s} h0={h0 is not None!s:5s}: "
          f"max_abs_err {err:.3g}", flush=True)
    return err


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
        return (q, k, v), held_attention(check, report, q, k, v, causal, tag)

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
    timed(*HYBRID_FLASH_SHAPE, "zamba2 prefill")   # head dim 80, padded
    timed(*AUDIO_FLASH_SHAPE, "musicgen prefill")  # head dim 64
    timed(*TRAIN_FLASH_SHAPE, "smollm forward")    # GQA 15/5, 2048
    timed(*FLASH_OPS_SHAPE, "operations-bound")
    return row


def mla_phase(check, report, time_ms):
    """The MLA kernel against the chunked loop run in f32 on the card, and
    its times at the long-prompt cell's longest call: the kernel's device
    ms, its bound (the least causal operations, 2·(192 + 128) per visible
    (row, column) pair and head, at the bf16 peak), the loop's ms as the
    port ran it before the kernel (bf16 in), and
    ``scaled_dot_product_attention``'s where it takes 192/128 (a yardstick
    only: the port never calls it).  Returns the timed row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops
    from repro_torch.models import attention as attn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(47)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def loop(q, k, v):
        return attn._chunked_attention(q, k, v, prefix_len=0, chunk=512,
                                       scale=MLA_SCALE)

    def rel_l2(got, want):
        d = got.double() - want.double()
        return (d.norm() / want.double().norm()).item()

    print("== MLA attention against the f32 chunked loop", flush=True)
    for b, h, sq, skv in MLA_CHECKS:
        q, k, v = rnd(b, h, sq, 192), rnd(b, h, skv, 192), rnd(b, h, skv, 128)
        got = ops.mla_attention(q, k, v, scale=MLA_SCALE, impl="kernel")
        err = rel_l2(got, loop(q.float(), k.float(), v.float()))
        ok = bool(torch.isfinite(got.float()).all()) and err <= MLA_REL_L2
        report["kernel_checks"].append(
            {"kernel": "mla_attention", "shapes": [[b, h, sq, skv]],
             "dtype": "torch.bfloat16", "rel_l2": err, "tol": MLA_REL_L2,
             "ok": ok})
        check(ok, f"mla_attention q{[b, h, sq, 192]} kv{[b, h, skv]}: "
                  f"relative L2 {err:.3g} to the f32 loop, bar {MLA_REL_L2}")
        print(f"  ({b}, {h}, {sq}, {skv}): relative L2 {err:.3g}", flush=True)
        del q, k, v, got

    b, h, s = MLA_SHAPE
    q, k, v = rnd(b, h, s, 192), rnd(b, h, s, 192), rnd(b, h, s, 128)
    before = build.KERNELS["mla_attention"].launches
    got = attn.multihead_attention(q, k, v, impl="chunked", scale=MLA_SCALE)
    check(build.KERNELS["mla_attention"].launches == before + 1,
          "the chunked MLA call did not launch the MLA kernel")
    want = loop(q.float(), k.float(), v.float())
    err = rel_l2(got, want)
    max_err = (got.double() - want.double()).abs().max().item()
    off = (got != want.to(torch.bfloat16)).double().mean().item()
    check(err <= MLA_REL_L2, f"mla_attention {list(MLA_SHAPE)}: relative "
                             f"L2 {err:.3g} to the f32 loop")
    check(off <= MLA_OFF_ROUNDED,
          f"mla_attention {list(MLA_SHAPE)}: {off:.4f} of the outputs are "
          f"not the f32 loop's rounded to bf16, bar {MLA_OFF_ROUNDED}")
    del got, want
    torch.cuda.empty_cache()

    def kernel(q, k, v):
        return ops.mla_attention(q, k, v, scale=MLA_SCALE, impl="kernel")

    def events_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    nops = 2 * (192 + 128) * b * h * s * (s + 1) // 2
    row = {"kernel": "mla_attention", "tag": "long-prompt prefill",
           "dtype": str(torch.bfloat16),
           "shapes": [[b, h, s, 192], [b, h, s, 128]], "rel_l2": err,
           "off_rounded": off, "max_abs_err": max_err, "ms": time_ms(lambda: kernel(q, k, v)),
           "device_ms": device_ms(kernel, [(q, k, v)]),
           "plain_ms": events_ms(lambda: loop(q, k, v), 3),
           "bound_ms": nops / MLA_PEAK_OPS_PER_S * 1e3,
           "bound_by": "operations"}
    try:
        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  scale=MLA_SCALE)
        row["library_ms"] = events_ms(lambda: sdpa(q, k, v), 3)
        row["library_device_ms"] = device_ms(sdpa, [(q, k, v)])
    except RuntimeError as e:     # no backend for 192/128, or no memory
        row["library_ms"] = row["library_device_ms"] = None
        row["library_error"] = str(e).splitlines()[0][:200]
    del q, k, v
    torch.cuda.empty_cache()
    report["kernel_times"].append(row)
    lib = ("-" if row["library_ms"] is None else
           f"{row['library_ms']:.3f} ms (device "
           f"{row['library_device_ms']:.3f})")
    print(f"  time mla_attention bf16 ({b}, {h}, {s}, 192/128), causal, "
          f"YaRN scale: relative L2 {err:.4g}, {off:.4f} off the f32 loop "
          f"rounded; kernel {row['ms']:.3f} ms (device "
          f"{row['device_ms']:.3f}), bound {row['bound_ms']:.3f} ms "
          f"({nops} ops at {MLA_PEAK_OPS_PER_S:.4g}/s; "
          f"{row['bound_ms'] / row['device_ms']:.3f} of the peak), chunked "
          f"loop {row['plain_ms']:.1f} ms, library_ms {lib}"
          + (f" ({row['library_error']})" if row["library_ms"] is None
             else ""), flush=True)
    return row


def decode_work(lengths, hkv, d, itemsize):
    """Bytes one decode-attention call needs: the live K and V rows of each
    row's KV heads, read once (q and the output are a few KB); ``lengths``
    at most Smax."""
    return 2 * sum(lengths) * hkv * d * itemsize


def decode_phase(check, report, time_ms):
    """The decode-attention kernel against its plain version on the card:
    at Yi-9B's batch-decode step (256 rows of 1024 positions, 32/4 heads
    of 128, bf16) with the batch-decode mix's positions, and at every GQA
    and MHA configuration of the registry in bf16 and f32.  Times the
    batch-decode call beside its plain version and its bound (the live K
    and V bytes).  Returns that row of the kernels line."""
    import torch
    from repro_torch.kernels import decode_attention as dec, ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(47)
    print("== decode attention against its plain version", flush=True)

    def inputs(b, hq, hkv, d, smax, dtype):
        return [torch.randn(shape, generator=g, device=dev).to(dtype)
                for shape in ((b, hq, d), (b, smax, hkv * d),
                              (b, smax, hkv * d))]

    def held(q, k, v, lens, tag):
        d = q.shape[-1]
        got = ops.decode_attention(q, k, v, lens, scale=d ** -0.5)
        want = dec.plain(q.float(), k, v, lens, scale=d ** -0.5)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        # f32 rounding, and one rounding to bf16 of unit-scale outputs
        tol = 2e-5 if q.dtype == torch.float32 else 2 ** -8 * (
            want.abs().max().item()) + 2e-5
        check(err <= tol, f"decode_attention {tag}: max_abs_err {err:.3g} "
                          f"past {tol:.3g}")
        report["kernel_checks"].append(
            {"kernel": "decode_attention", "tag": tag, "max_abs_err": err})
        return err

    b, hq, smax, hkv, d = DECODE_SHAPE
    with open(os.path.join(ROOT, "bench", "mixes", "batch-decode.json")) as f:
        reqs = json.load(f)["requests"][:b]
    q, k, v = inputs(b, hq, hkv, d, smax, torch.bfloat16)
    spreads = {}
    for tag, frac in (("prompts", 0.0), ("mid-call", 0.5), ("outputs", 1.0)):
        lens = torch.tensor([min(smax, p + int(o * frac)) for p, o in reqs],
                            dtype=torch.int32, device=dev)
        spreads[tag] = lens
        err = held(q, k, v, lens, f"batch-decode {tag}")
        print(f"  batch-decode ({tag}: lengths {int(lens.min())}-"
              f"{int(lens.max())}): max_abs_err {err:.3g}", flush=True)
    for lo_hi in ((1, 1), (smax, smax), (1, smax)):
        lens = torch.randint(lo_hi[0], lo_hi[1] + 1, (b,), generator=g,
                             device=dev, dtype=torch.int32)
        held(q, k, v, lens, f"batch-decode lengths {lo_hi[0]}-{lo_hi[1]}")
    for (rhq, rhkv, rd), name in DECODE_REGISTRY:
        for dtype in (torch.bfloat16, torch.float32):
            rq, rk, rv = inputs(4, rhq, rhkv, rd, 545, dtype)
            lens = torch.tensor([1, 545, 548, 200], dtype=torch.int32,
                                device=dev)
            err = held(rq, rk, rv, lens, f"{name} {str(dtype)[6:]}")
            print(f"  {name:12s} {rhq}/{rhkv} heads of {rd} "
                  f"{str(dtype):14s}: max_abs_err {err:.3g}", flush=True)
            del rq, rk, rv

    lens = spreads["mid-call"]
    nbytes = decode_work(lens.tolist(), hkv, d, 2)
    scale = d ** -0.5
    sets = [[q, k, v, lens]]          # 537 MB a call: past the L2 already

    def kernel(q, k, v, lens):
        return ops.decode_attention(q, k, v, lens, scale=scale)

    row = {"kernel": "decode_attention", "tag": "batch-decode mid-call",
           "dtype": str(torch.bfloat16),
           "shapes": [[b, hq, d], [b, smax, hkv * d]],
           "max_abs_err": held(q, k, v, lens, "batch-decode timed"),
           "ms": time_ms(lambda: kernel(q, k, v, lens)),
           "device_ms": device_ms(kernel, sets),
           "plain_ms": time_ms(lambda: dec.plain(q, k, v, lens, scale=scale)),
           "library_ms": None, "library_device_ms": None,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "live_positions": int(lens.sum()),
           "plan": list(dec.plan(b, hkv, smax, d, torch.bfloat16,
                                 torch.cuda.get_device_properties(
                                     0).multi_processor_count))}
    full = torch.full((b,), smax, dtype=torch.int32, device=dev)
    row["full_device_ms"] = device_ms(kernel, [[q, k, v, full]])
    row["full_bound_ms"] = decode_work(full.tolist(), hkv, d, 2) \
        / HBM_BYTES_PER_S * 1e3
    report["kernel_times"].append(row)
    print(f"  time decode_attention batch-decode (mid-call, "
          f"{row['live_positions']} live positions): kernel {row['ms']:.4f} "
          f"ms (device {row['device_ms']:.4f}), plain {row['plain_ms']:.4f} "
          f"ms, bound {row['bound_ms']:.4f} ms (bytes: {nbytes} B); all "
          f"{smax} positions: device {row['full_device_ms']:.4f}, bound "
          f"{row['full_bound_ms']:.4f} ms; plan {row['plan']}", flush=True)
    return row


def device_busy(fn, reps):
    """Device time over host wall time of ``reps`` calls of ``fn`` in a
    ``torch.profiler`` trace (after one warm-up call), with the
    ``TOP_OPS`` device ops by time."""
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
            "top": [(k, us / reps, c // reps) for us, k, c in rows[:TOP_OPS]]}


def seed_model(cfg):
    """``cfg``'s weights as every serving phase draws them: float32 from
    seed 0 on the card.  An engine narrows the model it adopts to bf16 in
    place; a check in float32 compute draws the weights again here, once
    the caller has let go of the narrowed model, so the card never holds
    two (deepseek's 64.84 GB fit once)."""
    import gc

    import torch
    from repro_torch.models import init_params

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    return init_params(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(0), device=dev)


def print_narrowed(stats):
    """The float32 bytes the engines of a phase narrowed when they adopted
    its model (``stats`` by engine: the first narrows, the others find
    nothing left), printed and returned."""
    narrowed = {k: v["narrowed_bytes"] for k, v in stats.items()}
    print(f"  narrowed on adoption: {sum(narrowed.values())} B of float32 "
          f"weights to bf16 ({narrowed})", flush=True)
    return sum(narrowed.values())


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
    from repro_torch.models.model import narrow_serving_weights
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
    narrowed = print_narrowed(stats)
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
    # on the seed's float32 weights, drawn again where the engines
    # narrowed them; narrowed again after, as served
    del eng, model
    model = seed_model(cfg)
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
    narrow_serving_weights(model, cfg)

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
        "narrowed_bytes": narrowed, "init_s": init_s,
        "static": SERVE_STATIC, "continuous": SERVE_MANY,
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
            "peak": peak, "outs": outs, "static": st,
            "param_bytes": param_bytes,
            "many": (reqs, arrivals.tolist(), many)}


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
        held_scan(check, report, a, b, c, None, tag)
        held_scan(check, report, a, b, c, h0, tag)

    def timed(shape, tag):
        """The kernel at one chunk of a prefill, h0 given and the final
        state returned (as the serving path calls it), timed beside its
        plain version and its bound."""
        bsz, chunk, d, n = shape
        g = torch.Generator(device=dev).manual_seed(0)
        a = torch.rand(shape, generator=g, device=dev) * 0.299 + 0.7
        b = torch.randn(shape, generator=g, device=dev) * 0.1
        c = torch.randn((bsz, chunk, n), generator=g, device=dev)
        h0 = torch.randn((bsz, d, n), generator=g, device=dev)
        err = held_scan(check, report, a, b, c, h0, tag)
        nbytes, nops = scan_work(shape, 4, True, True)

        def kernel(a, b, c, h0):
            return ops.ssm_scan(a, b, c, h0=h0, return_state=True,
                                impl="kernel")

        row = {"kernel": "ssm_scan", "tag": tag, "dtype": str(f32),
               "shapes": [list(shape), list(c.shape)], "max_abs_err": err,
               "ms": time_ms(lambda: kernel(a, b, c, h0)),
               "device_ms": device_ms(kernel,
                                      rotation((a, b, c, h0), nbytes)),
               "plain_ms": time_ms(lambda: ref.ssm_scan(
                   a, b, c, h0=h0, return_state=True)),
               # no single PyTorch call scans
               "library_ms": None, "library_device_ms": None}
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / PEAK_OPS_PER_S["float32"] * 1e3
        row["bound_ms"], row["bound_by"] = (
            (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))
        report["kernel_times"].append(row)
        print(f"  time ssm_scan {tag} f32 {list(shape)}, h0 and final "
              f"state: kernel {row['ms']:.4f} ms (device "
              f"{row['device_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
              f"library - (none), bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}: {nbytes} B, {nops} ops)", flush=True)
        return row

    row = timed(SCAN_PREFILL_SHAPE, "prefill chunk")      # falcon-mamba's
    timed(HYBRID_SCAN_SHAPE, "zamba2 prefill chunk")

    # zamba2's decay of one chunk, one scalar per (token, head), expanded
    # over (P, N) into the (B, chunk, H*P, N) tensor the kernel reads
    from repro_torch.models import get
    from repro_torch.models.ssm import expanded_decay
    bsz, chunk, d, n = HYBRID_SCAN_SHAPE
    hp = get(HYBRID_ARCH).ssm.headdim
    g = torch.Generator(device=dev).manual_seed(1)
    dtc = torch.rand((bsz, chunk, d // hp), generator=g, device=dev) * 0.1
    a_vec = -torch.rand((d // hp,), generator=g, device=dev) - 0.5
    nbytes = bsz * chunk * d * n * 4 + dtc.numel() * 4 + a_vec.numel() * 4
    expand = {"what": "expanded_decay", "shape": list(HYBRID_SCAN_SHAPE),
              "ms": time_ms(lambda: expanded_decay(dtc, a_vec, hp, n)),
              "device_ms": device_ms(lambda x, y: expanded_decay(x, y, hp, n),
                                     [[dtc, a_vec]]),
              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
    report["expanded_decay"] = expand
    print(f"  time zamba2's expanded decay a chunk {list(HYBRID_SCAN_SHAPE)} "
          f"f32: {expand['ms']:.4f} ms (device {expand['device_ms']:.4f}), "
          f"bound {expand['bound_ms']:.4f} ms (bytes: {nbytes} B written)",
          flush=True)
    return row


def ssm_serving_phase(check, report):
    """falcon-mamba-7b at its published width through ``ServeEngine`` on
    the card (``serve_state_model``)."""
    from repro_torch.models import get

    cfg = get(SSM_ARCH)
    s1 = cfg.ssm
    check((cfg.family, cfg.n_layers, cfg.d_model, cfg.d_inner, s1.d_state,
           s1.d_conv, s1.dt_rank or -(-cfg.d_model // 16), cfg.vocab_size,
           cfg.tie_embeddings)
          == ("ssm", 64, 4096, 8192, 16, 4, 256, 65024, False),
          f"{cfg.name} is not at its published width: {cfg}")
    chunks = -(-SSM_STATIC["prompt_len"] // s1.chunk)
    return serve_state_model(
        check, report, cfg, SSM_STATIC, key="ssm_serving",
        n_params=7_272_665_088, per_prefill={"ssm_scan":
                                             cfg.n_layers * chunks},
        shape=(f"{cfg.n_layers} Mamba-1 layers, d {cfg.d_model}, d_inner "
               f"{cfg.d_inner}, N {s1.d_state}, conv {s1.d_conv}, scan "
               f"chunk {s1.chunk}, vocab {cfg.vocab_size}"))


def hybrid_serving_phase(check, report):
    """zamba2-2.7b at its published width through ``ServeEngine`` on the
    card (``serve_state_model``): 54 Mamba-2 layers, each prefill chunk a
    scan of D = H·P = 5120 channels of N = 64 states, and the shared
    attention block after every 6th layer through the flash kernel at
    head dim 80."""
    from repro_torch.models import get
    from repro_torch.models.model import shared_config

    cfg = get(HYBRID_ARCH)
    s2, hb, scfg = cfg.ssm, cfg.hybrid, shared_config(cfg)
    heads = cfg.d_inner // s2.headdim
    check((cfg.family, cfg.n_layers, cfg.d_model, cfg.d_inner, heads,
           s2.headdim, s2.d_state, s2.d_conv, hb.period, scfg.n_heads,
           scfg.n_kv_heads, scfg.head_dim, cfg.d_ff, cfg.vocab_size)
          == ("hybrid", 54, 2560, 5120, 80, 64, 64, 4, 6, 32, 32, 80, 10240,
              32000),
          f"{cfg.name} is not at its published width: {cfg}")
    chunks = -(-HYBRID_STATIC["prompt_len"] // s2.chunk)
    per_prefill = {"ssm_scan": cfg.n_layers * chunks,
                   "flash_attention": cfg.n_layers // hb.period}
    check(per_prefill == {"ssm_scan": 108, "flash_attention": 9},
          f"{cfg.name}: a prefill's launches would be {per_prefill}")
    return serve_state_model(
        check, report, cfg, HYBRID_STATIC, key="hybrid_serving",
        n_params=2_422_670_240, per_prefill=per_prefill,
        shape=(f"{cfg.n_layers} Mamba-2 layers, d {cfg.d_model}, d_inner "
               f"{cfg.d_inner} = {heads} heads x {s2.headdim}, N "
               f"{s2.d_state}, conv {s2.d_conv}, scan chunk {s2.chunk}; the "
               f"shared block after every {hb.period}th layer: "
               f"{scfg.n_heads}/{scfg.n_kv_heads} heads of {scfg.head_dim}, "
               f"d_ff {cfg.d_ff}; vocab {cfg.vocab_size}"))


def moe_serving_phase(check, report):
    """The MoE family on the card.  deepseek-v2-lite-16b at its published
    width and depth through ``ServeEngine`` (``serve_state_model``): MLA
    attention (q/k of 192, v of 128, which the flash kernel does not take,
    so "auto" resolves to the plain attention) and 64 routed experts top-6
    with 2 shared, routed without drops; under "auto" no kernel of the
    port is on its path, and the flash, scan and MLA counts must not move
    over the whole run.
    Then its MLA decode step against the full-sequence path
    (``mla_decode_check``) and its ``graphs_phase``; then its prompts
    through "chunked", as the long-prompt cell runs them
    (``mla_chunked_serving``: the MLA kernel once a layer).  Then the
    reduced llama4-scout (``moe_gqa_phase``).  Returns the llama4 run's
    launch counts (the flash kernel's, one a layer a prefill) with the
    "chunked" run's MLA launches."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import get

    cfg = get(MOE_ARCH)
    m, e = cfg.mla, cfg.moe
    check((cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
           cfg.vocab_size, e.n_experts, e.top_k, e.n_shared, e.d_ff_expert,
           m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim,
           m.v_head_dim)
          == ("moe", 27, 2048, 16, 102400, 64, 6, 2, 1408, 512, 128, 64,
              128),
          f"{cfg.name} is not at its published width: {cfg}")
    served = serve_state_model(
        check, report, cfg, MOE_STATIC, key="moe_serving",
        n_params=16_210_324_992,
        per_prefill={"flash_attention": 0, "ssm_scan": 0,
                     "mla_attention": 0},
        shape=(f"{cfg.n_layers} layers, d {cfg.d_model}; MLA: {cfg.n_heads} "
               f"heads, kv_lora {m.kv_lora_rank}, nope {m.qk_nope_head_dim}, "
               f"rope {m.qk_rope_head_dim}, v {m.v_head_dim}; MoE: "
               f"{e.n_experts} experts top-{e.top_k} of {e.d_ff_expert}, "
               f"{e.n_shared} shared; vocab {cfg.vocab_size}"))
    mla_decode_check(check, report, served)
    graphs_phase(check, report, served)
    torch.cuda.synchronize()
    # counted from the serving run's reset through the graphs phase
    moved = {k: build.launch_counts()[k]
             for k in ("flash_attention", "ssm_scan", "mla_attention")}
    check(moved == {"flash_attention": 0, "ssm_scan": 0, "mla_attention": 0},
          f"{cfg.name} launched model kernels: {moved} ('auto' must "
          f"resolve to the plain attention for MLA)")
    report["moe_serving"]["kernel_launches_whole_phase"] = moved
    print(f"  {cfg.name}: model-kernel launches over the whole phase "
          f"{moved}", flush=True)
    chunked = mla_chunked_serving(check, report, served)
    del served
    torch.cuda.empty_cache()
    launches = moe_gqa_phase(check, report)
    check(launches["mla_attention"] == 0,
          f"{MOE_GQA_ARCH} launched the MLA kernel "
          f"{launches['mla_attention']} times")
    launches["mla_attention"] = chunked["mla_attention"]
    return launches


def mla_chunked_serving(check, report, served):
    """deepseek's prompts through ``ServeEngine.generate`` as the
    long-prompt cell calls it: attn_impl "chunked" with chunk 512, routing
    without drops, greedy.  Counted from 0 over the call: its one prefill
    launches the MLA kernel once a layer, and nothing else of the port's
    model kernels runs (the decode step reads the latent cache in plain
    torch).  Prints how many tokens match the "auto" run's greedy tokens
    (bf16 roundings of another attention order may flip some; not a
    gate).  Returns the call's launch counts."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import CallConfig
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg, st = served["cfg"], served["static"]
    call = CallConfig(attn_impl="chunked", attn_chunk=512, moe_no_drop=True)
    eng = ServeEngine(cfg, served["model"], ServeConfig(
        batch=st["batch"], max_len=served["max_len"], temperature=0.0),
        call, device=torch.device("cuda"))
    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.perf_counter()
    out = eng.generate(served["prompts"], st["new_tokens"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = build.launch_counts()
    want = {"flash_attention": 0, "ssm_scan": 0, "decode_attention": 0,
            "mla_attention": cfg.n_layers}
    got = {k: launches[k] for k in want}
    check(got == want, f"{cfg.name} through \"chunked\" launched {got}, "
                       f"not {want} (the MLA kernel once a layer a prefill)")
    check(out.shape == (st["batch"], st["new_tokens"])
          and out.min() >= 0 and out.max() < cfg.vocab_size,
          f"{cfg.name} \"chunked\" tokens of shape {out.shape}")
    same = float(np.mean(out == served["outs"]["step"]))
    report["moe_serving"]["chunked"] = {
        "launches": got, "wall_s": wall, "tokens_as_auto": same}
    print(f"  generate \"chunked\" (chunk 512): {wall:.3f} s wall; "
          f"launches {got}; tokens as under \"auto\": {same:.3f}",
          flush=True)
    del eng
    return launches


def mla_decode_check(check, report, served):
    """deepseek's decode step after a prefill of the prompts against the
    prefill's last-position logits over the prompts plus that token, at
    full width and depth: in float32 compute (the seed's f32 weights,
    drawn again in place of the model the engines narrowed, and narrowed
    again after) within ``DECODE_TOL`` relative L2; the bf16 figure is
    printed beside it, not a gate.  Both route without drops.  Beside
    each figure, the (layer, token) pairs whose top-k expert sets differ
    between the two paths (the indices ``moe.route`` returns, recorded
    around the decode step and the full-sequence prefill)."""
    import torch
    from repro_torch.models import CallConfig, decode_step, prefill
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.model import narrow_serving_weights

    route = moe_lib.route

    def chosen(fn):
        """``fn()`` and the expert indices of each ``route`` call in it."""
        got = []

        def recorded(probs, k):
            vals, idx = route(probs, k)
            got.append(idx)
            return vals, idx
        moe_lib.route = recorded
        try:
            return fn(), got
        finally:
            moe_lib.route = route

    dev = torch.device("cuda")
    cfg = served["cfg"]
    served["model"] = None
    model = served["model"] = seed_model(cfg)
    toks = torch.as_tensor(served["prompts"]).to(dev)
    nxt = torch.as_tensor(served["outs"]["step"][:, :1]).to(dev)
    s = toks.shape[1]
    call = CallConfig(moe_no_drop=True)
    rows = {}
    for tag in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=tag)
        _, cache = prefill(model, c, {"tokens": toks}, s + 1, call)
        dec, dec_idx = chosen(lambda: decode_step(model, c, cache, nxt)[0])
        del cache
        full, full_idx = chosen(lambda: prefill(
            model, c, {"tokens": torch.cat([toks, nxt], dim=1)}, s + 1,
            call)[0])
        dec, full = dec.double(), full.double()
        d = dec - full
        b, k = nxt.shape[0], cfg.moe.top_k
        check(len(dec_idx) == len(full_idx) > 0,
              f"{cfg.name}: {len(dec_idx)} routings in the decode step, "
              f"{len(full_idx)} in the full-sequence prefill")
        flips = [int((dl.view(b, k).sort(-1).values
                      != fl.view(b, s + 1, k)[:, -1].sort(-1).values)
                     .any(-1).sum()) for dl, fl in zip(dec_idx, full_idx)]
        rows[tag] = {"rel_l2": (d.norm() / full.norm()).item(),
                     "max_abs_err": d.abs().max().item(),
                     "max_abs_logit": full.abs().max().item(),
                     "finite": bool(torch.isfinite(dec).all()),
                     "routing_flips": sum(flips),
                     "routings": len(flips) * b,
                     "first_flip_layer": next(
                         (i for i, f in enumerate(flips) if f), None)}
        del dec, full, d, dec_idx, full_idx
        torch.cuda.empty_cache()
    narrow_serving_weights(model, cfg)
    r32 = rows["float32"]
    check(r32["finite"] and r32["rel_l2"] <= DECODE_TOL,
          f"{cfg.name}: the f32 MLA decode step is {r32} from the "
          f"full-sequence path (bar: relative L2 {DECODE_TOL})")
    report["moe_serving"]["mla_decode"] = rows
    for tag, r in rows.items():
        print(f"  MLA decode vs full sequence, {tag} compute: relative L2 "
              f"{r['rel_l2']:.4g}, max_abs_err {r['max_abs_err']:.4g} (max "
              f"|logit| {r['max_abs_logit']:.4g}); top-{cfg.moe.top_k} "
              f"expert sets differ in {r['routing_flips']} of "
              f"{r['routings']} (MoE layer, token) pairs, first at MoE "
              f"layer {r['first_flip_layer']}"
              + (f"; bar {DECODE_TOL}" if tag == "float32"
                 else "; not a gate"), flush=True)


def moe_gqa_phase(check, report):
    """llama4-scout-17b-a16e at its reduced size (2 layers, d 128, 4/2
    heads of 32, 4 experts top-1 and one shared) through ``ServeEngine``:
    ``generate`` in every decode mode and ``generate_many`` (the MoE
    branch of the ragged step) over the Yi-9B phase's request trace, each
    prefill launching the flash kernel once a layer; the prefill logits
    with the kernel against the plain attention (``prefill_vs_plain``,
    GQA at head dim 32 over the 512-token prompts); then its
    ``graphs_phase`` (captured tokens against eager, ``generate_many``
    too).  Returns the launch counts of the counted run."""
    import numpy as np
    import torch
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.kernels import build
    from repro_torch.launch.serve import continuous_trace
    from repro_torch.models import get, init_params, reduced
    from repro_torch.models.model import narrow_serving_weights
    from repro_torch.serve import ServeConfig, ServeEngine

    dev = torch.device("cuda")
    cfg = reduced(get(MOE_GQA_ARCH))
    check((cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
           cfg.n_kv_heads, cfg.head_dim, cfg.moe.n_experts, cfg.moe.top_k,
           cfg.moe.n_shared) == ("moe", 2, 128, 4, 2, 32, 4, 1, 1),
          f"{cfg.name}: {cfg}")
    print(f"== serving: {cfg.name} (reduced: {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k} + {cfg.moe.n_shared} shared; {cfg.compute_dtype} "
          f"compute)", flush=True)
    model = init_params(cfg, generator=torch.Generator(device=dev)
                        .manual_seed(0), device=dev)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    st = MOE_STATIC
    prompts = SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, batch_size=st["batch"],
        seq_len=st["prompt_len"], seed=0), cfg).batch(0)["tokens"]
    max_len = st["prompt_len"] + st["new_tokens"] + 1
    mn = SERVE_MANY
    reqs, arrivals, lens = continuous_trace(
        mn["requests"], mn["lo"], mn["hi"], mn["new_tokens"],
        mn["arrival_rate"], cfg.vocab_size, seed=0)

    outs, wall, stats = {}, {}, {}
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
    eng = ServeEngine(cfg, model, ServeConfig(batch=mn["batch"],
                                              max_len=mn["max_len"]))
    t0 = time.perf_counter()
    many = eng.generate_many(reqs, arrival_steps=arrivals.tolist())
    torch.cuda.synchronize()
    many_s = time.perf_counter() - t0
    many_stats = stats["continuous"] = dict(eng.stats)
    launches = build.launch_counts()
    prefills = len(outs) + sum(1 for p, _ in reqs if p.size > 1)

    want = cfg.n_layers * prefills
    check(launches["flash_attention"] == want,
          f"{cfg.name} launched flash_attention "
          f"{launches['flash_attention']} times, not once a layer of each "
          f"of {prefills} prefills ({want})")
    for mode in ("chunk", "host"):
        check(np.array_equal(outs[mode], outs["step"]),
              f"{cfg.name}: {mode} mode emitted other greedy tokens than "
              f"step mode")
    check(all(o.shape == (mn["new_tokens"],) and o.min() >= 0
              and o.max() < cfg.vocab_size for o in many)
          and many_stats["requests_retired"] == mn["requests"],
          f"{cfg.name}: continuous outputs {[o.shape for o in many]}, "
          f"stats {many_stats}")
    print(f"  generate step/chunk/host: identical greedy tokens; "
          + ", ".join(f"{k} {v:.3f} s" for k, v in wall.items())
          + f"; generate_many: {mn['requests']} requests in {many_s:.3f} s, "
          f"stats {many_stats}; flash launches {launches['flash_attention']}"
          f" = {cfg.n_layers} a prefill x {prefills}", flush=True)
    narrowed = print_narrowed(stats)
    # the flash kernel at this prefill's GQA shapes against the plain
    # attention, through the whole model, on the seed's float32 weights
    # drawn again where the engines narrowed them; narrowed again after
    del eng, model
    model = seed_model(cfg)
    prefill_cmp = prefill_vs_plain(
        check, cfg, model, {"tokens": torch.as_tensor(prompts).to(dev)},
        max_len)
    narrow_serving_weights(model, cfg)
    report["moe_gqa_serving"] = {
        "arch": cfg.name, "narrowed_bytes": narrowed, "wall_s": wall,
        "continuous_s": many_s,
        "stats": many_stats, "launches": launches, "prefills": prefills,
        "prefill_logits": prefill_cmp,
        "tokens_row0": outs["step"][0].tolist()}
    graphs_phase(check, report, {
        "cfg": cfg, "model": model, "prompts": prompts, "outs": outs,
        "static": st, "max_len": max_len, "param_bytes": param_bytes,
        "many": (reqs, arrivals.tolist(), many)})
    del model
    torch.cuda.empty_cache()
    return launches


def frontend_serving_phase(check, report):
    """The modality frontends on the card, each at its published width and
    depth through ``ServeEngine`` (``serve_state_model``), then its
    ``graphs_phase``.  paligemma-3b: 256 positions of precomputed patches
    (drawn from the prompts' stream) before each 512-token prompt under the
    prefix-LM mask, so "auto" resolves to the plain attention and no
    kernel of the port is on its path (the flash and scan counts must not
    move over its whole phase); its decode step after the prefix against
    the full-sequence path (``prefix_decode_check``).  musicgen-large: the
    audio stub, codec tokens with sinusoidal positions, 32 heads of 64
    through the flash kernel once a layer a prefill, its prefill logits
    with the kernel against the plain attention.  Returns musicgen's
    launch counts."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import get

    cfg = get(VISION_ARCH)
    fe = cfg.frontend
    check((cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
           cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.act,
           cfg.embed_scale, cfg.tie_embeddings, fe.kind, fe.n_prefix_tokens)
          == ("vlm", 18, 2048, 8, 1, 256, 16384, 257216, "gelu", True, True,
              "vision_stub", 256),
          f"{cfg.name} is not at its published width: {cfg}")
    served = serve_state_model(
        check, report, cfg, FRONTEND_STATIC, key="vision_serving",
        n_params=2_508_662_784,
        per_prefill={"flash_attention": 0, "ssm_scan": 0},
        shape=(f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/"
               f"{cfg.n_kv_heads} heads of {cfg.head_dim}, GeGLU d_ff "
               f"{cfg.d_ff}, vocab {cfg.vocab_size} tied; the vision stub: "
               f"{fe.n_prefix_tokens} patch positions before the prompt, "
               f"prefix-LM mask"))
    prefix_decode_check(check, report, served)
    graphs_phase(check, report, served)
    torch.cuda.synchronize()
    # counted from the serving run's reset through the graphs phase
    moved = {k: build.launch_counts()[k]
             for k in ("flash_attention", "ssm_scan", "mla_attention")}
    check(moved == {"flash_attention": 0, "ssm_scan": 0, "mla_attention": 0},
          f"{cfg.name} launched model kernels: {moved} ('auto' must "
          f"resolve to the plain attention for a prefix mask)")
    report["vision_serving"]["kernel_launches_whole_phase"] = moved
    print(f"  {cfg.name}: model-kernel launches over the whole phase "
          f"{moved}", flush=True)
    del served
    torch.cuda.empty_cache()

    cfg = get(AUDIO_ARCH)
    check((cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
           cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
           cfg.pos_embedding, cfg.tie_embeddings, cfg.frontend.kind)
          == ("audio", 48, 2048, 32, 32, 64, 8192, 2048, "sinusoidal", False,
              "audio_stub"),
          f"{cfg.name} is not at its published width: {cfg}")
    per_prefill = {"flash_attention": cfg.n_layers, "ssm_scan": 0}
    check(per_prefill["flash_attention"] == 48,
          f"{cfg.name}: a prefill's launches would be {per_prefill}")
    served = serve_state_model(
        check, report, cfg, FRONTEND_STATIC, key="audio_serving",
        n_params=3_229_812_736, per_prefill=per_prefill,
        shape=(f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/"
               f"{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
               f"vocab {cfg.vocab_size}; the audio stub: codec tokens with "
               f"sinusoidal positions"))
    graphs_phase(check, report, served)
    launches = served["launches"]
    del served
    torch.cuda.empty_cache()
    return launches


def train_step_work(cfg, tokens):
    """(bf16 operations, f32 operations) of one remat training step of a
    dense model with the plain attention: the weight products 2 operations
    a weight a token forward, twice that backward, the layers' forward
    again under remat (the head's not); the attention's two f32 products
    of 2 operations over the full (S, S) scores per head (the plain version
    masks, it does not skip), forward, backward (twice) and recomputed."""
    d, hd = cfg.d_model, cfg.head_dim
    layer = (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
             + cfg.n_heads * hd * d + 3 * d * cfg.d_ff)
    head = d * cfg.vocab_size
    bf16 = 2 * tokens * (3 * (cfg.n_layers * layer + head)
                         + cfg.n_layers * layer)
    b, s = TRAIN_DATA["batch_size"], TRAIN_DATA["seq_len"]
    f32 = 4 * (2 * 2 * b * cfg.n_heads * s * s * hd) * cfg.n_layers
    return bf16, f32


def flat_tree(tree, prefix=""):
    """Nested mappings' leaves by ``/``-joined path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def train_phase(check, report, device=None):
    """The training substrate on the card (``repro_torch.train``):
    smollm-360m at its published width and depth (32 layers, d 960, 15/5
    heads of 64, d_ff 2560, vocab 49152 tied; 361,821,120 float32 weights
    from a seeded generator, bf16 compute), the synthetic stream's 8 x 2048
    tokens a step, ``TrainConfig(base_lr=1e-3, warmup_steps=2,
    total_steps=20)``, the plain attention under autograd with remat, 8
    logical data ways.  Steps 0-5: finite loss and grad norm, the loss
    falling; a checkpoint after step 3 (``checkpoint.save`` in the
    reference's layout); from it, the gradients of 2 microbatches against
    1 and the AdamW step timed on copies; ``restore`` and steps 4-5
    replayed to a bitwise-equal loss; ``elastic_restore`` onto 2 data ways,
    every array bit-identical; the grad guard (the flash kernel under
    autograd, the scan through "auto"); one step's busy share; then, under
    ``torch.no_grad``, the trained weights' logits with the flash kernel
    against the plain attention on batch 6 (32 launches).  Returns the
    phase's launch counts.  ``device`` (the card when None) is for a
    rehearsal on the CPU with the CUDA calls faked."""
    import shutil
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.checkpoint import restore, save
    from repro_torch.data import DataConfig, SyntheticStream, input_specs
    from repro_torch.dist import LogicalMesh
    from repro_torch.ft.elastic import elastic_restore
    from repro_torch.kernels import build, ops
    from repro_torch.models import (
        CallConfig, count_params, forward, get, init_params,
    )
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.train import (
        TrainConfig, build_train_step, grads_with_microbatching,
    )

    dev = torch.device(device or "cuda")
    card = nvidia_smi("name,power.limit")
    cfg = get(TRAIN_ARCH)
    check((cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
           cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
           cfg.tie_embeddings)
          == ("dense", 32, 960, 15, 5, 64, 2560, 49152, True),
          f"{cfg.name} is not at its published width: {cfg}")
    n_params = count_params(cfg)
    check(n_params == 361_821_120, f"{cfg.name}: {n_params} weights")
    print(f"== training {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
          f"{n_params} f32 weights, {TRAIN_DATA['batch_size']} x "
          f"{TRAIN_DATA['seq_len']} tokens a step ({card})", flush=True)
    free, total = torch.cuda.mem_get_info()
    base = torch.cuda.memory_allocated()
    print(f"  device memory before the draw: {free} B free of {total} B, "
          f"{base} B allocated", flush=True)
    build.reset_counts()
    model = init_params(cfg, generator=torch.Generator(device=dev)
                        .manual_seed(0), device=dev)
    stream = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                        **TRAIN_DATA), cfg)
    b, s = TRAIN_DATA["batch_size"], TRAIN_DATA["seq_len"]
    tcfg = TrainConfig(**TRAIN_CFG)
    mesh = LogicalMesh(*TRAIN_MESH)
    step, pspecs, ospecs, bspecs = build_train_step(
        cfg, tcfg, input_specs(cfg, mode="train", batch=b, seq=s),
        mesh=mesh, device=dev)
    specs = {"params": pspecs, "opt": ospecs}
    opt = adamw_init(model)
    batches = [stream.batch(i) for i in range(TRAIN_STEPS)]
    ckpt = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)

    rows, saved = [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        if i == TRAIN_SAVE:
            t0 = time.perf_counter()
            saved = {"params": convert.model_params_to_numpy(model, cfg),
                     "opt": convert.adamw_state_to_numpy(opt, cfg)}
            save(ckpt, TRAIN_SAVE, saved, specs, data_index=TRAIN_SAVE)
            save_s = time.perf_counter() - t0
        (_, opt, m), ms = event_timed(lambda: step(model, opt, batches[i], i))
        row = {"step": i, "ms": ms, **{k: float(m[k]) for k in
                                       ("loss", "lr", "grad_norm")}}
        rows.append(row)
        print(f"  step {i}: loss {row['loss']:.6f}, lr {row['lr']:.6g}, "
              f"grad_norm {row['grad_norm']:.6f}, {ms:.1f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
              for r in rows), "training: a loss or grad norm is not finite")
    check(rows[-1]["loss"] < rows[0]["loss"],
          f"training: the loss did not fall ({rows[0]['loss']} at step 0, "
          f"{rows[-1]['loss']} at step {TRAIN_STEPS - 1})")
    step_ms = statistics.median(r["ms"] for r in rows[1:])

    # -- restore the checkpoint; microbatches and AdamW from its state ------
    t0 = time.perf_counter()
    at, data_index, state = restore(ckpt, mesh, specs, device=dev)
    model.load_state_dict(convert.model_params_from_numpy(
        state["params"], cfg))
    opt = convert.adamw_state_from_numpy(state["opt"], cfg)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check((at, data_index) == (TRAIN_SAVE, TRAIN_SAVE),
          f"restore: step {at}, data index {data_index}")
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in batches[data_index].items()}
    l1, g1 = grads_with_microbatching(cfg, tcfg.call, 1)(model, batch)
    l2, g2 = grads_with_microbatching(cfg, tcfg.call, 2)(model, batch)
    loss_rel = abs(float(l2) - float(l1)) / abs(float(l1))
    num = sum(float(torch.sum((g1[n].float() - g2[n]) ** 2)) for n in g1)
    den = sum(float(torch.sum(g1[n].float() ** 2)) for n in g1)
    grad_rel = (num / den) ** 0.5
    worst = max((float(torch.linalg.vector_norm(g1[n].float() - g2[n])
                       / torch.linalg.vector_norm(g1[n].float())), n)
                for n in g1)
    check(loss_rel <= TRAIN_MB_TOL["loss_rel"]
          and grad_rel <= TRAIN_MB_TOL["grad_rel_l2"],
          f"microbatches 2 vs 1: loss rel {loss_rel:.3g}, gradients rel L2 "
          f"{grad_rel:.3g} (bars {TRAIN_MB_TOL})")
    print(f"  microbatches 2 vs 1 (step {data_index}'s state): loss "
          f"{float(l1):.6f} / {float(l2):.6f} (rel {loss_rel:.3g}), "
          f"gradients rel L2 {grad_rel:.3g}, worst leaf {worst[1]} "
          f"{worst[0]:.3g}", flush=True)
    del g2
    p_copy = {n: t.detach().clone() for n, t in model.named_parameters()}
    o_copy = {"mu": {n: t.clone() for n, t in opt["mu"].items()},
              "nu": {n: t.clone() for n, t in opt["nu"].items()},
              "count": opt["count"].clone()}
    lr = torch.full((), 1e-3, dtype=torch.float32, device=dev)
    adamw_ms = statistics.median(
        event_timed(lambda: adamw_update(g1, o_copy, p_copy, lr,
                                           tcfg.adamw))[1]
        for _ in range(5))
    del g1, p_copy, o_copy
    torch.cuda.empty_cache()

    # -- steps 4-5 replayed from the checkpoint: the same bits ----------------
    for i in range(data_index, TRAIN_STEPS):
        _, opt, m = step(model, opt, batches[i], i)
        replay = float(m["loss"])
        check(replay == rows[i]["loss"],
              f"resume: step {i}'s loss {replay!r} after restore, "
              f"{rows[i]['loss']!r} before")
    print(f"  resume from step {at}: steps {at}-{TRAIN_STEPS - 1} replayed, "
          f"last loss {replay!r} (before: {rows[-1]['loss']!r})", flush=True)

    # -- elastic: the 8-way checkpoint restored onto 2 data ways ---------------
    at2, di2, state2, mesh2 = elastic_restore(
        ckpt, range(TRAIN_ELASTIC_WAYS), convert.reference_shapes(cfg),
        device=dev)
    flat_saved, flat_got = flat_tree(saved), flat_tree(state2)
    same = (set(flat_saved) == set(flat_got) and all(
        np.array_equal(flat_saved[k], flat_got[k].cpu().numpy())
        and str(flat_saved[k].dtype) == str(flat_got[k].cpu().numpy().dtype)
        for k in flat_saved))
    check(same and (at2, di2) == (TRAIN_SAVE, TRAIN_SAVE)
          and mesh2.shape == {"data": TRAIN_ELASTIC_WAYS},
          f"elastic restore onto {TRAIN_ELASTIC_WAYS} ways: "
          f"bit-identical {same}, step {at2}, mesh {mesh2}")
    print(f"  elastic restore: {len(flat_got)} arrays written on "
          f"{mesh.shape} restored on {mesh2.shape}, bit-identical {same}",
          flush=True)
    del state, state2, saved, flat_saved, flat_got
    shutil.rmtree(ckpt, ignore_errors=True)

    # -- the grad guard: a kernel under autograd raises -----------------------
    small = {"tokens": batch["tokens"][:1, :64]}
    for what, fn in (
            ("the flash kernel through forward(attn_impl='auto')",
             lambda: forward(model, cfg, small, CallConfig(attn_impl="auto"))),
            ("the scan kernel through ops.ssm_scan(impl='auto')",
             lambda: ops.ssm_scan(
                 torch.rand((1, 4, 8, 16), device=dev).requires_grad_(),
                 torch.rand((1, 4, 8, 16), device=dev),
                 torch.rand((1, 4, 16), device=dev)))):
        try:
            with torch.enable_grad():
                fn()
            msg = None
        except RuntimeError as e:
            msg = str(e)
        check(msg is not None and build.BACKWARD in msg,
              f"grad guard: {what} under autograd gave {msg!r}")
        print(f"  grad guard: {what} raises: {msg}", flush=True)

    # -- one step's device busy share -------------------------------------------
    nxt = batches[TRAIN_STEPS - 1]
    busy = device_busy(lambda: step(model, opt, nxt, TRAIN_STEPS), 1)
    print(f"  one step, profiled: wall {busy['wall_us'] / 1e3:.1f} ms, device "
          f"{busy['device_us'] / 1e3:.1f} ms, busy share "
          f"{busy['busy_share']:.3f}; top "
          + "; ".join(f"{k[:40]} {us / 1e3:.1f} ms x{c}"
                      for k, us, c in busy["top"][:5]), flush=True)

    # -- the trained weights through the flash kernel -----------------------------
    ev = {k: torch.as_tensor(v, device=dev)
          for k, v in stream.batch(TRAIN_EVAL_BATCH).items()}
    with torch.no_grad():
        before = build.launch_counts()["flash_attention"]
        lk, _ = forward(model, cfg, ev, CallConfig(attn_impl="kernel"))
        torch.cuda.synchronize()
        flash = build.launch_counts()["flash_attention"] - before
        lp, _ = forward(model, cfg, ev, CallConfig(attn_impl="plain"))
        rel = float(torch.linalg.vector_norm(lk - lp)
                    / torch.linalg.vector_norm(lp))
    check(rel <= PREFILL_TOL["bfloat16"]["rel_l2"],
          f"trained weights, kernel vs plain logits: rel L2 {rel:.4g}")
    check(flash == cfg.n_layers,
          f"trained weights: {flash} flash launches a forward, not "
          f"{cfg.n_layers}")
    print(f"  trained weights (batch {TRAIN_EVAL_BATCH}), flash kernel vs "
          f"plain attention: logits rel L2 {rel:.4g} (bar "
          f"{PREFILL_TOL['bfloat16']['rel_l2']}), {flash} flash launches",
          flush=True)
    del lk, lp, model, opt
    torch.cuda.synchronize()
    launches = build.launch_counts()

    tokens = b * s
    bf16_ops, f32_ops = train_step_work(cfg, tokens)
    ops_ms = (bf16_ops / PEAK_OPS_PER_S["bfloat16"]
              + f32_ops / PEAK_OPS_PER_S["float32"]) * 1e3
    adamw_bytes = 7 * 4 * n_params
    out = {"card": card, "arch": cfg.name, "params": n_params,
           "tokens_per_step": tokens, "steps": rows, "step_ms": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3, "adamw_ms": adamw_ms,
           "adamw_bound_ms": adamw_bytes / HBM_BYTES_PER_S * 1e3,
           "peak_bytes": peak, "peak_over_start_bytes": peak - base,
           "save_s": save_s, "restore_s": restore_s,
           "mb_loss_rel": loss_rel, "mb_grad_rel_l2": grad_rel,
           "mb_worst_leaf": worst, "resume_loss": replay,
           "busy": busy, "eval_rel_l2": rel, "eval_flash_launches": flash,
           "bf16_tflop": bf16_ops / 1e12, "f32_tflop": f32_ops / 1e12,
           "ops_bound_ms": ops_ms, "launches": launches}
    report["train"] = out
    print(f"  {cfg.name} training ({card}): step {step_ms:.1f} ms (median of "
          f"steps 1-{TRAIN_STEPS - 1}), {out['tokens_per_s']:.0f} tokens/s; "
          f"AdamW {adamw_ms:.2f} ms (bound {out['adamw_bound_ms']:.3f} ms, "
          f"{adamw_bytes} B); peak {peak} B ({peak - base} B over the "
          f"phase's start); checkpoint save {save_s:.2f} s, "
          f"restore {restore_s:.2f} s; products {bf16_ops / 1e12:.2f} TFLOP "
          f"bf16 + {f32_ops / 1e12:.2f} f32, bound {ops_ms:.1f} ms; busy "
          f"share {busy['busy_share']:.3f}; launches {launches}", flush=True)
    torch.cuda.empty_cache()
    return launches


def cli_env():
    """The environment a CLI of the port runs in: this one with the
    checkout's ``src`` first on the path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def run_py(*argv, timeout=600):
    """``python -u <argv>`` from the checkout's root with its ``src`` on
    the path -> (return code, stdout + stderr, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-u", *argv],
                          capture_output=True, text=True, env=cli_env(),
                          cwd=ROOT, timeout=timeout)
    return proc.returncode, proc.stdout + proc.stderr, \
        time.perf_counter() - t0


def run_cli(module, *args, timeout=600):
    """``python -m <module> <args>``, as :func:`run_py`."""
    return run_py("-m", module, *args, timeout=timeout)


def event_timed(fn):
    """(fn's result, the ms between CUDA events around it)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end)


def peak_over(fn):
    """(fn's result, ms, the peak bytes allocated over the allocation at
    its start)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, ms = event_timed(fn)
    return res, ms, torch.cuda.max_memory_allocated() - base


def same_checkpoints(a, b):
    """(every array of checkpoint directories ``a`` and ``b`` equal bit for
    bit and of one dtype, how many arrays, the first that differs)."""
    import numpy as np
    files = sorted(f for f in os.listdir(a) if f.endswith(".npz"))
    if files != sorted(f for f in os.listdir(b) if f.endswith(".npz")):
        return False, 0, f"files {files}"
    n = 0
    for f in files:
        with np.load(os.path.join(a, f)) as za, np.load(
                os.path.join(b, f)) as zb:
            if sorted(za.files) != sorted(zb.files):
                return False, n, f"{f}: keys differ"
            for k in za.files:
                x, y = za[k], zb[k]
                n += 1
                if x.dtype != y.dtype or not np.array_equal(x, y):
                    return False, n, f"{f}:{k}"
    return True, n, None


def launch_phase(check, report, device=None, cli_args=()):
    """The launch layer on the card (``repro_torch.launch``).

    1. The train CLI at full width and depth, as a user starts it
       (``python -m repro_torch.launch.train``, smollm-360m, 8 x 2048
       tokens a step, ``--mesh 1x1``): run A trains 8 steps with a
       checkpoint every 3 and at the end; run B resumes from a copy of A's
       step-6 checkpoint to step 8; every array of B's step-8 checkpoint
       must equal A's bit for bit (a resumed run is the uninterrupted run;
       both have ``--steps 8``, so one schedule).  Meanwhile the dry-run
       CLI counts smollm-360m's ``train_4k`` cell on ``meta`` and the
       report CLI tabulates it (an ``ok`` row).
    2. The roofline against the card: the CLI's train step (the same
       shape, config and call) counted by ``op_cost`` on ``meta`` and
       timed on the card (median of 3 steps, CUDA events), its
       ``Roofline.bound`` at most 1.05 x the step; ``op_cost``'s tracked
       peak against ``torch.cuda.max_memory_allocated`` over one step
       (ratio within [0.5, 2]); the prefill of 8 x 2048 tokens timed with
       ``attn_impl="auto"`` (the flash kernel: its launches are this
       phase's count) against ``flashsub.substitute`` of the same prefill
       counted with the attention stub, bound at most 1.05 x measured; a
       bf16 8192^3 ``torch.matmul`` at most ``PEAK_FLOPS_BF16`` and a
       4 GB device copy at most ``HBM_BW``; one checkpoint save and
       restore of the model and its AdamW state.  Returns the phase's
       launch counts.  ``device`` and ``cli_args`` (appended to the train
       CLI's flags) are for a rehearsal on the CPU with the CUDA calls
       faked (``("--device", "cpu", "--reduced")``)."""
    import shutil
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.checkpoint import restore, save
    from repro_torch.data import DataConfig, SyntheticStream, input_specs
    from repro_torch.kernels import build
    from repro_torch.launch import flashsub, roofline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_cost import count_cost
    from repro_torch.models import (
        CallConfig, count_params, get, init_params, prefill,
    )
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, build_train_step

    dev = torch.device(device or "cuda")
    card = nvidia_smi("name,power.limit")
    cfg = get(LAUNCH_ARCH)
    b, s, steps = LAUNCH["batch"], LAUNCH["seq"], LAUNCH["steps"]
    n_params = count_params(cfg)
    print(f"== launch: {cfg.name} ({n_params} f32 weights), {b} x {s} "
          f"tokens a step ({card})", flush=True)
    work = os.path.join(ROOT, "build", "launch")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {"card": card, "arch": cfg.name, "params": n_params}
    dry = os.path.join(work, "dryrun")
    dry_proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.dryrun",
         "--arch", LAUNCH_ARCH, "--shape", "train_4k", "--out", dry],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=cli_env(), cwd=ROOT)
    try:
        # -- 1. the train CLI: A uninterrupted, B resumed from A's step 6 --
        flags = ("--arch", LAUNCH_ARCH, "--batch", str(b), "--seq", str(s),
                 "--mesh", "1x1", "--log-every", "1", *cli_args)
        ckpt_a, ckpt_b = os.path.join(work, "A"), os.path.join(work, "B")
        rc, text, secs_a = run_cli(
            "repro_torch.launch.train", *flags, "--steps", str(steps),
            "--ckpt", ckpt_a, "--ckpt-every", str(LAUNCH["ckpt_every"]))
        done = f"done: {steps} steps"
        check(rc == 0 and done in text,
              f"train CLI run A: rc {rc}, {done!r} "
              f"{'found' if done in text else 'missing'}:\n{text[-2000:]}")
        print("\n".join("  A " + ln for ln in text.splitlines()
                        if ln.startswith("[train]")), flush=True)
        rate = [float(x) for x in
                re.findall(r"done: \d+ steps in [0-9.]+s \(([0-9.]+) steps/s",
                           text)]
        at = LAUNCH["resume_at"]
        name = f"step_{at:08d}"
        if os.path.isdir(os.path.join(ckpt_a, name)):
            shutil.copytree(os.path.join(ckpt_a, name),
                            os.path.join(ckpt_b, name))
        rc, text, secs_b = run_cli(
            "repro_torch.launch.train", *flags, "--steps", str(steps),
            "--ckpt", ckpt_b, "--resume")
        want = (f"resumed step {at} (data index {at})",
                f"done: {steps - at} steps")
        check(rc == 0 and all(w in text for w in want),
              f"train CLI run B: rc {rc}, want {want}:\n{text[-2000:]}")
        print("\n".join("  B " + ln for ln in text.splitlines()
                        if ln.startswith("[train]")), flush=True)
        last = f"step_{steps:08d}"
        same, n_arrays, first = (
            same_checkpoints(os.path.join(ckpt_a, last),
                             os.path.join(ckpt_b, last))
            if all(os.path.isdir(os.path.join(c, last))
                   for c in (ckpt_a, ckpt_b)) else (False, 0, "missing"))
        check(same, f"train CLI: B's resumed step-{steps} checkpoint differs "
                    f"from A's uninterrupted one ({first}; {n_arrays} arrays "
                    f"compared)")
        print(f"  train CLI: run A {secs_a:.1f} s ({rate[0] if rate else 0} "
              f"steps/s), run B {secs_b:.1f} s; step-{steps} checkpoints "
              f"of A and B bit-identical: {same} ({n_arrays} arrays)",
              flush=True)
        out.update(cli_a_s=secs_a, cli_b_s=secs_b, cli_steps_per_s=rate,
                   resume_bitwise=same, arrays=n_arrays)
        shutil.rmtree(ckpt_a, ignore_errors=True)
        shutil.rmtree(ckpt_b, ignore_errors=True)

        # -- 2. the roofline against the card ------------------------------
        stream = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                            batch_size=b, seq_len=s, seed=0),
                                 cfg)
        tcfg = TrainConfig(base_lr=1e-3, warmup_steps=max(1, steps // 20),
                           total_steps=steps)
        specs = input_specs(cfg, mode="train", batch=b, seq=s)
        mesh = make_mesh((1, 1), ("data", "model"))
        meta_model = init_params(cfg, device="meta")
        meta_step = build_train_step(cfg, tcfg, specs, mesh=mesh,
                                     device="meta")[0]
        t0 = time.perf_counter()
        train_cost = count_cost(meta_step, meta_model,
                                adamw_init(meta_model), specs, 0)
        count_s = time.perf_counter() - t0
        tokens = b * s
        train_roof = roofline.analyze(
            train_cost, roofline.model_flops_train(n_params, tokens), 1)

        model = init_params(cfg, generator=torch.Generator(device=dev)
                            .manual_seed(0), device=dev)
        opt = adamw_init(model)
        step = build_train_step(cfg, tcfg, specs, mesh=mesh, device=dev)[0]
        batch = stream.batch(0)

        step(model, opt, batch, 0)                      # warm-up
        step_ms, peaks = [], []
        for i in range(1, 4):
            (_, _, m), ms, peak = peak_over(
                lambda: step(model, opt, batch, i))
            step_ms.append(ms)
            peaks.append(peak)
        step_peak = max(peaks)
        loss = float(m["loss"])
        check(np.isfinite(loss), f"launch: the train step's loss is {loss}")
        train_ms = statistics.median(step_ms)
        train_frac = train_roof.bound * 1e3 / train_ms
        mem_ratio = train_cost.peak_bytes / max(step_peak, 1)
        check(train_frac <= LAUNCH_ROOF_MAX,
              f"train step: roofline bound {train_roof.bound * 1e3:.2f} ms "
              f"is {train_frac:.3f} of the measured {train_ms:.2f} ms "
              f"(at most {LAUNCH_ROOF_MAX}): a constant or the counter is "
              f"wrong")
        check(LAUNCH_MEM_RATIO[0] <= mem_ratio <= LAUNCH_MEM_RATIO[1],
              f"train step: op_cost's peak {train_cost.peak_bytes:.4g} B "
              f"against {step_peak} B allocated over the step's start: "
              f"ratio {mem_ratio:.3f} outside {LAUNCH_MEM_RATIO}")
        print(f"  train step ({card}): {train_ms:.1f} ms (median of "
              f"{step_ms}); counted {train_cost.flops:.4g} FLOP, "
              f"{train_cost.bytes:.4g} B in {count_s:.1f} s on meta; bound "
              f"{train_roof.bound * 1e3:.2f} ms ({train_roof.bottleneck}), "
              f"{train_frac:.3f} of the step; op_cost peak "
              f"{train_cost.peak_bytes:.4g} B / max_memory_allocated over "
              f"the start {step_peak} B = {mem_ratio:.3f}", flush=True)

        # -- one checkpoint save and restore of the trained state ----------
        ckpt = os.path.join(work, "S")
        t0 = time.perf_counter()
        save(ckpt, 1, {"params": convert.model_params_to_numpy(model, cfg),
                       "opt": convert.adamw_state_to_numpy(opt, cfg)})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, _, state = restore(ckpt, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del state, opt
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()

        # -- the prefill: the flash kernel against the substituted stub ----
        pbatch = {"tokens": batch["tokens"]}
        meta_tokens = {"tokens": torch.empty((b, s), dtype=torch.int32,
                                             device="meta")}
        with torch.no_grad():
            stub_cost = count_cost(prefill, meta_model, cfg, meta_tokens, s,
                                   CallConfig(attn_impl="stub"))
        stub_roof = roofline.analyze(
            stub_cost, roofline.model_flops_forward(n_params, tokens), 1)
        flash_roof = flashsub.substitute(
            stub_roof, flashsub.attn_shape_for(cfg, "prefill", s, b))
        tok = torch.as_tensor(pbatch["tokens"], device=dev)
        call = CallConfig(attn_impl="auto")
        with torch.no_grad():
            torch.cuda.synchronize()
            build.reset_counts()
            logits, _ = prefill(model, cfg, {"tokens": tok}, s, call)
            prefill_ms = [event_timed(lambda: prefill(model, cfg, {"tokens": tok},
                                                s, call))[1]
                          for _ in range(3)]
            torch.cuda.synchronize()
            launches = build.launch_counts()
        flash = launches["flash_attention"]
        check(flash == 4 * cfg.n_layers,
              f"launch prefill: {flash} flash launches in 4 prefills, not "
              f"{4 * cfg.n_layers}")
        check(bool(torch.isfinite(logits).all()),
              "launch prefill: logits not finite")
        pre_ms = statistics.median(prefill_ms)
        pre_frac = flash_roof.bound * 1e3 / pre_ms
        check(pre_frac <= LAUNCH_ROOF_MAX,
              f"prefill: flash-substituted bound {flash_roof.bound * 1e3:.2f}"
              f" ms is {pre_frac:.3f} of the measured {pre_ms:.2f} ms (at "
              f"most {LAUNCH_ROOF_MAX})")
        print(f"  prefill {b} x {s} ({card}): {pre_ms:.2f} ms (median of "
              f"{prefill_ms}), {flash} flash launches in 4 prefills; stub "
              f"counted {stub_cost.flops:.4g} FLOP, {stub_cost.bytes:.4g} B; "
              f"flash-substituted bound {flash_roof.bound * 1e3:.2f} ms "
              f"({flash_roof.bottleneck}), {pre_frac:.3f} of the prefill",
              flush=True)
        del model, logits, meta_model
        torch.cuda.empty_cache()

        # -- the peaks: a bf16 product and a device copy ---------------------
        n = LAUNCH["matmul_n"]
        x = torch.randn((n, n), device=dev, dtype=torch.bfloat16)
        y = torch.randn((n, n), device=dev, dtype=torch.bfloat16)
        torch.matmul(x, y)
        mm_ms = statistics.median(event_timed(lambda: torch.matmul(x, y))[1]
                                  for _ in range(5))
        mm_rate = 2 * n ** 3 / (mm_ms / 1e3)
        del x, y
        src = torch.empty(LAUNCH["copy_bytes"] // 4, device=dev,
                          dtype=torch.float32).fill_(1.0)
        dst = torch.empty_like(src)
        dst.copy_(src)
        cp_ms = statistics.median(event_timed(lambda: dst.copy_(src))[1]
                                  for _ in range(5))
        cp_rate = 2 * src.numel() * 4 / (cp_ms / 1e3)
        del src, dst
        torch.cuda.empty_cache()
        mm_ratio = mm_rate / roofline.PEAK_FLOPS_BF16
        cp_ratio = cp_rate / roofline.HBM_BW
        check(mm_ratio <= 1.0,
              f"a bf16 {n}^3 matmul ran at {mm_rate:.4g} FLOP/s, above "
              f"PEAK_FLOPS_BF16 {roofline.PEAK_FLOPS_BF16:.4g}")
        check(cp_ratio <= 1.0,
              f"a device copy moved {cp_rate:.4g} B/s, above HBM_BW "
              f"{roofline.HBM_BW:.4g}")
        print(f"  peaks ({card}): bf16 {n}^3 matmul {mm_ms:.3f} ms = "
              f"{mm_rate / 1e12:.1f} TFLOP/s, {mm_ratio:.3f} of "
              f"PEAK_FLOPS_BF16; {LAUNCH['copy_bytes'] / 1e9:.1f} GB copy "
              f"{cp_ms:.3f} ms = {cp_rate / 1e12:.3f} TB/s read + write, "
              f"{cp_ratio:.3f} of HBM_BW", flush=True)

        # -- the dry-run and report CLIs (started at the phase's start) -----
        dry_text, _ = dry_proc.communicate(timeout=600)
        rc, rep, _ = run_cli("repro_torch.launch.report", dry)
        row = f"| {LAUNCH_ARCH} | train_4k | ok "
        check(dry_proc.returncode == 0 and rc == 0 and row in rep,
              f"dry-run rc {dry_proc.returncode}, report rc {rc}, row "
              f"{row!r} {'found' if row in rep else 'missing'}:\n"
              f"{dry_text[-1500:]}\n{rep[-1500:]}")
        print("  dry-run CLI: " + " / ".join(
            ln.strip() for ln in dry_text.splitlines()
            if ln.strip().startswith(("roofline:", "op_cost:"))), flush=True)
        print("\n".join("  report: " + ln for ln in rep.splitlines()
                        if ln.strip()), flush=True)
    finally:
        if dry_proc.poll() is None:
            dry_proc.kill()
            dry_proc.wait()
        shutil.rmtree(work, ignore_errors=True)

    out.update(
        train_ms=train_ms, train_steps_ms=step_ms, train_count_s=count_s,
        train_roofline=train_roof.to_dict(),
        train_bound_ms=train_roof.bound * 1e3, train_fraction=train_frac,
        train_peak_counted=train_cost.peak_bytes, train_peak_card=step_peak,
        memory_ratio=mem_ratio, save_s=save_s, restore_s=restore_s,
        prefill_ms=pre_ms, prefill_runs_ms=prefill_ms,
        prefill_stub=stub_roof.to_dict(), prefill_flash=flash_roof.to_dict(),
        prefill_bound_ms=flash_roof.bound * 1e3, prefill_fraction=pre_frac,
        matmul_ms=mm_ms, matmul_ratio=mm_ratio, copy_ms=cp_ms,
        copy_ratio=cp_ratio, launches=launches)
    report["launch"] = out
    print(f"  launch ({card}): train step {train_ms:.1f} ms, bound "
          f"{train_roof.bound * 1e3:.2f} ms ({train_frac:.3f}); CLI "
          f"{rate} steps/s; prefill {pre_ms:.2f} ms, bound "
          f"{flash_roof.bound * 1e3:.2f} ms ({pre_frac:.3f}); memory ratio "
          f"{mem_ratio:.3f}; save {save_s:.2f} s, restore {restore_s:.2f} s; "
          f"launches {launches}", flush=True)
    return launches


def chunk_remat_phase(check, report, device=None):
    """``CallConfig.attn_chunk_remat`` on the card: smollm-360m at its
    published width and depth, 4 x 4096 tokens a step through
    ``build_train_step`` with the train CLI's config (lr 1e-3, warmup 1,
    AdamW), the chunked attention (chunks of 512) under layer remat, the
    knob off and on.

    1. One warm-up step each, then ``CHUNK_REMAT["steps"]`` timed steps
       each, alternated off / on (CUDA events; median): step ms, tokens/s
       and ``max_memory_allocated`` over each step's start.
    2. ``op_cost``'s FLOPs, bytes and peak of the same step on ``meta``,
       and the H100 roofline's bound over the measured step (at most
       ``LAUNCH_ROOF_MAX``).
    3. One step's loss and gradients with the knob off and on, on the same
       weights and batch: the losses the same bits, the gradients within
       ``CHUNK_REMAT_GRAD_REL`` relative L2.
    4. One decoder layer's forward and backward under remat (the step's
       own peak is set by the loss's (4, 4096, 49152) f32 tensors once the
       knob is on): its peak over its start, off against on.

    The peak must be lower and the counted FLOPs higher with the knob on.
    No kernel runs (the kernels have no backward): the launch counts over
    the phase stay 0.  ``device`` is for a rehearsal on the CPU with the
    CUDA calls faked."""
    import numpy as np
    import torch
    from repro_torch.data import DataConfig, SyntheticStream, input_specs
    from repro_torch.kernels import build
    from repro_torch.launch import roofline
    from repro_torch.launch.op_cost import count_cost
    from repro_torch.models import CallConfig, count_params, get, init_params
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw_init
    from repro_torch.train import (
        TrainConfig, build_train_step, grads_with_microbatching,
    )

    dev = torch.device(device or "cuda")
    card = nvidia_smi("name,power.limit")
    cfg = get(CHUNK_REMAT_ARCH)
    b, s = CHUNK_REMAT["batch"], CHUNK_REMAT["seq"]
    tokens = b * s
    n_params = count_params(cfg)
    print(f"== chunk remat: {cfg.name} ({n_params} f32 weights), {b} x {s} "
          f"tokens a step, chunks of {CHUNK_REMAT['chunk']} ({card})",
          flush=True)
    t_phase = time.perf_counter()
    specs = input_specs(cfg, mode="train", batch=b, seq=s)
    batch = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                       batch_size=b, seq_len=s, seed=0),
                            cfg).batch(0)
    settings = (False, True)
    calls = {knob: CallConfig(attn_impl="chunked",
                              attn_chunk=CHUNK_REMAT["chunk"],
                              ssm_impl="plain", remat=True,
                              attn_chunk_remat=knob) for knob in settings}
    tcfgs = {knob: TrainConfig(base_lr=1e-3, warmup_steps=1,
                               total_steps=8, call=calls[knob])
             for knob in settings}

    # -- op_cost of each setting's step on meta -------------------------
    meta_model = init_params(cfg, device="meta")
    counted, roofs = {}, {}
    for knob in settings:
        meta_step = build_train_step(cfg, tcfgs[knob], specs,
                                     device="meta")[0]
        counted[knob] = count_cost(meta_step, meta_model,
                                   adamw_init(meta_model), specs, 0)
        roofs[knob] = roofline.analyze(
            counted[knob], roofline.model_flops_train(n_params, tokens), 1)
    del meta_model

    model = init_params(cfg, generator=torch.Generator(device=dev)
                        .manual_seed(0), device=dev)
    opt = adamw_init(model, tcfgs[False].adamw)
    steps = {knob: build_train_step(cfg, tcfgs[knob], specs, device=dev)[0]
             for knob in settings}
    torch.cuda.synchronize()
    build.reset_counts()
    ms = {knob: [] for knob in settings}
    peaks = {knob: [] for knob in settings}
    losses = {knob: [] for knob in settings}
    for i in range(1 + CHUNK_REMAT["steps"]):
        for knob in settings:
            (_, _, m), t, peak = peak_over(
                lambda: steps[knob](model, opt, batch, i))
            losses[knob].append(float(m["loss"]))
            if i:                                   # after the warm-up
                ms[knob].append(t)
                peaks[knob].append(peak)
    check(all(np.isfinite(v) for knob in settings for v in losses[knob]),
          f"chunk remat: a loss is not finite: {losses}")

    # -- one step's loss and gradients, off against on ------------------
    grads = {knob: grads_with_microbatching(cfg, calls[knob], 1)(
        model, {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        for knob in settings}
    (l_off, g_off), (l_on, g_on) = grads[False], grads[True]
    num = sum(float(torch.sum((g_on[n] - g_off[n]) ** 2)) for n in g_off)
    den = sum(float(torch.sum(g_off[n] ** 2)) for n in g_off)
    grad_rel = (num / den) ** 0.5
    check(float(l_on) == float(l_off),
          f"chunk remat: the loss with the knob on {float(l_on)!r}, off "
          f"{float(l_off)!r}")
    check(grad_rel <= CHUNK_REMAT_GRAD_REL,
          f"chunk remat: gradients on vs off rel L2 {grad_rel:.3g} (bar "
          f"{CHUNK_REMAT_GRAD_REL})")
    del grads, g_off, g_on

    # -- one decoder layer's forward and backward -----------------------
    lp = model.layer_params(0)
    x0 = torch.randn((b, s, cfg.d_model), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(1)
                     ).to(torch.bfloat16)
    positions = torch.arange(s, device=dev, dtype=torch.int32)[None].expand(
        b, s)

    def layer(knob):
        x = x0.detach().requires_grad_(True)
        y, _ = model_lib._run_layer(calls[knob], model_lib._decoder_layer, x,
                                    lp, cfg, positions, 0, calls[knob])
        y.float().sum().backward()
        return x.grad

    layer_peak, layer_ms = {}, {}
    for knob in settings:
        layer(knob)                                 # warm-up
        model.zero_grad(set_to_none=True)
        _, layer_ms[knob], layer_peak[knob] = peak_over(lambda: layer(knob))
        model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    launches = build.launch_counts()
    check(not any(launches.values()),
          f"chunk remat: a kernel launched under autograd: {launches}")
    del model, opt, x0
    torch.cuda.empty_cache()

    out = {"card": card, "arch": cfg.name, "params": n_params,
           "batch": b, "seq": s, "chunk": CHUNK_REMAT["chunk"],
           "grad_rel_l2": grad_rel, "loss": float(l_on), "launches": launches}
    for knob in settings:
        step_ms = statistics.median(ms[knob])
        bound_ms = roofs[knob].bound * 1e3
        frac = bound_ms / step_ms
        peak = max(peaks[knob])
        check(frac <= LAUNCH_ROOF_MAX,
              f"chunk remat {knob}: roofline bound {bound_ms:.2f} ms is "
              f"{frac:.3f} of the measured {step_ms:.2f} ms (at most "
              f"{LAUNCH_ROOF_MAX})")
        name = "on" if knob else "off"
        out[name] = {
            "step_ms": step_ms, "steps_ms": ms[knob],
            "tokens_per_s": tokens / (step_ms / 1e3), "peak_bytes": peak,
            "peaks": peaks[knob], "losses": losses[knob],
            "counted_flops": counted[knob].flops,
            "counted_bytes": counted[knob].bytes,
            "counted_peak": counted[knob].peak_bytes,
            "bound_ms": bound_ms, "bottleneck": roofs[knob].bottleneck,
            "roofline_fraction": frac, "layer_ms": layer_ms[knob],
            "layer_peak_bytes": layer_peak[knob]}
        print(f"  knob {name:3s} ({card}): step {step_ms:.1f} ms (median of "
              f"{[round(t, 1) for t in ms[knob]]}), {tokens / (step_ms / 1e3):.0f} "
              f"tokens/s; peak over the step's start {peak} B; counted "
              f"{counted[knob].flops:.4g} FLOP, {counted[knob].bytes:.4g} B, "
              f"peak {counted[knob].peak_bytes:.4g} B; bound {bound_ms:.2f} "
              f"ms ({roofs[knob].bottleneck}), {frac:.3f} of the step; one "
              f"layer's forward + backward {layer_ms[knob]:.2f} ms, peak "
              f"{layer_peak[knob]} B", flush=True)
    check(out["on"]["peak_bytes"] < out["off"]["peak_bytes"],
          f"chunk remat: the step's peak with the knob on "
          f"{out['on']['peak_bytes']} B is not below off "
          f"{out['off']['peak_bytes']} B")
    check(layer_peak[True] < layer_peak[False],
          f"chunk remat: one layer's peak with the knob on "
          f"{layer_peak[True]} B is not below off {layer_peak[False]} B")
    check(counted[True].flops > counted[False].flops,
          f"chunk remat: counted FLOPs on {counted[True].flops:.4g} not "
          f"above off {counted[False].flops:.4g}")
    out["seconds"] = time.perf_counter() - t_phase
    report["chunk_remat"] = out
    print(f"  chunk remat ({card}): losses {losses[False]} off, "
          f"{losses[True]} on; one step's gradients on vs off rel L2 "
          f"{grad_rel:.3g}; step {out['off']['step_ms']:.1f} -> "
          f"{out['on']['step_ms']:.1f} ms, peak {out['off']['peak_bytes']} -> "
          f"{out['on']['peak_bytes']} B, one layer's peak "
          f"{layer_peak[False]} -> {layer_peak[True]} B; launches "
          f"{launches}; {out['seconds']:.1f} s", flush=True)


#: runs the walkthrough ``sys.argv[1]`` as ``__main__`` with the arguments
#: after it, then prints that process's launch counts
_EXAMPLE_WRAPPER = """
import json, runpy, sys
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
from repro_torch.kernels import build
print("LAUNCHES " + json.dumps(build.launch_counts()), flush=True)
"""


def serve_twin_kernels(check, report, device=None):
    """The serving walkthrough's kernels against their plain versions at
    its own shapes: its three models (``model_and_prompts`` of
    ``examples/torch_serve_batch.py``: the same reduced configs, weights
    and prompts) in this process.  Every flash and scan call of the
    engine's prefill (``SERVE_CALL``: "auto", so a kernel wherever it
    takes the shapes; head dim 32, 16 query rows, one 16-token scan
    chunk) is recorded with its inputs, then run again through the kernel
    and through ``kernels.ref`` on those inputs (``FLASH_TOL``,
    ``SCAN_TOL``); where a kernel ran, the prefill's last-position logits
    with the kernels against the plain versions (``prefill_vs_plain``,
    ``PREFILL_TOL``, bf16 and f32 compute).  Returns the calls held, by
    kernel."""
    import importlib.util
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import prefill
    from repro_torch.serve.engine import SERVE_CALL

    dev = torch.device(device or "cuda")
    spec = importlib.util.spec_from_file_location(
        "torch_serve_batch", os.path.join(ROOT, "examples",
                                          "torch_serve_batch.py"))
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    demo = twin.demo.__defaults__            # (batch, prompt, new)
    batch_n, prompt, new = demo
    max_len = prompt + new + 1               # the twin's ServeConfig
    held = {"flash_attention": 0, "ssm_scan": 0}
    rows = {}
    for arch in twin.ARCHS:
        cfg, params, ex = twin.model_and_prompts(arch, batch_n, prompt)
        model = params.to(dev)
        batch = {"tokens": torch.as_tensor(ex["tokens"]).to(dev)}
        calls, orig = [], {n: getattr(ops, n) for n in ("attention",
                                                         "ssm_scan")}

        def recorder(name):
            def call(*args, **kw):
                calls.append((name, [t.clone() for t in args],
                              {k: v.clone() if torch.is_tensor(v) else v
                               for k, v in kw.items()}))
                return orig[name](*args, **kw)
            return call

        try:
            ops.attention = recorder("attention")
            ops.ssm_scan = recorder("ssm_scan")
            with torch.no_grad():
                prefill(model, cfg, batch, max_len, SERVE_CALL)
        finally:
            ops.attention, ops.ssm_scan = orig["attention"], orig["ssm_scan"]
        errs = {"flash_attention": [], "ssm_scan": []}
        with torch.no_grad():
            for i, (name, args, kw) in enumerate(calls):
                tag = f"{arch} serve twin #{i}"
                if name == "attention":
                    errs["flash_attention"].append(held_attention(
                        check, report, *args, kw.get("causal", True), tag))
                else:
                    errs["ssm_scan"].append(held_scan(
                        check, report, *args, kw.get("h0"), tag,
                        return_state=kw.get("return_state", False)))
        for k, v in errs.items():
            held[k] += len(v)
        row = {k: {"calls": len(v), "max_abs_err": max(v, default=None)}
               for k, v in errs.items()}
        print(f"  serve twin {arch}: prefill of {batch_n} x {prompt} tokens, "
              + ", ".join(f"{k} {r['calls']} calls max_abs_err "
                          f"{r['max_abs_err']}" for k, r in row.items()),
              flush=True)
        if calls:
            with torch.no_grad():
                row["prefill_logits"] = prefill_vs_plain(check, cfg, model,
                                                         batch, max_len)
        rows[arch] = row
        del model, params, calls
    report["serve_twin_kernels"] = rows
    return held


def examples_phase(check, report, device=None):
    """The port's walkthroughs (``examples/torch_*.py``) on the card, all
    five started together, each as a script in a process of its own (the
    checkout's ``src`` on the path; the kernels' library is the one this
    run built), the four that touch a device with ``--device cuda``.  A
    wrapper runs the script as ``__main__`` and then prints that process's
    kernel launch counts, so the axpy (quickstart, job graph), flash and
    scan (serve batch) launches are counted here; they are not part of the
    main paths' counts.  Checks: rc 0 and the printed facts — every
    ``allclose=True``, the OFL001 rejection, the bit-identical autofix,
    the failure and resume, the final loss below the first; then
    :func:`serve_twin_kernels` holds the serving walkthrough's flash and
    scan calls against their plain versions, as many calls of each as
    its process launched.  ``device`` is for a rehearsal on the CPU."""
    from concurrent.futures import ThreadPoolExecutor

    dev = device or "cuda"
    print("== examples: the port's walkthroughs on the card", flush=True)
    t0 = time.perf_counter()

    def run(name):
        args = () if name == "torch_offload_model_validation" else (
            "--device", dev)
        return run_py("-c", _EXAMPLE_WRAPPER,
                      os.path.join(ROOT, "examples", name + ".py"), *args)

    with ThreadPoolExecutor(len(EXAMPLES)) as pool:
        done = dict(zip(EXAMPLES, pool.map(run, EXAMPLES)))
    texts = {name: text for name, (_, text, _) in done.items()}
    secs = {name: t for name, (_, _, t) in done.items()}
    counts = {}
    total = {}
    for name, (rc, text, _) in done.items():
        tail = [ln for ln in text.splitlines() if ln.startswith("LAUNCHES ")]
        counts[name] = json.loads(tail[-1][9:]) if tail else {}
        for k, v in counts[name].items():
            total[k] = total.get(k, 0) + v
        check(rc == 0 and tail, f"example {name}: rc {rc}:\n{text[-2000:]}")
        print(f"  {name}: rc {rc}, {secs[name]:.1f} s, launches "
              f"{ {k: v for k, v in counts[name].items() if v} }", flush=True)
        print("\n".join("    | " + ln for ln in text.splitlines()
                        if not ln.startswith("LAUNCHES ")), flush=True)
    qs, jg = texts["torch_quickstart"], texts["torch_job_graph"]
    check(qs.count("allclose=True") == 5 and "allclose=False" not in qs,
          "torch_quickstart: not every allclose=True")
    check("allclose vs sequential numpy: True" in jg
          and "codes=('OFL001',)" in jg
          and "autofixed graph bit-identical: True" in jg,
          "torch_job_graph: a printed fact is missing")
    tl = texts["torch_train_lm"]
    loss = re.search(r"first loss ([0-9.]+) -> final ([0-9.]+)", tl)
    check("--- resumed from step 120 on mesh (4,) ---" in tl
          and loss is not None
          and float(loss.group(2)) < float(loss.group(1)),
          "torch_train_lm: no resume line or the loss did not fall")
    sb = texts["torch_serve_batch"]
    check(sb.count("weight placement:") == 3,
          "torch_serve_batch: not three models served")
    for k in ("axpy", "flash_attention", "ssm_scan"):
        check(total.get(k, 0) > 0,
              f"the walkthroughs never launched the {k} kernel")
    held = serve_twin_kernels(check, report, device)
    served = counts.get("torch_serve_batch", {})
    for k, n in held.items():
        check(n == served.get(k),
              f"torch_serve_batch launched {k} {served.get(k)} times; the "
              f"same prefills here called it {n} times")
    seconds = time.perf_counter() - t0
    report["examples"] = {"seconds": secs, "launches": counts,
                          "held": held, "wall_s": seconds}
    print(f"  examples: {seconds:.1f} s for all five (started together) and "
          f"the serving walkthrough's {held} kernel calls held against "
          f"their plain versions; launches {total}", flush=True)


def prefix_decode_check(check, report, served):
    """paligemma's decode step after a prefill of its patches and prompts,
    against the prefill's last-position logits over the patches, the
    prompts and that token, at full width and depth: the prefix must
    carry through the cache (its P positions written, ``pos`` = P + S
    after the prefill and P + S + 1 after the step).  In float32 compute
    (the seed's f32 weights, drawn again in place of the model the
    engines narrowed, and narrowed again after) within ``DECODE_TOL``
    relative L2; the bf16 figure is printed beside it, not a gate."""
    import torch
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.model import narrow_serving_weights

    dev = torch.device("cuda")
    cfg = served["cfg"]
    served["model"] = None
    model = served["model"] = seed_model(cfg)
    toks = torch.as_tensor(served["prompts"]).to(dev)
    patches = torch.as_tensor(served["extra"]["patches"]).to(dev)
    nxt = torch.as_tensor(served["outs"]["step"][:, :1]).to(dev)
    p, s = patches.shape[1], toks.shape[1]
    rows = {}
    for tag in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=tag)
        _, cache = prefill(model, c, {"tokens": toks, "patches": patches},
                           p + s + 1)
        pos = int(cache["pos"])
        dec, cache = decode_step(model, c, cache, nxt)
        after = int(cache["pos"])
        del cache
        full = prefill(model, c, {"tokens": torch.cat([toks, nxt], dim=1),
                                  "patches": patches}, p + s + 1)[0]
        dec, full = dec.double(), full.double()
        d = dec - full
        rows[tag] = {"rel_l2": (d.norm() / full.norm()).item(),
                     "max_abs_err": d.abs().max().item(),
                     "max_abs_logit": full.abs().max().item(),
                     "finite": bool(torch.isfinite(dec).all()),
                     "pos_after_prefill": pos, "pos_after_decode": after}
        del dec, full, d
        torch.cuda.empty_cache()
    narrow_serving_weights(model, cfg)
    r32 = rows["float32"]
    check(r32["finite"] and r32["rel_l2"] <= DECODE_TOL,
          f"{cfg.name}: the f32 decode step after the prefix is {r32} from "
          f"the full-sequence path (bar: relative L2 {DECODE_TOL})")
    check(all(r["pos_after_prefill"] == p + s
              and r["pos_after_decode"] == p + s + 1 for r in rows.values()),
          f"{cfg.name}: cache positions {rows} (want {p + s} after the "
          f"prefill of {p} patches and {s} tokens, then {p + s + 1})")
    report["vision_serving"]["prefix_decode"] = rows
    for tag, r in rows.items():
        print(f"  decode after the prefix vs full sequence ({p} patches + "
              f"{s} tokens + 1), {tag} compute: relative L2 "
              f"{r['rel_l2']:.4g}, max_abs_err {r['max_abs_err']:.4g} (max "
              f"|logit| {r['max_abs_logit']:.4g}); cache pos "
              f"{r['pos_after_prefill']} -> {r['pos_after_decode']}"
              + (f"; bar {DECODE_TOL}" if tag == "float32"
                 else "; not a gate"), flush=True)


def serve_state_model(check, report, cfg, st, *, key, n_params, per_prefill,
                      shape):
    """A model served through ``generate`` only (the ``ssm``, ``hybrid``
    and MLA families) at its published width through ``ServeEngine`` on
    the card: random f32 weights from a seeded generator, bf16 compute;
    ``generate`` in every decode mode (identical greedy tokens; the vision
    stub's patches drawn from the prompts' stream), each
    prefill launching every kernel of ``per_prefill`` that many times
    (0: never); ``generate_many`` raises, as the reference's does; where
    a prefill launches a kernel, the prefill logits with the kernels
    against the plain versions (``prefill_vs_plain``); prefill and decode
    times, peak memory and busy shares.  Returns what
    the graphs phase reuses: the launch counts of the serving run, the
    config, the model (still on the card), the prompts and every mode's
    greedy tokens."""
    import numpy as np
    import torch
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.kernels import build
    from repro_torch.models import CallConfig, init_params, prefill
    from repro_torch.models.model import narrow_serving_weights, prefix_tokens
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.engine import build_sampling_step

    dev = torch.device("cuda")
    print(f"== serving: {cfg.name} ({shape}; {cfg.param_dtype} weights, "
          f"{cfg.compute_dtype} compute)", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    free, total = torch.cuda.mem_get_info()
    print(f"  device memory before the draw: {free} B free of {total} B, "
          f"{torch.cuda.memory_allocated()} B allocated", flush=True)
    t0 = time.perf_counter()
    model = init_params(cfg, generator=torch.Generator(device=dev)
                        .manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    got_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    check(got_params == n_params, f"{got_params} parameters")
    print(f"  init: {got_params} parameters, {param_bytes} B on the card in "
          f"{init_s:.2f} s", flush=True)

    ex = SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, batch_size=st["batch"],
        seq_len=st["prompt_len"], seed=0), cfg).batch(0)
    prompts = ex["tokens"]
    # the vision stub's precomputed patches, drawn with the prompts (as the
    # serve CLI draws them); their positions come first in the cache
    extra = {k: v for k, v in ex.items() if k == "patches"}
    prefix = prefix_tokens(cfg)
    max_len = prefix + st["prompt_len"] + st["new_tokens"] + 1

    # -- the main path, counted ------------------------------------------
    outs, stats, wall = {}, {}, {}
    torch.cuda.synchronize()
    build.reset_counts()
    for mode in ("step", "chunk", "host"):
        eng = ServeEngine(cfg, model, ServeConfig(
            batch=st["batch"], max_len=max_len, decode_mode=mode,
            decode_chunk=st["decode_chunk"]))
        t0 = time.perf_counter()
        outs[mode] = eng.generate(prompts, st["new_tokens"], extra or None)
        torch.cuda.synchronize()
        wall[mode] = time.perf_counter() - t0
        stats[mode] = dict(eng.stats)
    launches = build.launch_counts()

    for name, n in per_prefill.items():
        want = n * len(outs)
        check(launches[name] == want,
              f"serving {cfg.name} launched {name} {launches[name]} times, "
              f"not {n} times in each of {len(outs)} prefills ({want})")
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
    check(raised, f"generate_many did not raise for the {cfg.family} "
                  f"family")
    narrowed = print_narrowed(stats)
    for mode in outs:
        print(f"  generate {mode:5s}: batch {st['batch']} x "
              f"{st['prompt_len']} prompt tokens, {st['new_tokens']} new: "
              f"{wall[mode]:.3f} s wall; stats {stats[mode]}", flush=True)
    print(f"  launches: " + " ".join(f"{k}={launches[k]}" for k in
                                     per_prefill)
          + f" ({per_prefill} a prefill)", flush=True)
    print(f"  step tokens, row 0: {outs['step'][0].tolist()}", flush=True)
    print("  generate_many: raises NotImplementedError, as the reference's",
          flush=True)

    # -- prefill with the kernels against the plain versions --------------
    toks = torch.as_tensor(prompts).to(dev)
    batch = dict({k: torch.as_tensor(v).to(dev) for k, v in extra.items()},
                 tokens=toks)
    kernels = any(per_prefill.values())
    calls = {impl: CallConfig(ssm_impl=impl, attn_impl=impl,
                              moe_no_drop=True)
             for impl in (("kernel", "plain") if kernels else ("auto",))}
    prefill_cmp = {}
    if kernels:
        # on the seed's float32 weights, drawn again where the engines
        # narrowed them; narrowed again after, as served
        del eng, model
        model = seed_model(cfg)
        prefill_cmp = prefill_vs_plain(check, cfg, model, batch, max_len)
        narrow_serving_weights(model, cfg)

    def prefill_s(impl):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(model, cfg, batch, max_len, calls[impl])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    runs = {impl: [] for impl in calls}
    for impl in (("kernel", "plain", "plain", "kernel", "kernel", "plain")
                 if kernels else ("auto",) * 3):
        runs[impl].append(prefill_s(impl))
    prefill_ms = {impl: statistics.median(v) * 1e3
                  for impl, v in runs.items()}
    main_impl = "kernel" if kernels else "auto"
    n_steps, n_prof = 16, 3
    # room for every step timed below (the hybrid's K/V bound the position)
    steps_len = max(max_len, prefix + st["prompt_len"] + n_steps + n_prof
                    + 4)
    _, cache = prefill(model, cfg, batch, steps_len, calls[main_impl])
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
    print(f"  prefill (batch {st['batch']} x {st['prompt_len']}): "
          + ", ".join(f"{'kernels' if impl == 'kernel' else impl} "
                      f"{ms:.3f} ms" for impl, ms in prefill_ms.items())
          + f" (median of 3, host clock); decode step (batch "
          f"{st['batch']}, step mode): {decode_ms:.3f} ms per step; peak "
          f"device memory {peak} B", flush=True)

    # -- where a prefill's and a decode step's time goes -----------------
    def step_once():
        nonlocal tok, cache
        tok, cache = step(cache, tok, gen)

    busy = {"prefill": device_busy(
                lambda: prefill(model, cfg, batch, max_len,
                                calls[main_impl]), 1),
            "decode_step": device_busy(step_once, n_prof)}
    for what, b in busy.items():
        print(f"  profile {what}: wall {b['wall_us']:.1f} us (profiled), "
              f"device {b['device_us']:.1f} us, busy share "
              f"{b['busy_share']:.3f}, {b['launches']} device ops; top "
              + "; ".join(f"{k[:40]} {us:.1f} us x{c}"
                          for k, us, c in b["top"]), flush=True)
    report[key] = {
        "arch": cfg.name, "n_params": got_params, "param_bytes": param_bytes,
        "narrowed_bytes": narrowed, "init_s": init_s, "static": st,
        "wall_s": wall,
        "stats": stats, "prefill_ms": prefill_ms, "prefill_runs_s": runs,
        "decode_ms_per_step": decode_ms, "prefill_logits": prefill_cmp,
        "busy": busy, "max_memory_allocated": peak, "launches": launches,
        "per_prefill": per_prefill, "prefix_tokens": prefix,
        "tokens_row0": outs["step"][0].tolist()}
    del cache, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "cfg": cfg, "model": model,
            "prompts": prompts, "extra": extra, "outs": outs, "static": st,
            "max_len": max_len, "param_bytes": param_bytes}


def prefill_vs_plain(check, cfg, model, batch, max_len):
    """The last-position prefill logits of ``batch`` with the kernels
    against the plain versions, in bf16 and in f32 compute (both over
    ``model``'s f32 weights), within ``PREFILL_TOL``; routing without
    drops, as the engine's prefill routes.  Returns the errors by compute dtype."""
    import torch
    from repro_torch.models import CallConfig, prefill

    calls = {impl: CallConfig(ssm_impl=impl, attn_impl=impl,
                              moe_no_drop=True)
             for impl in ("kernel", "plain")}
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    rows = {}
    for tag, c in (("bfloat16", cfg), ("float32", f32)):
        lg = {impl: prefill(model, c, batch, max_len, call)[0].double()
              for impl, call in calls.items()}
        torch.cuda.synchronize()
        lp = lg["plain"]
        d = lg["kernel"] - lp
        row = {"max_abs_logit": lp.abs().max().item(),
               "kernel": {"max_abs_err": d.abs().max().item(),
                          "rel_l2": (d.norm() / lp.norm()).item()}}
        tol = PREFILL_TOL[tag]
        ok = (lg["kernel"].shape == (batch["tokens"].shape[0], 1,
                                     cfg.vocab_size)
              and bool(torch.isfinite(lg["kernel"]).all()))
        if "rel_l2" in tol:
            ok = ok and row["kernel"]["rel_l2"] <= tol["rel_l2"]
        else:
            ok = ok and bool((d.abs() <= tol["atol"]
                              + tol["rtol"] * lp.abs()).all())
        check(ok, f"{cfg.name} prefill logits in {tag} compute, kernels vs "
                  f"plain versions: {row['kernel']} outside {tol}")
        rows[tag] = row
        print(f"  prefill logits, {tag} compute (max |logit| "
              f"{row['max_abs_logit']:.4g}): kernels vs plain versions "
              f"max_abs_err {row['kernel']['max_abs_err']:.4g}, relative L2 "
              f"{row['kernel']['rel_l2']:.4g}; bar {tol}", flush=True)
        del lg, lp, d
    return rows


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
    aops, aexp = axpy.make_instance(3)
    # the ladder's bisection probe is an axpy of faults.probe_size(k)
    # elements: the reference's 840 up to 8 clusters, lcm(840, k) past
    # that (the reference's probe cannot be planned on 16 or 32)
    for n in (8, 32):
        inj = FaultInjector(FaultPlan([FaultSpec(FaultKind.LOST_ARRIVAL,
                                                 at_dispatch=0, count=1)]))
        sess = (Session(device, faults=inj, policy=OffloadPolicy(
            retry=RetryPolicy())) if device is not None else
            Session(faults=inj, policy=OffloadPolicy(retry=RetryPolicy())))
        err = held(f"retry n={n}", sess.submit(axpy, dict(aops), n=n).wait(),
                   aexp)
        hl = sess.health()
        rungs = (hl.deadline_trips, hl.retries, hl.probes, hl.backups)
        # tests/test_torch_fabric.py and test_torch_probe.py pin the same
        # rungs for a lost arrival
        check(rungs == (1, 1, 1, 0) and hl.jobs_ok == 1
              and hl.jobs_failed == 0,
              f"retry n={n}: rungs {rungs}, ok {hl.jobs_ok}, failed "
              f"{hl.jobs_failed}")
        out["retry" if n == 8 else f"retry_n{n}"] = {
            "rungs": rungs, "jobs_ok": hl.jobs_ok, "max_abs_err": err,
            "health": dataclasses.asdict(hl)}
        print(f"  axpy n={n}: recovered, err {err:.2g}; (trips, retries, "
              f"probes, backups) = {rungs}", flush=True)
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


def eager_programs(device):
    """A graph cache that runs every program's eager body: swapped into a
    runtime or an engine, it gives the eager side of the captured-vs-eager
    checks through the same code (the port itself has no such switch)."""
    from repro_torch.core import graphs

    class Eager(graphs.GraphCache):
        def run(self, key, make_body, **kw):
            return make_body()()

    return Eager(device)


def graphs_offload_phase(check, report, device=None, sizes=None):
    """Resident offload as captured CUDA graphs (``core/graphs.py``):
    every job at the offload phase's larger size, baseline and extended,
    n in ``NS``, on a runtime that captures and on one that runs the same
    dispatches eagerly (``eager_programs``).

    Checks: three resident dispatches with changed job args (the new
    value copied into the graph's args buffer), waited in reverse order,
    within rtol=atol=1e-9 of the expected values and bit-identical to the
    eager runtime's; the launch traces equal; each graph one chain of
    dependent nodes whose count exceeds the extended graph's by the
    baseline's 2(n-1) chain and counter hops (read from libcuda); the
    kernel of each kernel job launched once a replay.  Times: resident
    ``offload().wait()`` ms, eager and captured alternated.  Returns the
    launch counts of the phase."""
    import numpy as np
    import torch
    from repro_torch.core import graphs, jobs
    from repro_torch.core.offload import (
        OffloadConfig, OffloadRuntime, count_collectives,
    )
    from repro_torch.core.policy import Residency
    from repro_torch.kernels import build

    sizes = sizes or {name: OFFLOAD_SIZES[name][1] for name in jobs.PAPER_JOBS}
    on_card = device is None
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    print("== graphs: resident offload, captured vs eager, six jobs x "
          f"{{baseline, extended}} x n in {NS}", flush=True)
    configs = {"baseline": OffloadConfig.baseline(),
               "extended": OffloadConfig.extended()}
    rows, nodes = [], {}
    build.reset_counts()
    for cname, cfg in configs.items():
        rt = OffloadRuntime(device, config=cfg)
        eager = OffloadRuntime(device, config=cfg)
        eager._graphs = eager_programs(eager.device)
        for name in jobs.PAPER_JOBS:
            job = jobs.PAPER_JOBS[name](*sizes[name])
            operands, expected = job.make_instance(3)
            for n in NS:
                tag = f"{cname:8s} {job.spec.name:28s} n={n:2d}"
                try:
                    rt.offload(job, operands, n=n).wait()
                except ValueError as e:
                    check("not divisible" in str(e), f"graphs {tag}: {e}")
                    continue
                eager.offload(job, operands, n=n).wait()
                scales = (2.0, 3.0, 1.0)
                got = {}
                for side, r in (("captured", rt), ("eager", eager)):
                    hs = [r.offload(job, Residency.RESIDENT, n=n,
                                    job_args=np.full(8, a)) for a in scales]
                    got[side] = [h.wait() for h in reversed(hs)][::-1]
                close = all(np.allclose(g, expected * a, **JOB_TOL)
                            for g, a in zip(got["captured"], scales))
                same = all(np.array_equal(g, e) for g, e in
                           zip(got["captured"], got["eager"]))
                err = float(max(np.max(np.abs(g - expected * a))
                                for g, a in zip(got["captured"], scales)))
                check(close, f"graphs {tag}: captured result off by "
                             f"{err:.3g}")
                check(same, f"graphs {tag}: captured and eager results "
                            f"differ")
                pc, pe = rt.plan(job, n=n), eager.plan(job, n=n)
                check(pc.fn.trace == pe.fn.trace
                      and rt.launch_trace(job, n) == eager.launch_trace(
                          job, n),
                      f"graphs {tag}: launch traces differ")
                g = rt._graphs.get(pc.build_key)
                check(g is not None and g.replays >= len(scales) - 1,
                      f"graphs {tag}: the resident dispatches did not "
                      f"replay a graph")
                kname = name if name in KERNEL_JOBS else None
                check(g.launches == ({kname: 1} if kname else {}),
                      f"graphs {tag}: a replay launches {g.launches}")
                census = graphs.census(g) if on_card else {}
                if on_card:
                    check(census["depth"] == census["nodes"],
                          f"graphs {tag}: the graph is not one chain of "
                          f"dependent nodes: {census}")
                    nodes[(cname, name, n)] = census["nodes"]

                def once(r):
                    sync()
                    t0 = time.perf_counter()
                    r.offload(job, Residency.RESIDENT, n=n).wait()
                    return (time.perf_counter() - t0) * 1e3

                ms = {"eager": [], "captured": []}
                for _ in range(GRAPH_PASSES):
                    for side, r in (("eager", eager), ("captured", rt),
                                    ("captured", rt), ("eager", eager)):
                        ms[side].append(once(r))
                row = {"config": cname, "job": job.spec.name, "n": n,
                       "max_abs_err": err, "bit_identical": same,
                       "eager_ms": statistics.median(ms["eager"]),
                       "captured_ms": statistics.median(ms["captured"]),
                       "runs_ms": ms, "census": census,
                       "capture_s": g.capture_s, "pool_bytes": g.pool_bytes,
                       "collectives": {k: v for k, v in count_collectives(
                           pc.fn.trace).items() if v}}
                rows.append(row)
                print(f"  {tag}: err {err:.2g}, bit-identical {same}; "
                      f"resident eager {row['eager_ms']:.3f} ms, captured "
                      f"{row['captured_ms']:.3f} ms; graph {census}, "
                      f"capture {g.capture_s * 1e3:.1f} ms, pool "
                      f"{g.pool_bytes} B; {row['collectives']}", flush=True)
        del rt, eager
        if on_card:
            torch.cuda.empty_cache()
    for (cname, name, n), count in nodes.items():
        if cname != "baseline" or ("extended", name, n) not in nodes:
            continue
        extra = count - nodes[("extended", name, n)]
        want = 2 * (n - 1) + 1 if n > 1 else -1
        check(extra == want,
              f"graphs {name} n={n}: the baseline graph has {extra} nodes "
              f"more than the extended one, not its chain's {want}")
    launches = build.launch_counts()
    report["graphs_offload"] = {"rows": rows, "launches": launches}
    print(f"  launches over the phase (replays included): "
          + " ".join(f"{k}={v}" for k, v in launches.items()), flush=True)
    return launches


def graphs_phase(check, report, served):
    """A served model's decode programs as captured CUDA graphs, at full
    width (``served`` from ``serving_phase`` or ``ssm_serving_phase``).

    1. Tokens: every mode's captured greedy tokens (the serving phase's
       ``generate`` calls, and Yi-9B's ``generate_many``) identical to an
       engine that runs the same bodies eagerly; at temperature
       ``GRAPH_TEMP``, captured ``step`` and ``chunk`` identical to eager.
    2. Decode ms per step, eager body against the captured step graph and
       the captured chunk graph (per token), alternated, CUDA events over
       ``GRAPH_STEPS`` steps a pass; the device busy share of each
       (``torch.profiler``); capture seconds, the graphs' pool bytes and
       their nodes (read from libcuda); the bytes a step must move
       (every weight it reads once, in the dtype the engine adopted it
       in, the cache once) over 3.35 TB/s."""
    import numpy as np
    import torch
    from repro_torch.core import graphs
    from repro_torch.models import init_cache, prefill
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.engine import build_sampling_step

    dev = torch.device("cuda")
    cfg, model, prompts, st = (served["cfg"], served["model"],
                               served["prompts"], served["static"])
    extra = served.get("extra") or None
    print(f"== graphs: {cfg.name} decode, captured vs eager", flush=True)
    out = report.setdefault("graphs_decode", {})[cfg.name] = {}

    def engine(**kw):
        return ServeEngine(cfg, model, ServeConfig(**dict(dict(
            batch=st["batch"], max_len=served["max_len"],
            decode_chunk=st["decode_chunk"]), **kw)))

    eng = engine()
    eng.graphs = eager_programs(eng.device)
    eager = eng.generate(prompts, st["new_tokens"], extra)
    for mode, toks in served["outs"].items():
        check(np.array_equal(toks, eager),
              f"graphs {cfg.name}: captured {mode} tokens differ from the "
              f"eager body's")
    if "many" in served:
        reqs, arrivals, many = served["many"]
        eng = engine(batch=SERVE_MANY["batch"], max_len=SERVE_MANY["max_len"])
        eng.graphs = eager_programs(eng.device)
        many_eager = eng.generate_many(reqs, arrival_steps=arrivals)
        check(all(np.array_equal(a, b) for a, b in zip(many, many_eager)),
              f"graphs {cfg.name}: captured generate_many tokens differ "
              f"from the eager ragged step's")
    temp = {}
    for mode, captured in (("step", True), ("step", False),
                           ("chunk", True)):
        eng = engine(decode_mode=mode, temperature=GRAPH_TEMP["temperature"],
                     seed=GRAPH_TEMP["seed"])
        if not captured:
            eng.graphs = eager_programs(eng.device)
        temp[(mode, captured)] = eng.generate(
            prompts, GRAPH_TEMP["new_tokens"], extra)
    check(all(np.array_equal(t, temp[("step", False)])
              for t in temp.values()),
          f"graphs {cfg.name}: seeded draws differ between captured and "
          f"eager at temperature {GRAPH_TEMP['temperature']}")
    del eng
    print(f"  tokens: {sorted(served['outs'])} captured == eager body"
          + (", generate_many captured == eager" if "many" in served
             else "") + f"; temperature {GRAPH_TEMP['temperature']} "
          f"captured step/chunk == eager", flush=True)

    # -- decode ms: eager body, captured step, captured chunk -------------
    b, c, n = st["batch"], st["decode_chunk"], GRAPH_STEPS
    # the prompts (and the vision stub's prefix) and every step timed below
    max_len = (served["max_len"] - st["new_tokens"] - 1) + 8 * n + 16
    toks = torch.as_tensor(prompts).to(dev)
    step_eng = engine(max_len=max_len)
    step_eng.generate(prompts, 2, extra)         # captures the step graph
    chunk_eng = engine(max_len=max_len, decode_mode="chunk")
    chunk_eng.generate(prompts, c + 1, extra)    # captures the chunk graph
    g_step = step_eng.graphs.get(("step", b, max_len, 1, 0.0))
    g_chunk = chunk_eng.graphs.get(("chunk", b, max_len, c, 0.0))
    batch = dict({k: torch.as_tensor(v).to(dev)
                  for k, v in (extra or {}).items()}, tokens=toks)
    _, cache = prefill(model, cfg, batch, max_len)
    step = build_sampling_step(model, cfg, 0.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    tok = toks[:, -1:]

    def eager_step():
        nonlocal tok, cache
        tok, cache = step(cache, tok, gen)

    def per_step(fn, calls, steps):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (calls * steps)

    sides = {"eager": (eager_step, n, 1), "step graph": (g_step, n, 1),
             "chunk graph": (g_chunk, n // c, c)}
    runs = {k: [] for k in sides}
    for k in ("eager", "step graph", "chunk graph", "chunk graph",
              "step graph", "eager"):
        fn, calls, steps = sides[k]
        runs[k].append(per_step(fn, calls, steps))
    ms = {k: statistics.mean(v) for k, v in runs.items()}
    busy = {"eager": device_busy(eager_step, 3),
            "step graph": device_busy(g_step, 3),
            "chunk graph": device_busy(g_chunk, 1)}
    census = {"step graph": graphs.census(g_step),
              "chunk graph": graphs.census(g_chunk)}
    cache_bytes = sum(t.numel() * t.element_size() for t in init_cache(
        cfg, b, max_len, device="meta").values())
    # every weight a step reads, once, as the engines adopted it (the
    # narrowed leaves in bf16): all but the embedding table's unread rows
    # (a tied table is the head, read whole)
    adopted = sum(p.numel() * p.element_size() for p in model.parameters())
    unread = (0 if cfg.tie_embeddings else
              (cfg.vocab_size - b) * cfg.d_model * model.embed.element_size())
    read_bytes = adopted - unread + cache_bytes
    bound_ms = read_bytes / HBM_BYTES_PER_S * 1e3
    out.update({"tokens_equal": True, "decode_ms_per_step": ms,
                "runs_ms": runs, "busy": busy, "census": census,
                "capture_s": {"step graph": g_step.capture_s,
                              "chunk graph": g_chunk.capture_s},
                "pool_bytes": {"step graph": g_step.pool_bytes,
                               "chunk graph": g_chunk.pool_bytes},
                "bound_ms": bound_ms, "read_bytes": read_bytes,
                "max_len": max_len, "param_bytes": served["param_bytes"],
                "adopted_bytes": adopted, "cache_bytes": cache_bytes})
    for k in sides:
        bz = busy[k]
        print(f"  decode {k:11s}: {ms[k]:.3f} ms per step (passes "
              f"{', '.join(f'{v:.3f}' for v in runs[k])}); busy share "
              f"{bz['busy_share']:.3f}, {bz['launches']} device ops a "
              f"call", flush=True)
        print("    top device ops: " + "; ".join(
            f"{name[:48]} {us:.1f} us x{c}" for name, us, c in bz["top"]),
            flush=True)
    for k in ("step graph", "chunk graph"):
        g = g_step if k == "step graph" else g_chunk
        print(f"  {k}: capture {g.capture_s:.3f} s, pool {g.pool_bytes} B, "
              f"nodes {census[k]}", flush=True)
    print(f"  a step must move {read_bytes} B (every weight it reads once, "
          f"as adopted: {adopted} B of the {served['param_bytes']} B drawn; "
          f"the cache once): {bound_ms:.3f} ms at 3.35 TB/s; the captured "
          f"step at {bound_ms / ms['step graph']:.3f} of this bound",
          flush=True)
    del cache, batch, step_eng, chunk_eng, g_step, g_chunk
    torch.cuda.empty_cache()


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

    replayed = {}          # kernel launches made by graph replays
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
                    # the resident dispatches replay the plan's graph
                    g = rt._graphs.get(plan.build_key)
                    check(g is not None and g.replays == 4,
                          f"{tag}: resident dispatches replayed "
                          f"{None if g is None else g.replays} times, not 4")
                    for k, v in g.launches.items():
                        replayed[k] = replayed.get(k, 0) + v * g.replays
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

    # -- 3b'. the resident dispatch as captured graphs, against eager ------
    graphs_offload_phase(check, report)
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
    mla_row = mla_phase(check, report, time_ms)
    torch.cuda.empty_cache()
    decode_row = decode_phase(check, report, time_ms)
    torch.cuda.empty_cache()
    served = serving_phase(check, report)
    serve_launches = served["launches"]
    tenant_phase(check, report, served)
    graphs_phase(check, report, served)
    del served

    # -- 6-7. the SSM scan, then serving falcon-mamba ----------------------
    torch.cuda.empty_cache()
    scan_row = scan_phase(check, report, time_ms)
    torch.cuda.empty_cache()
    ssm_served = ssm_serving_phase(check, report)
    ssm_launches = ssm_served["launches"]
    graphs_phase(check, report, ssm_served)
    del ssm_served
    torch.cuda.empty_cache()

    # -- 8. serving zamba2 (the hybrid: both model kernels) ----------------
    hybrid_served = hybrid_serving_phase(check, report)
    hybrid_launches = hybrid_served["launches"]
    graphs_phase(check, report, hybrid_served)
    del hybrid_served
    torch.cuda.empty_cache()

    # -- 9. the MoE family: deepseek-v2-lite (MLA: no kernel under "auto",
    #       the MLA kernel under "chunked"), then the reduced llama4 (GQA:
    #       the flash kernel) ------------------------------------------------
    moe_launches = moe_serving_phase(check, report)
    torch.cuda.empty_cache()

    # -- 10. the modality frontends: paligemma-3b (the vision prefix, plain
    #        attention), then musicgen-large (the flash kernel at head dim 64)
    frontend_launches = frontend_serving_phase(check, report)
    torch.cuda.empty_cache()

    # -- 11. training smollm-360m (the plain paths under autograd), then its
    #        trained weights through the flash kernel -----------------------
    train_launches = train_phase(check, report)
    torch.cuda.empty_cache()

    # -- 12. the launch layer: the train CLI at full width (run, resume, the
    #        same bits), the dry-run and report CLIs, the H100 roofline
    #        against the card (the prefill through the flash kernel) -------
    launch_launches = launch_phase(check, report)
    torch.cuda.empty_cache()

    # -- 13. the chunked attention's per-chunk remat at 4 x 4096, off and on
    chunk_remat_phase(check, report)
    torch.cuda.empty_cache()

    # -- 14. the walkthroughs, each a process of its own -------------------
    examples_phase(check, report)

    # -- 15. what the main paths launched, and the result lines --------------
    launches["flash_attention"] = (serve_launches["flash_attention"]
                                   + hybrid_launches["flash_attention"]
                                   + moe_launches["flash_attention"]
                                   + frontend_launches["flash_attention"]
                                   + train_launches["flash_attention"]
                                   + launch_launches["flash_attention"])
    launches["ssm_scan"] = (ssm_launches["ssm_scan"]
                            + hybrid_launches["ssm_scan"])
    launches["decode_attention"] = sum(
        counts["decode_attention"] for counts in (
            serve_launches, hybrid_launches, moe_launches, frontend_launches))
    launches["mla_attention"] = moe_launches["mla_attention"]
    print("kernels: " + " ".join(f"{k}={v}" for k, v in launches.items())
          + "; of these, by graph replays: "
          + " ".join(f"{k}={v}" for k, v in replayed.items()))
    for name in KERNEL_JOBS + MODEL_KERNELS:
        check(launches[name] > 0,
              f"its main path never launched the {name} kernel")
    for name in KERNEL_JOBS:
        check(replayed.get(name, 0) > 0,
              f"no graph replay launched the {name} kernel")
    line = []
    rows = dict(main_rows, flash_attention=flash_row, ssm_scan=scan_row,
                decode_attention=decode_row, mla_attention=mla_row)
    for name in KERNEL_JOBS + MODEL_KERNELS:
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
    report["replayed_launches"] = replayed
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
