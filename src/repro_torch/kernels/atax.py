"""ATAX on Hopper: y = Aᵀ (A x) (PolyBench, paper §5.1).

Launch wrapper of ``csrc/atax.cu``, which replaces the Pallas TPU kernel
``repro.kernels.atax``.  ``a`` is (..., M, N) and ``x`` (..., N) with the
same leading batch axes.  The kernel reads A once: a thread-block cluster
of ``cluster`` CTAs owns one (batch item, row group), each CTA one column
slice, and the CTAs exchange their partial A·x of every row panel through
distributed shared memory (the source note says how).  :func:`plan` picks
the launch from the shapes and the card's SM count (and, on the card, its
own count of the clusters it holds at once); with more than one row group
the wrapper also allocates the partial rows the second pass sums.
``plain`` is the PyTorch version of the same function.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Optional

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import atax as plain

__all__ = ["atax", "plain", "plan", "card_plan", "Plan"]

KERNEL = _b.KERNELS["atax"]
#: the kernel's limits (csrc/atax.cu): CTAs a cluster (the portable size),
#: threads a CTA, and the (rows a panel, stages) pairs in the order the plan
#: prefers them: bigger panels first (fewer exchanges), then deeper rings
MAX_CLUSTER = 8
MAX_THREADS = 512
SHAPES = ((8, 3), (8, 2), (4, 3), (4, 2), (2, 3), (2, 2))
#: 16-byte chunks of the slice a thread holds; csrc/atax.cu instantiates
#: rows x chunks <= 16
CHUNKS = (1, 2, 4)
MAX_ROWS_X_CHUNKS = 16
#: a cluster rank takes at least this many 16-byte chunks of a row
MIN_SLICE = 32
#: dynamic shared memory a CTA may take (227 KB less the static part)
SMEM_MAX = 220 * 1024
#: what a panel of R rows is worth against a full wave: every panel costs
#: one exchange of partials, so halving R doubles them.  Fitted to the
#: H100 sweep of ``launch_ab.py --kernel atax``: at the n = 32 shard 8 rows
#: in a 71 %-full wave took 0.053 ms, 4 rows in a 52 %-full one 0.064,
#: 2 rows in an 83 %-full one 0.069 device ms
ROW_WEIGHT = {8: 1.0, 4: 0.85, 2: 0.6}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of ``atax_cluster_kernel``: ``batch * groups`` clusters
    of ``cluster`` CTAs of ``threads`` threads."""

    cluster: int        # C: CTAs of a cluster, one column slice each
    rows: int           # R: rows of a panel
    stages: int         # ring stages of R-row panels in shared memory
    groups: int         # G: row groups of a batch item (clusters each)
    threads: int
    chunks: int         # 16-byte chunks of the slice a thread holds
    vec: int            # elements of a 16-byte chunk
    slice_chunks: int   # S: 16-byte chunks of a slice (the last is ragged)
    smem: int           # dynamic shared memory of the ring, bytes
    wave: int           # clusters of this shape the card holds at once

    def columns(self, rank: int, n: int) -> range:
        """The columns CTA ``rank`` owns (as csrc/atax.cu computes them)."""
        c0 = rank * self.slice_chunks * self.vec
        return range(min(c0, n), min(c0 + self.slice_chunks * self.vec, n))

    def panels(self, group: int, m: int) -> range:
        """The panels row group ``group`` walks, in order."""
        p = -(-m // self.rows)
        return range(group * p // self.groups, (group + 1) * p // self.groups)


def estimated_clusters(sms: int, cluster: int, smem: int, threads: int,
                       chunks: int) -> int:
    """Clusters the card holds at once, without asking it: CTAs an SM holds
    by shared memory (228 KB, ~2 KB more a CTA), threads and registers (64
    a thread, 128 with 4 chunks), and clusters of 8 placed inside GPCs of
    16-18 SMs, where a GPC leaves some SMs idle.  On the H100 this is
    ``cudaOccupancyMaxActiveClusters`` or one cluster below it."""
    regs = 128 if chunks == 4 else 64
    per_sm = max(1, min((228 * 1024) // (smem + 2048), 2048 // threads,
                        65536 // (regs * threads)))
    if cluster == 1:
        return sms * per_sm
    return max(1, per_sm * (sms - sms // 16) // cluster - 1)


def plan(batch: int, m: int, n: int, dtype: torch.dtype, sms: int,
         clusters: Optional[Callable[[int, int, int, int, int], int]] = None
         ) -> Plan:
    """The launch for ``batch`` (M, N) matrices of ``dtype`` on a card of
    ``sms`` SMs.

    The cluster takes up to 8 slices of at least ``MIN_SLICE`` chunks; a
    thread holds 1, 2 or 4 chunks of its slice.  Of the (rows, stages)
    pairs in ``SHAPES`` (rows not far past M, the ring within shared
    memory) it takes the one whose clusters fill the card's wave best,
    the fill weighted by ``ROW_WEIGHT`` (the first of equals).  A batch
    smaller than the wave is split into row groups until it fills one
    wave; a larger batch runs in waves.
    ``clusters(cluster, rows, stages, threads, chunks)`` says how many
    clusters of that shape the card holds at once; by default
    :func:`estimated_clusters`."""
    if batch < 1 or m < 1 or n < 1:
        raise ValueError(f"atax plan for batch {batch}, M {m}, N {n}")
    vec = 16 // dtype.itemsize
    nch = -(-n // vec)
    cluster = max(1, min(MAX_CLUSTER, nch // MIN_SLICE))
    s = -(-nch // cluster)
    chunks = next((c for c in CHUNKS if s <= 512 * c), CHUNKS[-1])
    threads = 32 * -(-s // (32 * chunks))
    if threads > MAX_THREADS:
        raise ValueError(
            f"atax kernel takes rows of at most "
            f"{MAX_CLUSTER * MAX_THREADS * CHUNKS[-1] * vec} {dtype} "
            f"elements, got N = {n}")
    cap = max(SHAPES[-1][0], 1 << (m - 1).bit_length())
    best = None
    for rows, stages in SHAPES:
        smem = stages * rows * s * 16
        if rows > cap or rows * chunks > MAX_ROWS_X_CHUNKS or smem > SMEM_MAX:
            continue
        wave = (clusters(cluster, rows, stages, threads, chunks) if clusters
                else estimated_clusters(sms, cluster, smem, threads, chunks))
        if wave < 1:
            continue
        panels = -(-m // rows)
        groups = 1 if batch >= wave else max(1, min(panels, wave // batch))
        total = batch * groups
        score = ROW_WEIGHT[rows] * total / (-(-total // wave) * wave)
        if best is None or score > best[0]:
            best = (score, Plan(cluster, rows, stages, groups, threads, chunks,
                               vec, s, smem, wave))
    if best is None:
        raise RuntimeError(f"no atax launch for N = {n} fits on the card")
    return best[1]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _card_clusters(index: int, dtype: torch.dtype, n: int, cluster: int,
                   rows: int, stages: int, threads: int, chunks: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        _b.check_rc(_b.entry("repro_atax_max_clusters")(
            _b.DTYPE_CODES[dtype], n, cluster, rows, stages, threads, chunks,
            ctypes.byref(out)), "atax")
    return out.value


@functools.lru_cache(maxsize=4096)
def card_plan(index: int, batch: int, m: int, n: int,
              dtype: torch.dtype) -> Plan:
    """:func:`plan` on CUDA device ``index``, with its SM count and its own
    count of the clusters it holds (``cudaOccupancyMaxActiveClusters``),
    each asked once."""
    return plan(batch, m, n, dtype, _sms(index),
                functools.partial(_card_clusters, index, dtype, n))


def atax(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    _b.refuse_grad("atax", a, x)
    if a.ndim < 2 or x.ndim != a.ndim - 1 or a.shape[:-2] != x.shape[:-1] \
            or a.shape[-1] != x.shape[-1]:
        raise ValueError(f"atax shapes {tuple(a.shape)}, {tuple(x.shape)}")
    code = _b.check_inputs("atax", a, x)
    m, n = a.shape[-2:]
    batch = math.prod(a.shape[:-2])
    y = torch.empty(x.shape, dtype=a.dtype, device=a.device)
    if y.numel() == 0:
        return y
    if m == 0:
        return y.zero_()
    p = card_plan(a.get_device(), batch, m, n, a.dtype)
    partial = (torch.empty((batch, p.groups, n), dtype=_b.acc_dtype(a.dtype),
                           device=a.device) if p.groups > 1 else None)
    _b.launch("atax", "repro_atax", a, code, a.data_ptr(), x.data_ptr(),
              0 if partial is None else partial.data_ptr(), y.data_ptr(),
              batch, m, n, p.cluster, p.rows,
              p.stages, p.groups, p.threads, p.chunks)
    KERNEL.launches += 1
    return y
