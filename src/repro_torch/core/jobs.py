"""The paper's six benchmark kernels (§5.1) as offloadable jobs.

Each kernel carries two coupled descriptions:

* a :class:`~repro_torch.core.simulator.JobSpec` — the phase-level profile consumed
  by the cycle-accurate simulator and the analytical model (transfer sizes,
  compute cycles, level structure).  The AXPY/ATAX profiles are anchored to
  the paper's measured coefficients (1.47 cycles/element for AXPY; the
  eq.-6 terms for ATAX).
* a real PyTorch computation at fp64 — used by
  :mod:`repro_torch.core.offload` to run the job on the logical clusters of
  one device (baseline vs multicast), and cross-checked against a pure
  reference.  Phase F of AXPY, Matmul, ATAX and Covariance goes through
  :mod:`repro_torch.kernels.ops`: the hand-written kernels on the card, their
  plain versions on the CPU.  Monte Carlo and BFS stay plain torch ops.

``compute`` takes cluster-major operands: every operand carries the same
leading batch axes (clusters, then fused jobs) before its per-cluster
shard, and the result carries them too.  ``make_instance`` is the
reference's numpy code, so both packages see bit-identical inputs.

Kernel/job mapping onto clusters (consistent between both views):

  AXPY        x, y row-chunks per cluster; embarrassingly parallel (Amdahl
              class, §5.3).
  MonteCarlo  no operands, per-cluster RNG streams, scalar writeback (Amdahl).
  Matmul      A row-chunk + full B per cluster (B is re-read by every cluster
              through the single SPM port).  The benchmarked sizes are small —
              the paper's fine-grained regime — so E stays short (Amdahl).
  ATAX        full A and x per cluster (the paper's eq. 6 broadcast term
              N(1+M)/8 · n), duplicated A·x pass, y chunk per cluster
              (broadcast class).
  Covariance  full data matrix per cluster, cov row-chunk per cluster
              (broadcast class).
  BFS         full graph per cluster, frontier chunk per cluster, level-
              synchronous with a global software barrier per level
              (broadcast class).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.simulator import JobSpec
from repro_torch.kernels import ops

DTYPE = torch.float64  # the paper's workloads are double precision

# Measured per-element execution coefficients (cycles per element per 8-core
# cluster-group, §5.5 F and reconstructions for the remaining kernels).
AXPY_CYC_PER_ELEM = 1.47          # paper §5.5 F (measured)
MC_CYC_PER_SAMPLE = 25.0          # software LCG + FP compare + accumulate
MM_CYC_PER_MAC = 1.1              # FREP FMA pipeline, near 1 MAC/cycle/core
ATAX_DUP_COEFF = 3.98             # eq. 6: duplicated A·x term (per N·M)
ATAX_PAR_COEFF = 1.9              # eq. 6: 2.9·N/(8n) minus the G term N/(8n)
COV_CYC_PER_MAC = 1.2
BFS_CYC_PER_EDGE = 8.0


def _chunks(total: int, n: int, i: int) -> int:
    """Row-balanced chunk size of cluster i when splitting `total` over n."""
    base, rem = divmod(total, n)
    return base + (1 if i < rem else 0)


@dataclasses.dataclass
class PaperJob:
    """A benchmark kernel: simulator spec + real PyTorch computation."""

    spec: JobSpec
    #: builds (operands, expected) given a seed — host-side, pure numpy
    make_instance: Callable[[int], Tuple[Dict[str, np.ndarray], np.ndarray]]
    #: per-cluster computation over cluster-major operands (leading batch
    #: axes, then each cluster's shard per `shard_axes`)
    compute: Callable[..., torch.Tensor]
    #: operand name -> axis to shard over clusters (None = replicate/broadcast)
    shard_axes: Dict[str, int | None]
    #: output axis sharded over clusters (None = reduced or replicated)
    out_axis: int | None
    #: cross-cluster combination when out_axis is None:
    #:   "sum"  — psum of per-cluster partials (ATAX)
    #:   "mean" — psum / n (Monte Carlo per-shard estimates)
    #:   None   — computed redundantly on every cluster (broadcast class)
    reduce: str | None = None
    #: for a compute whose loop runs until its data says stop (BFS: until
    #: the frontier is empty, one host read a level), the number of
    #: iterations it runs on these operands; ``compute(*ops, trips=k)``
    #: then runs k of them and reads nothing on the host — the program a
    #: CUDA graph captures for operands that stay resident
    loop_trips: Callable[..., int] | None = None


# ----------------------------------------------------------------------------
# AXPY — BLAS-1: z = alpha * x + y
# ----------------------------------------------------------------------------


def axpy_spec(N: int) -> JobSpec:
    return JobSpec(
        name=f"axpy[N={N}]",
        arg_words=5,  # N, alpha, x_ptr, y_ptr, z_ptr
        operand_transfers=lambda n, i: [8 * _chunks(N, n, i)] * 2,  # x, y chunks
        compute_cycles=lambda n, i: AXPY_CYC_PER_ELEM * _chunks(N, n, i) / 8.0,
        writeback_transfers=lambda n, i: [8 * _chunks(N, n, i)],
    )


def make_axpy(N: int = 1024) -> PaperJob:
    def make_instance(seed: int):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal(N)
        y = rng.standard_normal(N)
        alpha = 2.5
        return {"x": x, "y": y}, alpha * x + y

    def compute(x, y):
        return ops.axpy(x, y, 2.5)

    return PaperJob(
        spec=axpy_spec(N),
        make_instance=make_instance,
        compute=compute,
        shard_axes={"x": 0, "y": 0},
        out_axis=0,
    )


# ----------------------------------------------------------------------------
# Monte Carlo — pi estimation by rejection sampling
# ----------------------------------------------------------------------------


def montecarlo_spec(N: int) -> JobSpec:
    return JobSpec(
        name=f"montecarlo[N={N}]",
        arg_words=3,  # N, seed, result_ptr
        operand_transfers=lambda n, i: [],
        compute_cycles=lambda n, i: MC_CYC_PER_SAMPLE * _chunks(N, n, i) / 8.0,
        writeback_transfers=lambda n, i: [8],
    )


def make_montecarlo(N: int = 16384) -> PaperJob:
    def make_instance(seed: int):
        # The operand is just the per-sample uniform draws (precomputed so the
        # reference is exact); the device job counts hits in the unit circle.
        rng = np.random.default_rng(seed)
        pts = rng.random((N, 2))
        hits = float(((pts**2).sum(axis=1) <= 1.0).sum())
        return {"pts": pts}, np.asarray(4.0 * hits / N)

    def compute(pts):
        # pts: (..., local samples, 2); the estimate divides by the *local*
        # shard length, and the runtime averages the clusters' estimates
        hits = ((pts**2).sum(dim=-1) <= 1.0).sum(dim=-1)
        return 4.0 * hits.to(DTYPE) / pts.shape[-2] * 1.0

    return PaperJob(
        spec=montecarlo_spec(N),
        make_instance=make_instance,
        compute=compute,
        shard_axes={"pts": 0},
        out_axis=None,
        reduce="mean",
    )


# ----------------------------------------------------------------------------
# Matmul — BLAS-3: C[M,N] = A[M,K] @ B[K,N], A row-split, B broadcast
# ----------------------------------------------------------------------------


def matmul_spec(M: int, K: int, N: int) -> JobSpec:
    return JobSpec(
        name=f"matmul[{M}x{K}x{N}]",
        arg_words=6,  # M, K, N, a_ptr, b_ptr, c_ptr
        operand_transfers=lambda n, i: [8 * _chunks(M, n, i) * K, 8 * K * N],
        compute_cycles=lambda n, i: MM_CYC_PER_MAC * _chunks(M, n, i) * K * N / 8.0,
        writeback_transfers=lambda n, i: [8 * _chunks(M, n, i) * N],
    )


def make_matmul(M: int = 16, K: int = 16, N: int = 16) -> PaperJob:
    def make_instance(seed: int):
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((M, K))
        B = rng.standard_normal((K, N))
        return {"A": A, "B": B}, A @ B

    def compute(A, B):
        return ops.matmul(A, B)

    return PaperJob(
        spec=matmul_spec(M, K, N),
        make_instance=make_instance,
        compute=compute,
        shard_axes={"A": 0, "B": None},
        out_axis=0,
    )


# ----------------------------------------------------------------------------
# ATAX — PolyBench: y = A^T (A x)
# ----------------------------------------------------------------------------


def atax_spec(M: int, N: int) -> JobSpec:
    # Paper mapping (eq. 6): every cluster retrieves the full A (M×N) and x
    # (the broadcast term N(1+M)/8 · n: the single SPM port serializes n full
    # copies), duplicates the A·x pass (the n-independent 3.98·N·M term), and
    # computes an N/n chunk of y (the 1.9·N/(8n) part of the 2.9·N/(8n) term;
    # the remaining N/(8n) is the phase-G writeback of the y chunk).
    return JobSpec(
        name=f"atax[{M}x{N}]",
        arg_words=6,  # M, N, A_ptr, x_ptr, y_ptr, tmp_ptr
        operand_transfers=lambda n, i: [8 * M * N, 8 * N],
        compute_cycles=lambda n, i: (
            ATAX_DUP_COEFF * N * M + ATAX_PAR_COEFF * _chunks(N, n, i) / 8.0
        ),
        writeback_transfers=lambda n, i: [8 * _chunks(N, n, i)],
    )


def make_atax(M: int = 64, N: int = 64) -> PaperJob:
    def make_instance(seed: int):
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((M, N))
        x = rng.standard_normal(N)
        return {"A": A, "x": x}, A.T @ (A @ x)

    def compute(A, x):
        return ops.atax(A, x)

    return PaperJob(
        spec=atax_spec(M, N),
        make_instance=make_instance,
        compute=compute,
        # Runtime mapping: shard A rows, psum the partial A_i^T (A_i x).
        shard_axes={"A": 0, "x": None},
        out_axis=None,
        reduce="sum",
    )


# ----------------------------------------------------------------------------
# Covariance — PolyBench: cov(M×M) of an M×N data matrix
# ----------------------------------------------------------------------------


def covariance_spec(M: int, N: int) -> JobSpec:
    return JobSpec(
        name=f"covariance[{M}x{N}]",
        arg_words=5,
        operand_transfers=lambda n, i: [8 * M * N],
        compute_cycles=lambda n, i: (
            COV_CYC_PER_MAC * (_chunks(M, n, i) * M * N + M * N) / 8.0
        ),
        writeback_transfers=lambda n, i: [8 * _chunks(M, n, i) * M],
    )


def make_covariance(M: int = 32, N: int = 64) -> PaperJob:
    def make_instance(seed: int):
        rng = np.random.default_rng(seed)
        data = rng.standard_normal((M, N))
        centred = data - data.mean(axis=1, keepdims=True)
        return {"data": data}, centred @ centred.T / (N - 1)

    def compute(data):
        return ops.covariance(data)

    return PaperJob(
        spec=covariance_spec(M, N),
        make_instance=make_instance,
        compute=compute,
        shard_axes={"data": None},  # broadcast class: full data everywhere
        out_axis=None,  # computed redundantly on every cluster
    )


# ----------------------------------------------------------------------------
# BFS — Graph500-style level-synchronous traversal (dense adjacency)
# ----------------------------------------------------------------------------


def bfs_spec(V: int, avg_degree: int = 4, levels: int = 6) -> JobSpec:
    E_g = V * avg_degree
    return JobSpec(
        name=f"bfs[V={V}]",
        arg_words=5,
        operand_transfers=lambda n, i: [8 * (V + E_g)],  # CSR broadcast
        compute_cycles=lambda n, i: BFS_CYC_PER_EDGE * (E_g / n) / 8.0,
        writeback_transfers=lambda n, i: [8 * _chunks(V, n, i)],
        levels=levels,
    )


def make_bfs(V: int = 256, seed_graph: int = 0) -> PaperJob:
    rng = np.random.default_rng(seed_graph)
    adj = np.zeros((V, V), dtype=bool)
    # Random sparse graph, symmetric, guaranteed-connected via a ring.
    for v in range(V):
        adj[v, (v + 1) % V] = True
    extra = rng.integers(0, V, size=(3 * V, 2))
    adj[extra[:, 0], extra[:, 1]] = True
    adj |= adj.T
    np.fill_diagonal(adj, False)

    def reference_distances() -> np.ndarray:
        dist = np.full(V, -1, dtype=np.int64)
        dist[0] = 0
        frontier = {0}
        d = 0
        while frontier:
            d += 1
            nxt = set()
            for u in frontier:
                for v in np.nonzero(adj[u])[0]:
                    if dist[v] < 0:
                        dist[v] = d
                        nxt.add(v)
            frontier = nxt
        return dist

    def make_instance(seed: int):
        return {"adj": adj.astype(np.float64)}, reference_distances().astype(np.float64)

    def levels(adj_f, trips=None):
        # The reference's lax.while_loop as a Python loop over levels: the
        # loop condition is one host sync per level.  Batched (clusters x
        # fused jobs) instances run until every frontier is empty; a
        # finished instance's empty frontier reaches nothing, so its
        # distances stay put, as under the reference's vmap.  With
        # ``trips`` the loop runs that many levels and reads nothing on
        # the host (the levels after the last non-empty frontier change
        # nothing).  -> (distances, levels run)
        lead = adj_f.shape[:-2]
        V_ = adj_f.shape[-1]
        dist = torch.full(lead + (V_,), -1.0, dtype=DTYPE, device=adj_f.device)
        dist[..., 0] = 0.0
        frontier = torch.zeros_like(dist)
        frontier[..., 0] = 1.0
        adj_t = adj_f.mT
        d = 0
        while (d < trips if trips is not None
               else bool(frontier.sum() > 0)):
            reach = torch.matmul(adj_t, frontier.unsqueeze(-1)).squeeze(-1) > 0
            newly = reach & (dist < 0)
            dist = torch.where(newly, d + 1.0, dist)
            frontier = newly.to(DTYPE)
            d += 1
        return dist, d

    def compute(adj_f, trips=None):
        return levels(adj_f, trips)[0]

    return PaperJob(
        spec=bfs_spec(V),
        make_instance=make_instance,
        compute=compute,
        shard_axes={"adj": None},
        out_axis=None,  # computed redundantly; runtime keeps one copy
        loop_trips=lambda adj_f: levels(adj_f)[1],
    )


# ----------------------------------------------------------------------------
# Fused-batch helpers (offload_fused / OffloadStream)
# ----------------------------------------------------------------------------


def make_instances(job: PaperJob, batch: int, seed0: int = 0
                   ) -> Tuple[List[Dict[str, np.ndarray]], List[np.ndarray]]:
    """B independent instances of ``job`` -> (operand dicts, expected)."""
    pairs = [job.make_instance(seed0 + i) for i in range(batch)]
    return [ops for ops, _ in pairs], [exp for _, exp in pairs]


def stack_instances(instances: Sequence[Dict[str, np.ndarray]]
                    ) -> Dict[str, np.ndarray]:
    """Stack B operand dicts along a new leading batch axis.

    All instances must share operand names/shapes/dtypes — they are B
    draws of the *same* job, which is what makes one fused launch valid.
    """
    if not instances:
        raise ValueError("stack_instances needs at least one instance")
    names = sorted(instances[0])
    for i, inst in enumerate(instances):
        if sorted(inst) != names:
            raise ValueError(
                f"instance {i} operand names {sorted(inst)} != {names}")
    return {name: np.stack([np.asarray(inst[name]) for inst in instances])
            for name in names}


#: Registry used by benchmarks and tests.
PAPER_JOBS: Dict[str, Callable[..., PaperJob]] = {
    "axpy": make_axpy,
    "montecarlo": make_montecarlo,
    "matmul": make_matmul,
    "atax": make_atax,
    "covariance": make_covariance,
    "bfs": make_bfs,
}
