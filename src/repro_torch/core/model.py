"""Analytical offload-runtime model — paper §5.6, equations 1–6.

The paper models the runtime of a job offloaded (with the multicast + job
completion unit extensions) onto ``n`` clusters as the sum over phases of the
per-phase maximum across clusters (eq. 4):

    t̂(n) = Σ_{p ∈ [A, I]} max_{i ∈ [0, n)} t_p(n, N, i)

We build the model *structurally* from the machine parameters and the job's
phase description (the same :class:`~repro_torch.core.simulator.JobSpec` the
simulator consumes), exactly as the paper composes its closed forms:

  phase A,B,C,D,H,I — constants from :class:`~repro_torch.core.params.OccamyParams`
  phase E — eq. 1: t_setup + t_latency + total_bytes / bw   (port drain: with
            multicast all clusters start together and the single SPM port
            serializes every transfer)
  phase F — eq. 2: t_init + max_i compute(n, i)
  phase G — eq. 3: t_setup + t_latency + max_i wb_bytes(i) / bw  (the phase-E
            skew separates the writebacks, so each is a lone transfer)

For the AXPY job this reduces *exactly* to eq. 5,
``t̂(n) = 400 + N/4 + 2.47·N/(8n)`` (asserted in tests/test_model.py), and for
ATAX to the eq.-6 form ``C + a·N·M + b·N/n + N(1+M)/8 · n``.

The model answers the paper's offload decision (§1): `optimal_clusters`
returns the analytically best number of clusters for a job instance, and
`should_offload` compares against a host-only execution estimate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.core.params import DEFAULT_PARAMS, OccamyParams
from repro_torch.core.phases import Phase
from repro_torch.core.simulator import JobSpec, intra_barrier, simulate


@dataclasses.dataclass
class ModelBreakdown:
    """Per-phase contributions of the analytical model (cycles)."""

    terms: Dict[Phase, float]

    @property
    def total(self) -> float:
        return sum(self.terms.values())


def offload_constant(p: OccamyParams, arg_words: int) -> Dict[Phase, float]:
    """The job-independent phases A, B, C, D, H, I (§5.6) for the extensions."""
    return {
        Phase.A: p.host_info_base + p.host_info_per_word * (1 + arg_words),
        Phase.B: p.host_store_first + p.noc_propagation,
        Phase.C: p.narrow_local,
        Phase.D: 0.0,
        Phase.H: (
            p.phase_sync
            + p.unit_arrival_code
            + p.clint_travel
            + p.unit_fire
            + p.noc_propagation
        ),
        Phase.I: p.host_resume,
    }


def predict(job: JobSpec, n: int, p: OccamyParams = DEFAULT_PARAMS) -> ModelBreakdown:
    """Eq. 4: per-phase max composition for the multicast implementation."""
    terms = dict(offload_constant(p, job.arg_words))

    # Phase E (eq. 1): simultaneous starts -> the single port drains the
    # total traffic; the last-granted cluster sees the full drain.  Refinement
    # over the paper's closed form: each granted transfer occupies at least
    # one beat of the 512-bit port (sub-beat bursts cannot pack), which
    # matters only in the extreme fine-grained corner (chunk < 64 B); for the
    # paper's sizes the two coincide and eq. 5 is recovered exactly.
    op_sizes = [list(job.operand_transfers(n, i)) for i in range(n)]
    drain = sum(
        max(1.0, b / p.wide_bw_bytes_per_cycle) for s in op_sizes for b in s
    )
    max_transfers = max((len(s) for s in op_sizes), default=0)
    if drain > 0:
        terms[Phase.E] = p.dma_setup(max_transfers) + p.dma_latency + drain
    else:
        terms[Phase.E] = 0.0

    # Phase F (eq. 2): init + slowest cluster (+ level barriers for BFS-like
    # jobs).
    max_compute = max(job.compute_cycles(n, i) for i in range(n))
    terms[Phase.F] = p.f_init + max_compute
    if job.levels > 1:
        terms[Phase.F] += (job.levels - 1) * intra_barrier(n, p)

    # Phase G (eq. 3): writebacks are skew-separated -> single-transfer cost
    # (same ≥1-beat refinement as phase E).
    wb_sizes = [list(job.writeback_transfers(n, i)) for i in range(n)]
    max_wb = max(
        (sum(max(1.0, b / p.wide_bw_bytes_per_cycle) for b in s) for s in wb_sizes),
        default=0.0,
    )
    wb_transfers = max((len(s) for s in wb_sizes), default=0)
    if max_wb > 0:
        terms[Phase.G] = p.dma_setup(wb_transfers) + p.dma_latency + max_wb
    else:
        terms[Phase.G] = 0.0
    return ModelBreakdown(terms)


def predict_total(job: JobSpec, n: int, p: OccamyParams = DEFAULT_PARAMS) -> float:
    return predict(job, n, p).total


# --- Closed forms (paper eqs. 5 and 6) -----------------------------------------


def axpy_closed_form(n: int, N: int) -> float:
    """Eq. 5 verbatim: t̂(n) = 400 + N/4 + 2.47·N/(8·n)."""
    return 400.0 + N / 4.0 + 2.47 * N / (8.0 * n)


def atax_closed_form_paper(n: int, N: int, M: int) -> float:
    """Eq. 6 verbatim: t̂(n) = 566 + 3.98·N·M + 2.9·N/(8n) + N(1+M)/8 · n."""
    return 566.0 + 3.98 * N * M + 2.9 * N / (8.0 * n) + N * (1.0 + M) / 8.0 * n


# --- Model v2 (beyond the paper): port-saturation lower bound -------------------


def port_bound(job: JobSpec, n: int, p: OccamyParams = DEFAULT_PARAMS) -> float:
    """Work-conserving bound on the wide port: when the job is DMA-bound the
    single SPM port serves E and G traffic back-to-back, and the runtime is
    pinned by the total drain regardless of n.  The paper's eq.-4 composition
    assumes phase G is skew-separated (eq. 3), which breaks exactly in this
    regime (§5.5 G documents the E/G coupling qualitatively).
    """
    start = sum(
        offload_constant(p, job.arg_words)[ph] for ph in (Phase.A, Phase.B, Phase.C, Phase.D)
    )
    op_sizes = [list(job.operand_transfers(n, i)) for i in range(n)]
    wb_sizes = [list(job.writeback_transfers(n, i)) for i in range(n)]
    drain = sum(max(1.0, b / p.wide_bw_bytes_per_cycle) for s in op_sizes for b in s)
    drain += sum(max(1.0, b / p.wide_bw_bytes_per_cycle) for s in wb_sizes for b in s)
    max_transfers = max((len(s) for s in op_sizes), default=0)
    tail = dict(offload_constant(p, job.arg_words))
    return (
        start
        + p.dma_setup(max_transfers)
        + drain
        + p.dma_latency
        + p.phase_sync
        + tail[Phase.H]
        + tail[Phase.I]
    )


def predict_total_v2(job: JobSpec, n: int, p: OccamyParams = DEFAULT_PARAMS) -> float:
    """max(eq-4 composition, port drain bound) — beyond-paper refinement that
    stays accurate into the DMA-saturated regime (EXPERIMENTS.md §Model-v2)."""
    return max(predict_total(job, n, p), port_bound(job, n, p))


# --- Validation against the simulator (fig. 12) --------------------------------


@dataclasses.dataclass
class ValidationPoint:
    n: int
    size: Tuple[int, ...]
    simulated: float
    predicted: float

    @property
    def rel_error(self) -> float:
        return abs(self.simulated - self.predicted) / self.simulated


def validate(
    make_job: Callable[..., JobSpec],
    sizes: Sequence[Tuple[int, ...]],
    ns: Sequence[int],
    p: OccamyParams = DEFAULT_PARAMS,
    predictor: Callable[[JobSpec, int, OccamyParams], float] = predict_total,
) -> List[ValidationPoint]:
    """Compare model predictions to simulated runtimes (the paper's fig. 12).

    The paper validates on the multicast implementation only (§5.6: the
    baseline's phase couplings make it much harder to model).
    """
    points = []
    for size in sizes:
        job = make_job(*size)
        for n in ns:
            sim = simulate(job, n, "multicast", p).total
            pred = predictor(job, n, p)
            points.append(ValidationPoint(n, tuple(size), sim, pred))
    return points


def max_rel_error(points: Sequence[ValidationPoint]) -> float:
    return max(pt.rel_error for pt in points)


# --- The offload decision (§1, §5.6) --------------------------------------------


def optimal_clusters(
    job_for_n: Callable[[], JobSpec],
    p: OccamyParams = DEFAULT_PARAMS,
    candidates: Sequence[int] = (1, 2, 4, 8, 16, 32),
) -> Tuple[int, float]:
    """Analytically best number of clusters — the paper's non-binary offload
    decision ("in addition to establishing *if* a job is suitable for offload,
    the question *how* to offload the job has to be answered as well")."""
    job = job_for_n()
    best_n, best_t = None, float("inf")
    for n in candidates:
        if n > p.num_clusters:
            continue
        t = predict_total(job, n, p)
        if t < best_t:
            best_n, best_t = n, t
    assert best_n is not None
    return best_n, best_t


def should_offload(job: JobSpec, host_cycles: float,
                   p: OccamyParams = DEFAULT_PARAMS) -> Tuple[bool, int, float]:
    """The binary offload decision: offload iff the modeled offloaded runtime
    (at the optimal cluster count) beats the host-only estimate."""
    n, t = optimal_clusters(lambda: job, p)
    return t < host_cycles, n, t
