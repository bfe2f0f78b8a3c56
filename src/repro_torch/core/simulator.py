"""Cycle-accurate discrete-event simulator of the Occamy offload process.

This is the reproduction's stand-in for the paper's QuestaSim RTL measurements
(§5.1): a discrete-event model of the nine offload phases (fig. 3) over the
Occamy topology, parameterized by the paper's measured constants
(:mod:`repro_torch.core.params`).  It reproduces, mechanistically rather than by
curve-fitting:

* the O(n) baseline wakeup (sequential IPIs limited by CVA6's outstanding
  write budget) vs O(1) multicast wakeup (§5.5 B);
* the quadrant-step behaviour of job-pointer retrieval (§5.5 C);
* the single-read-port wide-SPM contention: DMA transfers are granted
  sequentially in arrival order and perfectly interleave, so the port is
  work-conserving (§5.5 E) — implemented as a FIFO server at 64 B/cycle;
* the second-order effect of dispatch skew: offload phases offset the
  clusters' phase-E start times, which *hides* SPM contention, so part of the
  offload overhead is recovered (§5.2) — this falls out of the FIFO model;
* phase E/G coupling: a cluster's writeback can stall behind another
  cluster's operand fetch (§5.5 G) — both phases share the wide port;
* the software central-counter barrier vs the job completion unit (§4.3).

Three execution modes:

* ``baseline``  — the unmodified system (sequential IPIs, phases C/D, software
  central-counter barrier);
* ``multicast`` — the paper's extensions (multicast job-info distribution and
  wakeup, phases C/D collapsed, job completion unit);
* ``ideal``     — the job as if it materialized on the accelerator at t=0 with
  no offload phases (the paper's "executed directly on the device"); used to
  compute the offload overhead t_base - t_ideal (§5.2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Union

from repro_torch.core import broadcast as bcast
from repro_torch.core.params import DEFAULT_PARAMS, OccamyParams
from repro_torch.core.phases import Phase, PhaseSpan, PhaseStats

Mode = str
MODES = ("baseline", "multicast", "ideal")


@dataclasses.dataclass
class JobSpec:
    """Phase-level description of an offloadable job (simulator view).

    ``operand_transfers(n, i)`` / ``writeback_transfers(n, i)`` return the DMA
    transfer sizes in bytes issued by cluster ``i`` when the job runs on ``n``
    clusters.  ``compute_cycles(n, i)`` is phase-F work excluding the
    ``f_init`` constant.  ``levels`` > 1 inserts software global barriers
    inside phase F (BFS's level-synchronous traversal).
    """

    name: str
    arg_words: int
    operand_transfers: "callable"
    compute_cycles: "callable"
    writeback_transfers: "callable"
    levels: int = 1


@dataclasses.dataclass
class SimResult:
    job: str
    mode: Mode
    n: int
    total: float                      # host-to-host cycles (device-only for ideal)
    spans: List[PhaseSpan]
    cluster_done: List[float]         # per-cluster end of phase G

    def phase_stats(self) -> Dict[Phase, PhaseStats]:
        per_phase: Dict[Phase, List[float]] = {}
        for s in self.spans:
            per_phase.setdefault(s.phase, []).append(s.duration)
        return {p: PhaseStats.of(p, d) for p, d in per_phase.items()}


# ---------------------------------------------------------------------------
# The wide interconnect / SPM port: a single work-conserving FIFO server.
# ---------------------------------------------------------------------------


class WidePort:
    """Single-ported wide SPM interface, 64 B/cycle, grant in arrival order.

    The paper (§5.5 E): "the wide SPM has a single read port, all clusters
    have to contend access to this resource, so the DMA transfers from every
    cluster will be granted sequentially [...] multiple short DMA transfers
    perfectly interleave, thus taking the same amount of time as a single DMA
    transfer of combined length at the SPM interface".
    """

    def __init__(self, bw: float):
        self.bw = bw
        self.free_at = 0.0

    def serve(self, eligible: float, nbytes: float) -> float:
        start = max(self.free_at, eligible)
        end = start + max(1.0, nbytes / self.bw)
        self.free_at = end
        return end


@dataclasses.dataclass
class _Chain:
    """A cluster's pending port requests: E transfers then G transfers."""

    cluster: int
    e_sizes: List[float]
    g_sizes: List[float]
    next_idx: int = 0
    stage: int = 0                    # 0 = E, 1 = G, 2 = done
    eligible: float = 0.0
    e_end: float = 0.0
    g_end: float = 0.0
    g_gap: Optional["callable"] = None  # e_end -> eligibility of first G transfer

    def done(self) -> bool:
        return self.stage == 2


def _run_port(port: WidePort, chains: List[_Chain], latency: float) -> None:
    """Serve every chain to completion in FIFO (arrival-order) fashion."""
    # Clusters with no E transfers resolve their stage boundary immediately.
    for c in chains:
        _advance_empty_stages(c, latency)
    while True:
        live = [c for c in chains if not c.done()]
        if not live:
            return
        # FIFO: earliest-eligible request first; ties broken by cluster index
        # (round-robin-ish fairness, deterministic).
        c = min(live, key=lambda ch: (ch.eligible, ch.cluster))
        sizes = c.e_sizes if c.stage == 0 else c.g_sizes
        end = port.serve(c.eligible, sizes[c.next_idx])
        c.next_idx += 1
        if c.next_idx < len(sizes):
            c.eligible = end          # descriptors are pre-programmed
            continue
        # Stage complete: the cluster observes completion after the round trip.
        if c.stage == 0:
            c.e_end = end + latency
            c.stage, c.next_idx = 1, 0
            c.eligible = c.g_gap(c.e_end) if c.g_gap else c.e_end
            _advance_empty_stages(c, latency)
        else:
            c.g_end = end + latency
            c.stage = 2


def _advance_empty_stages(c: _Chain, latency: float) -> None:
    if c.stage == 0 and not c.e_sizes:
        c.e_end = c.eligible
        c.stage = 1
        c.eligible = c.g_gap(c.e_end) if c.g_gap else c.e_end
    if c.stage == 1 and not c.g_sizes:
        c.g_end = c.eligible
        c.stage = 2


# ---------------------------------------------------------------------------
# The simulator proper.
# ---------------------------------------------------------------------------


def simulate(
    job: JobSpec,
    n: int,
    mode: Mode,
    params: OccamyParams = DEFAULT_PARAMS,
) -> SimResult:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    if not (1 <= n <= params.num_clusters):
        raise ValueError(f"n={n} outside [1, {params.num_clusters}]")
    p = params
    spans: List[PhaseSpan] = []

    # ----- Phase A: send job information (host) ------------------------------
    if mode == "ideal":
        a_end = 0.0
    else:
        a_dur = p.host_info_base + p.host_info_per_word * (1 + job.arg_words)
        spans.append(PhaseSpan(Phase.A, -1, 0.0, a_dur))
        a_end = a_dur

    # ----- Phase B: wakeup ----------------------------------------------------
    wake = [0.0] * n
    if mode == "baseline":
        # Sequential IPIs, descending cluster index so that cluster 0 (which
        # hosts the barrier counter) is woken last (§5.5 H).
        for k in range(n):
            i = n - 1 - k
            issue = a_end + p.host_store_first + k * p.host_store_next
            wake[i] = issue + p.noc_propagation
    elif mode == "multicast":
        w = a_end + p.host_store_first + p.noc_propagation
        wake = [w] * n
    for i in range(n):
        if mode != "ideal":
            spans.append(PhaseSpan(Phase.B, i, a_end, wake[i]))

    # ----- Phase C: retrieve job pointer ---------------------------------------
    c_end = list(wake)
    if mode == "baseline":
        for i in range(n):
            c_end[i] = wake[i] + p.narrow_latency(i, 0)
    elif mode == "multicast":
        # Job info already multicast into every TCDM: local load only.
        for i in range(n):
            c_end[i] = wake[i] + p.narrow_local
    for i in range(n):
        if mode != "ideal":
            spans.append(PhaseSpan(Phase.C, i, wake[i], c_end[i]))

    # ----- Phase D: retrieve job arguments -------------------------------------
    d_end = list(c_end)
    if mode == "baseline":
        # Remote clusters DMA the argument block out of cluster 0's TCDM.
        # Serialized at cluster 0's port (FIFO in arrival order).
        order = sorted(range(1, n), key=lambda i: c_end[i] + p.dma_args_setup)
        port_free = 0.0
        for i in order:
            eligible = c_end[i] + p.dma_args_setup
            start = max(port_free, eligible)
            serve_end = start + p.cluster0_port_occupancy
            port_free = serve_end
            d_end[i] = serve_end + p.dma_latency
        d_end[0] = c_end[0]
    for i in range(n):
        if mode != "ideal":
            spans.append(PhaseSpan(Phase.D, i, c_end[i], d_end[i]))

    # ----- Phases E, F, G: operands, compute, writeback -------------------------
    port = WidePort(p.wide_bw_bytes_per_cycle)
    e_starts = [0.0] * n if mode == "ideal" else d_end
    ops = [list(job.operand_transfers(n, i)) for i in range(n)]
    wbs = [list(job.writeback_transfers(n, i)) for i in range(n)]
    f_dur = [
        p.phase_sync + p.f_init + job.compute_cycles(n, i) + p.phase_sync
        for i in range(n)
    ]

    if job.levels <= 1:
        chains = []
        for i in range(n):
            gap = (lambda fd, k: (lambda e_end: e_end + fd + p.dma_setup(k)))(
                f_dur[i], len(wbs[i])
            )
            chains.append(
                _Chain(
                    cluster=i,
                    e_sizes=ops[i],
                    g_sizes=wbs[i],
                    eligible=e_starts[i] + p.dma_setup(len(ops[i])),
                    g_gap=gap,
                )
            )
        _run_port(port, chains, p.dma_latency)
        e_end = [c.e_end for c in chains]
        f_end = [e_end[i] + f_dur[i] for i in range(n)]
        g_end = [c.g_end for c in chains]
    else:
        # Level-synchronous jobs (BFS): complete phase E for all clusters,
        # run `levels` compute segments separated by software global barriers,
        # then write back.  The barriers serialize everything, so the E/G
        # overlap the single-level path models cannot occur.
        chains = [
            _Chain(
                cluster=i,
                e_sizes=ops[i],
                g_sizes=[],
                eligible=e_starts[i] + p.dma_setup(len(ops[i])),
            )
            for i in range(n)
        ]
        _run_port(port, chains, p.dma_latency)
        e_end = [c.e_end for c in chains]
        t = [e + p.phase_sync + p.f_init for e, _ in zip(e_end, range(n))]
        per_level = [job.compute_cycles(n, i) / job.levels for i in range(n)]
        for lvl in range(job.levels):
            t = [t[i] + per_level[i] for i in range(n)]
            if lvl < job.levels - 1:
                joined = max(t) + intra_barrier(n, p)
                t = [joined] * n
        f_end = [t[i] + p.phase_sync for i in range(n)]
        gchains = [
            _Chain(
                cluster=i,
                e_sizes=[],
                g_sizes=wbs[i],
                eligible=f_end[i] + p.dma_setup(len(wbs[i])),
            )
            for i in range(n)
        ]
        _run_port(port, gchains, p.dma_latency)
        g_end = [c.g_end for c in gchains]

    for i in range(n):
        spans.append(PhaseSpan(Phase.E, i, e_starts[i], e_end[i]))
        spans.append(PhaseSpan(Phase.F, i, e_end[i], f_end[i]))
        spans.append(PhaseSpan(Phase.G, i, f_end[i], g_end[i]))

    # ----- Phase H: notify job completion ---------------------------------------
    if mode == "ideal":
        total = max(g_end)
        return SimResult(job.name, mode, n, total, spans, g_end)

    h_start = max(g_end)
    if mode == "baseline":
        # Software central-counter barrier in cluster 0's TCDM: each DMA core
        # runs the arrival routine, AMO-increments the counter (serialized),
        # and the last arriver IPIs the host.
        arrivals = sorted(
            (g_end[i] + p.phase_sync + p.sw_barrier_code + p.narrow_latency(i, 0), i)
            for i in range(n)
        )
        counter_free = 0.0
        for t_arr, _ in arrivals:
            counter_free = max(counter_free, t_arr) + p.amo_service
        host_irq = counter_free + p.host_store_first + p.noc_propagation
    else:
        # Job completion unit (§4.3): posted writes to the CLINT arrivals
        # register; the unit fires the host IPI when arrivals == offload.
        arrivals = [
            g_end[i] + p.phase_sync + p.unit_arrival_code + p.clint_travel
            for i in range(n)
        ]
        host_irq = max(arrivals) + p.unit_fire + p.noc_propagation
    spans.append(PhaseSpan(Phase.H, -1, h_start, host_irq))

    # ----- Phase I: resume operation on host -------------------------------------
    total = host_irq + p.host_resume
    spans.append(PhaseSpan(Phase.I, -1, host_irq, total))
    return SimResult(job.name, mode, n, total, spans, g_end)


def intra_barrier(n: int, p: OccamyParams = DEFAULT_PARAMS) -> float:
    """In-job software global barrier (BFS level sync): central counter."""
    return p.narrow_cross_quadrant + p.amo_service * n


def offload_overhead(job: JobSpec, n: int, mode: Mode = "baseline",
                     params: OccamyParams = DEFAULT_PARAMS) -> float:
    """The paper's §5.2 metric: t_mode - t_ideal."""
    t = simulate(job, n, mode, params).total
    t_ideal = simulate(job, n, "ideal", params).total
    return t - t_ideal


def speedups(job: JobSpec, n: int, params: OccamyParams = DEFAULT_PARAMS):
    """(ideal speedup, achieved speedup, restoration) — fig. 8 metrics."""
    base = simulate(job, n, "baseline", params).total
    ideal = simulate(job, n, "ideal", params).total
    ext = simulate(job, n, "multicast", params).total
    s_ideal = base / ideal
    s_ext = base / ext
    return s_ideal, s_ext, s_ext / s_ideal


# ---------------------------------------------------------------------------
# Hierarchical staging cost model (the §6 treatment, extended to the
# replicated-operand host-link staging of phases E and G).
# ---------------------------------------------------------------------------

#: staging strategies the cost model distinguishes — "host_fanout" is the
#: O(n) serialized host-link baseline, "tree" the O(1) hierarchical
#: broadcast staging over the derived fan-out tree ("direct" and
#: "tree_reshard" delegate their data path to the substrate, so the model
#: has nothing mechanistic to say about them)
STAGING_MODES = bcast.DATA_PATH_MODES


def _resolve_selection(cluster_ids: Union[int, Iterable[int]]) -> List[int]:
    if isinstance(cluster_ids, int):
        return list(range(cluster_ids))
    return sorted(set(int(c) for c in cluster_ids))


def simulate_staging(nbytes: float, cluster_ids: Union[int, Iterable[int]],
                     mode: str, params: OccamyParams = DEFAULT_PARAMS
                     ) -> float:
    """Discrete-event staging time (cycles) of one replicated operand.

    The phase-E/phase-G counterpart of :func:`simulate` for the host-link
    leg: how long until every selected cluster holds the ``nbytes`` operand.

    * ``host_fanout`` — one host-link transfer per cluster, issued
      sequentially (descriptor programming pipelines behind the busy link,
      but issue is still bounded by the host's outstanding-write budget,
      ``host_store_next``) and served FIFO by the wide port.
    * ``tree`` — one host-link transfer to the fan-out tree root, then the
      tree levels of :func:`repro_torch.core.broadcast.build_tree` in sequence;
      edges within a level ride disjoint links in parallel, each paying the
      per-hop descriptor setup, the link occupancy, the DMA round trip, and
      the *quadrant-dependent* wire latency (the second-order effect the
      closed form ignores).

    Phase G (writeback gather) is the mirror image — same tree, reversed
    edges — so the model doubles as its cost term.
    """
    p = params
    ids = _resolve_selection(cluster_ids)
    n = len(ids)
    if n < 1:
        raise ValueError("empty cluster selection")
    xfer = max(1.0, nbytes / p.wide_bw_bytes_per_cycle)
    if mode == "host_fanout":
        link_free = 0.0
        for i in range(n):
            issue = p.dma_setup_one + i * p.host_store_next
            link_free = max(link_free, issue) + xfer
        return link_free + p.dma_latency
    if mode == "tree":
        tree = bcast.build_tree(ids, p.clusters_per_quadrant)
        t = p.dma_setup_one + xfer + p.dma_latency      # root upload
        for level in tree.levels:
            # per-edge wire latency is the quadrant-aware narrow-network
            # cost of §5.5 C (tree edges never have src == dst)
            t += max(p.dma_setup_one + xfer + p.dma_latency
                     + p.narrow_latency(s, d) for s, d in level)
        return t
    raise ValueError(f"mode must be one of {STAGING_MODES}")


def staging_model(nbytes: float, cluster_ids: Union[int, Iterable[int]],
                  mode: str, params: OccamyParams = DEFAULT_PARAMS) -> float:
    """Closed-form staging time (cycles) — the eq.-5-style prediction.

    ``t_hf ≈ t_setup + n·size/BW + t_lat`` (the O(n) host link) vs
    ``t_tree ≈ (t_setup + size/BW + t_lat) · (1 + depth) + depth·t_wire``
    with a single worst-case cross-quadrant ``t_wire`` constant — the
    per-edge heterogeneity and issue serialization the discrete-event
    model resolves are deliberately dropped, exactly as the paper's
    analytical model drops its second-order effects (§6, <15% error).
    """
    p = params
    ids = _resolve_selection(cluster_ids)
    n = len(ids)
    xfer = max(1.0, nbytes / p.wide_bw_bytes_per_cycle)
    if mode == "host_fanout":
        return p.dma_setup_one + n * xfer + p.dma_latency
    if mode == "tree":
        depth = bcast.depth_bound(ids, p.clusters_per_quadrant)
        hop = p.dma_setup_one + xfer + p.dma_latency + p.narrow_cross_quadrant
        return (p.dma_setup_one + xfer + p.dma_latency) + depth * hop
    raise ValueError(f"mode must be one of {STAGING_MODES}")


def simulate_forward(nbytes: float, src_ids: Union[int, Iterable[int]],
                     dst_ids: Union[int, Iterable[int]], *,
                     replicate: bool = False,
                     params: OccamyParams = DEFAULT_PARAMS) -> float:
    """Discrete-event cost (cycles) of one d2d result-forwarding edge.

    A producer's ``nbytes`` result lives on the ``src_ids`` selection; a
    dependent consumer needs it on ``dst_ids``.  Same selection — the
    aliasing fast path of ``DispatchPlan.forward`` — costs nothing: the
    consumer's program reads the producer's output shards in place.
    Otherwise the result hops device-to-device from the producer's root
    to the consumer's root (paying the quadrant-aware narrow-network
    latency of §5.5 C), and ``replicate=True`` additionally fans it out
    along the consumer selection's broadcast-tree levels — forwarding
    rides the same broadcast tree as staging, just without the host upload.
    """
    p = params
    src = _resolve_selection(src_ids)
    dst = _resolve_selection(dst_ids)
    if not src or not dst:
        raise ValueError("empty cluster selection")
    if src == dst and not replicate:
        return 0.0
    xfer = max(1.0, nbytes / p.wide_bw_bytes_per_cycle)
    t = 0.0
    if src != dst:
        t += (p.dma_setup_one + xfer + p.dma_latency
              + p.narrow_latency(src[0], dst[0]))
    if replicate and len(dst) > 1:
        tree = bcast.build_tree(dst, p.clusters_per_quadrant)
        for level in tree.levels:
            t += max(p.dma_setup_one + xfer + p.dma_latency
                     + p.narrow_latency(s, d) for s, d in level)
    return t


def forward_model(nbytes: float, src_ids: Union[int, Iterable[int]],
                  dst_ids: Union[int, Iterable[int]], *,
                  replicate: bool = False,
                  params: OccamyParams = DEFAULT_PARAMS) -> float:
    """Closed-form per-hop forward cost — the eq.-5-style prediction.

    ``t_fwd ≈ hop + depth(dst) · hop`` with ``hop = t_setup + size/BW +
    t_lat + t_wire`` and a single worst-case cross-quadrant ``t_wire``,
    dropping the per-edge latency heterogeneity the discrete-event model
    resolves (§6 abstraction level).  Zero for the aliasing fast path.
    """
    p = params
    src = _resolve_selection(src_ids)
    dst = _resolve_selection(dst_ids)
    if src == dst and not replicate:
        return 0.0
    xfer = max(1.0, nbytes / p.wide_bw_bytes_per_cycle)
    hop = p.dma_setup_one + xfer + p.dma_latency + p.narrow_cross_quadrant
    t = hop if src != dst else 0.0
    if replicate and len(dst) > 1:
        t += bcast.depth_bound(dst, p.clusters_per_quadrant) * hop
    return t


def selection_requests(cluster_ids: Union[int, Iterable[int]],
                       num_clusters: Optional[int] = None) -> int:
    """Multicast requests the one-write wakeup needs for a selection.

    The paper's single-request dispatch (§5) holds only when the cluster
    selection is one aligned power-of-two subcube of the mesh; any other
    selection greedily decomposes into several subcube requests
    (:func:`repro_torch.core.multicast.encode_cluster_selection_multi`), each
    replaying the dispatch-constant phases.  The perf linter's OFLP105
    pass and the ``perflint`` bench both key off this count, so it lives
    here in the measurement domain.
    """
    from repro_torch.core import multicast as mc
    ids = _resolve_selection(cluster_ids)
    if not ids:
        raise ValueError("empty cluster selection")
    return len(mc.encode_cluster_selection_multi(
        ids, num_clusters if num_clusters is not None else mc.NUM_CLUSTERS))


def model_error(predicted: float, measured: float) -> float:
    """Relative model error |predicted - measured| / measured (fig.-12
    metric; the paper's bar is < 0.15 everywhere)."""
    if measured == 0:
        raise ValueError("measured time must be non-zero")
    return abs(predicted - measured) / abs(measured)


def staging_model_error(nbytes: float,
                        cluster_ids: Union[int, Iterable[int]], mode: str,
                        params: OccamyParams = DEFAULT_PARAMS) -> float:
    """Closed form vs discrete event for one staging point."""
    return model_error(staging_model(nbytes, cluster_ids, mode, params),
                       simulate_staging(nbytes, cluster_ids, mode, params))


# ---------------------------------------------------------------------------
# Multi-tenant fabric contention (the fabric scheduler's measurement domain).
#
# The paper measures ONE host job owning the whole fabric; spatially
# partitioning the mesh between tenants (disjoint cluster leases) leaves
# exactly one shared serial resource: the host core and its link, which
# issues every tenant's phase-A job information, doorbell store, and
# phase-I resume.  This model composes the single-job simulator with that
# shared-host FIFO: each tenant pipelines jobs on its own lease (device
# phases of different leases run concurrently), while all host-side work
# serializes in eligibility order — the contention the FabricScheduler's
# admission model has to predict.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantWorkload:
    """One tenant's job stream on one cluster lease.

    ``clusters`` is the lease's (global) cluster-id selection; workloads
    sharing an *identical* selection share the device resource (how the
    serialized whole-mesh baseline is expressed), disjoint selections run
    concurrently.  ``window`` bounds the tenant's in-flight jobs (the
    completion-unit copies); ``arrival`` is the cycle its first dispatch
    becomes eligible.
    """

    tenant: str
    spec: JobSpec
    clusters: tuple
    jobs: int = 1
    arrival: float = 0.0
    window: int = 4

    def __post_init__(self) -> None:
        if not self.clusters:
            raise ValueError("a workload needs at least one cluster")
        if self.jobs < 1:
            raise ValueError(f"jobs must be >= 1, got {self.jobs}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.arrival < 0:
            raise ValueError(f"arrival must be >= 0, got {self.arrival}")


@dataclasses.dataclass(frozen=True)
class PreemptionEvent:
    """A mid-stream lease revocation in the fabric contention model.

    Once ``tenant`` has dispatched ``after_jobs`` jobs, its lease is
    revoked: the in-flight window must fully *drain* (every dispatched
    job resumes — the model analogue of the scheduler's drain deadline)
    before the next dispatch, which then lands on ``new_clusters`` (the
    re-placement window, possibly a degraded smaller one) after paying
    ``restage_cycles`` (resident operands re-crossing to the new root).
    """

    tenant: str
    after_jobs: int
    new_clusters: tuple
    restage_cycles: float = 0.0

    def __post_init__(self) -> None:
        if self.after_jobs < 1:
            raise ValueError(
                f"after_jobs must be >= 1, got {self.after_jobs}")
        if not self.new_clusters:
            raise ValueError("a re-placement needs at least one cluster")
        if self.restage_cycles < 0:
            raise ValueError(
                f"restage_cycles must be >= 0, got {self.restage_cycles}")


@dataclasses.dataclass
class FabricSimResult:
    """Discrete-event outcome of a multi-tenant fabric schedule."""

    makespan: float                      # first arrival -> last resume done
    completion: Dict[str, float]         # tenant -> last job's resume end
    host_busy: float                     # cycles the shared host was occupied
    work: float                          # sum of ideal serial work (n=1 cycles)
    # tenant -> every job's resume end, dispatch order (token latencies)
    job_completions: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)

    def utilization(self, num_clusters: int) -> float:
        """Useful-work fraction of the fabric: ideal serial cycles of the
        completed jobs over fabric-cycles elapsed.  The numerator is
        schedule-invariant, so utilization ratios between schedules reduce
        to inverse makespan ratios."""
        if self.makespan <= 0:
            return 0.0
        return self.work / (num_clusters * self.makespan)


def _workload_times(w: TenantWorkload, p: OccamyParams
                    ) -> tuple:
    """(t_host, t_dev, t_resume, serial_work) of one job of ``w``.

    ``t_host`` is the host-occupying dispatch leg (phase A + the doorbell
    store of B); ``t_resume`` the phase-I host leg; ``t_dev`` everything in
    between (propagation, C..H) from the single-job simulator at the
    lease's cluster count.
    """
    n = len(w.clusters)
    total = simulate(w.spec, n, "multicast", p).total
    t_host = (p.host_info_base + p.host_info_per_word * (1 + w.spec.arg_words)
              + p.host_store_first)
    t_resume = p.host_resume
    t_dev = total - t_host - t_resume
    work = simulate(w.spec, 1, "ideal", p).total
    return t_host, t_dev, t_resume, work


def _segment_table(w: TenantWorkload,
                   preemptions: Sequence[PreemptionEvent],
                   p: OccamyParams) -> List[tuple]:
    """``w``'s job stream split at its preemption events:
    ``(start_job, lease_key, t_dev, restage_cycles)`` per segment.  The
    host legs (dispatch, resume) are window-size-invariant, so only the
    device time is re-derived for a re-placement window."""
    table = [(0, tuple(w.clusters), _workload_times(w, p)[1], 0.0)]
    for e in sorted((e for e in preemptions if e.tenant == w.tenant),
                    key=lambda e: e.after_jobs):
        if e.after_jobs >= w.jobs or e.after_jobs <= table[-1][0]:
            continue
        seg_w = dataclasses.replace(w, clusters=tuple(e.new_clusters))
        table.append((e.after_jobs, tuple(e.new_clusters),
                      _workload_times(seg_w, p)[1], e.restage_cycles))
    return table


def _segment_at(table: List[tuple], job: int) -> tuple:
    seg = table[0]
    for entry in table:
        if entry[0] <= job:
            seg = entry
    return seg


def simulate_fabric(workloads: Sequence[TenantWorkload],
                    params: OccamyParams = DEFAULT_PARAMS,
                    preemptions: Sequence[PreemptionEvent] = ()
                    ) -> FabricSimResult:
    """Discrete-event multi-tenant schedule over the shared host.

    Per tenant: dispatches are serial on the host and bounded by the
    in-flight ``window``; a job's device phases start when its dispatch
    lands *and* its lease is free (jobs on one lease serialize, leases are
    concurrent); its resume runs on the host after the device phases end.
    The host serves dispatch/resume requests in eligibility order (FIFO,
    resume preferred on ties so windows drain), exactly like the wide-port
    model above.

    ``preemptions`` model revocable leases under contention: at each of a
    tenant's :class:`PreemptionEvent` boundaries its in-flight window
    must fully drain (every dispatched job resumes) before the next
    dispatch, which pays the event's restage delay and lands on the
    re-placement window — the timing shape of
    ``FabricScheduler.preempt`` → drain → snapshot → re-place → restage.
    """
    if not workloads:
        raise ValueError("empty workload set")
    p = params
    times = [_workload_times(w, p) for w in workloads]
    segs = [_segment_table(w, preemptions, p) for w in workloads]
    lease_free: Dict[tuple, float] = {}
    host_free = 0.0
    host_busy = 0.0
    dispatched = [0] * len(workloads)
    completed = [0] * len(workloads)
    last_host_end = [0.0] * len(workloads)
    last_resume_end = [0.0] * len(workloads)
    dev_end: List[List[float]] = [[] for _ in workloads]
    completion: Dict[str, float] = {}
    job_completions: Dict[str, List[float]] = {w.tenant: []
                                               for w in workloads}
    total_jobs = sum(w.jobs for w in workloads)
    done = 0
    while done < total_jobs:
        best = None      # (eligible, kind, idx)
        for k, w in enumerate(workloads):
            # resume of the oldest un-collected job (kind 0: frees windows)
            if completed[k] < dispatched[k]:
                cand = (dev_end[k][completed[k]], 0, k)
                if best is None or cand < best:
                    best = cand
            # next dispatch, if the window has room
            if (dispatched[k] < w.jobs
                    and dispatched[k] - completed[k] < max(1, w.window)):
                seg = _segment_at(segs[k], dispatched[k])
                boundary = (seg[0] == dispatched[k] and seg[0] > 0)
                if boundary and completed[k] < dispatched[k]:
                    pass        # drain gate: window must empty first
                else:
                    elig = max(w.arrival, last_host_end[k])
                    if boundary:
                        # the re-placement dispatch waits out the drain
                        # and pays the operand restage
                        elig = max(elig, last_resume_end[k] + seg[3])
                    cand = (elig, 1, k)
                    if best is None or cand < best:
                        best = cand
        assert best is not None, "scheduler deadlock (window < 1?)"
        eligible, kind, k = best
        w = workloads[k]
        t_host, _, t_resume, _ = times[k]
        start = max(host_free, eligible)
        if kind == 1:                               # dispatch
            seg = _segment_at(segs[k], dispatched[k])
            host_free = start + t_host
            host_busy += t_host
            last_host_end[k] = host_free
            key = seg[1]
            dev_start = max(host_free, lease_free.get(key, 0.0))
            lease_free[key] = dev_start + seg[2]
            dev_end[k].append(dev_start + seg[2])
            dispatched[k] += 1
        else:                                       # resume (job collected)
            host_free = start + t_resume
            host_busy += t_resume
            completed[k] += 1
            last_resume_end[k] = host_free
            completion[w.tenant] = max(completion.get(w.tenant, 0.0),
                                       host_free)
            job_completions[w.tenant].append(host_free)
            done += 1
    # the declared span is first arrival -> last resume done; completion
    # times stay absolute (same clock as the arrivals)
    makespan = (max(completion.values())
                - min(w.arrival for w in workloads))
    work = sum(t[3] * w.jobs for t, w in zip(times, workloads))
    return FabricSimResult(makespan=makespan, completion=completion,
                           host_busy=host_busy, work=work,
                           job_completions=job_completions)


def fabric_makespan_model(workloads: Sequence[TenantWorkload],
                          params: OccamyParams = DEFAULT_PARAMS,
                          preemptions: Sequence[PreemptionEvent] = ()
                          ) -> float:
    """Closed-form makespan prediction — the §6 treatment extended to the
    multi-tenant fabric.  Three lower bounds, composed by max:

    * **tenant pipeline** — a tenant's jobs flow at the pipeline period
      ``max(t_host + t_resume, t_dev)`` (host leg hidden behind the
      previous job's device phases once the window is open); each
      preemption boundary adds a full drain-and-refill — the segment
      tail (``t_dev + t_resume``), the restage delay, and a fresh
      un-hidden host leg — on the segment's own window size;
    * **shared host** — every dispatch and resume serializes on the host,
      plus the shortest device tail after the last dispatch;
    * **shared lease** — workloads on an identical cluster selection
      serialize their device phases (the whole-mesh baseline's bound),
      counted per segment under preemption.

    The second-order effects the discrete-event model resolves (host FIFO
    interleaving, window drain order) are deliberately dropped — the same
    abstraction level as the paper's analytical model (§6, < 15 % error).
    """
    if not workloads:
        raise ValueError("empty workload set")
    times = [_workload_times(w, params) for w in workloads]
    segs = [_segment_table(w, preemptions, params) for w in workloads]
    bounds = []
    lease_work: Dict[tuple, float] = {}      # key -> summed device cycles
    lease_first: Dict[tuple, float] = {}     # key -> earliest dispatch land
    lease_tail: Dict[tuple, float] = {}      # key -> shortest resume leg
    for k, w in enumerate(workloads):
        t_host, _, t_resume, _ = times[k]
        table = segs[k]
        bound = w.arrival
        for i, (start, key, t_dev_s, restage) in enumerate(table):
            jobs_s = (table[i + 1][0] if i + 1 < len(table)
                      else w.jobs) - start
            period = max(t_host + t_resume, t_dev_s)
            bound += (restage + t_host + (jobs_s - 1) * period
                      + t_dev_s + t_resume)
            lease_work[key] = lease_work.get(key, 0.0) + jobs_s * t_dev_s
            lease_first[key] = min(lease_first.get(key, float("inf")),
                                   w.arrival + t_host)
            lease_tail[key] = min(lease_tail.get(key, t_resume), t_resume)
        bounds.append(bound)
    host_work = sum((times[k][0] + times[k][2]) * w.jobs
                    for k, w in enumerate(workloads))
    bounds.append(min(w.arrival for w in workloads) + host_work
                  + min(min(s[2] for s in table) for table in segs))
    for key, dev_work in lease_work.items():
        bounds.append(lease_first[key] + dev_work + lease_tail[key])
    # same span convention as simulate_fabric: first arrival -> last done
    return max(bounds) - min(w.arrival for w in workloads)


@dataclasses.dataclass(frozen=True)
class StagingCostModel:
    """Calibrated staging-cost model for an arbitrary substrate (wallclock).

    The cycle-level :func:`staging_model` is anchored to Occamy constants;
    real substrates (a CPU device mesh, a TPU pod) have their own link
    costs.  This model keeps the same *shape* — O(n) uploads vs one upload
    plus (n-1) tree-edge copies — with three constants calibrated from
    measured n ∈ {1, 2} points (:meth:`calibrate`), then predicts the
    remaining sweep; ``benchmarks/offload_wallclock.py`` validates the
    prediction against measurement under the paper's <15 % bar.
    """

    t_up: float          # one host->device transfer of the operand
    t_edge: float        # one tree-edge device-to-device copy
    t_fixed: float = 0.0  # per-staging fixed overhead

    def predict(self, mode: str, n: int) -> float:
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if mode == "host_fanout":
            return self.t_fixed + n * self.t_up
        if mode == "tree":
            return self.t_fixed + self.t_up + (n - 1) * self.t_edge
        raise ValueError(f"mode must be one of {STAGING_MODES}")

    @classmethod
    def calibrate(cls, hf1: float, hf2: float, tree_k: float, k: int = 2
                  ) -> "StagingCostModel":
        """Fit from three measurements: host_fanout at n ∈ {1, 2} and tree
        at n=k.  ``hf2 - hf1`` isolates one upload; ``(tree_k - hf1) /
        (k - 1)`` averages the edge cost over k-1 tree edges (larger k
        smooths per-edge measurement noise)."""
        t_up = hf2 - hf1
        if t_up <= 0:
            raise ValueError(
                f"host_fanout must grow with n (got {hf1} -> {hf2})")
        if k < 2:
            raise ValueError(f"tree calibration point needs k >= 2, got {k}")
        return cls(t_up=t_up, t_edge=(tree_k - hf1) / (k - 1),
                   t_fixed=hf1 - t_up)
