"""Unified predictive offload session — one submit path, model-driven modes.

Twin of ``repro.core.session``.  A session owns the logical clusters of
one device (``Session(device=None, num_clusters=None)``: the card and
Occamy's 32 clusters by default; ``device="cpu"`` runs the kernels'
plain versions), or a fabric lease's window of them.  The paper's final contribution is a quantitative model of offloaded
runtime (§6, error < 15%); its companion work (Colagrande & Benini,
"Optimizing Offload Performance in Heterogeneous MPSoCs",
arXiv:2404.01908) argues the *mode* of an offload — multicast vs. p2p,
fused vs. streamed, how wide a pipeline — should be chosen by that model,
not hardcoded per call.  After PRs 1–3 this framework had the pieces but
not the wiring: validated dispatch/staging cost models sat in
:mod:`repro_torch.core.simulator` and :mod:`repro_torch.core.model` while
the user surface fragmented into four stringly-typed entry points
(``offload(job, "resident")``, ``via=`` kwargs, ``OffloadStream``,
``offload_fused``, plus the serve engine).  This module is the wiring:

* :class:`Session` — the single front door.  ``submit(job, operands)``
  covers one-shot, resident, fused, and streamed dispatch: a dict is one
  job, a list of dicts is many (fused into B-launches and/or pipelined
  through an in-flight window), ``Residency.RESIDENT`` redispatches
  warm buffers.  Successive single submits of the same (job, selection)
  pair share a pipelined stream, so the session *is* the stream.
* :class:`Planner` — fills the open fields of an
  :class:`~repro_torch.core.policy.OffloadPolicy` (``policy=AUTO``) from the
  simulator's cost models: staging mode per replicated-operand footprint
  (discrete-event ``simulate_staging``), fusion factor B and pipeline
  window from the eq.-4 phase terms (dispatch constant amortized over B,
  staging overlapped when the window is open).
* :func:`estimate` / :meth:`SessionHandle.explain` — the <15 %-error
  model as an API contract: the predicted phase-by-phase breakdown
  (paper fig. 11 / §6) and the host-link staging-leg predictions are
  returned next to the measured :class:`~repro_torch.core.offload.PlanStats`,
  so every dispatch can say what it *should* have cost.

The per-job amortization model (README "Pipelined offload"):

    t_job(B, W) = t_const/B + t_E + t_F + t_G            (W = 1)
    t_job(B, W) = max(t_const/B + t_E, t_F + t_G)        (W > 1)

with ``t_const`` the dispatch-constant phases (A–D, H, I) paid once per
launch and the E/F/G terms scaling with the fused batch; an open window
overlaps the next launch's host-side work (constant + staging) with the
current launch's device phases.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Deque, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis.diagnostics import DiagnosticsLog
from repro_torch.core import model as amodel
from repro_torch.core import multicast as mc
from repro_torch.core import simulator
from repro_torch.core.fabric import ClusterLease, Overloaded
from repro_torch.core.faults import (
    PROBE_N, CompletionTimeout, FaultError, FaultInjector, SessionHealth,
    deadline_cycles,
)
from repro_torch.core.jobs import PaperJob, make_axpy, stack_instances
from repro_torch.core.offload import (
    FusedHandle, JobHandle, OffloadConfig, OffloadRuntime, PlanStats,
    numpy_dtype, resolve_device,
)
from repro_torch.core.params import DEFAULT_PARAMS, OccamyParams
from repro_torch.core.phases import Phase
from repro_torch.core.policy import (
    AUTO, InfoDist, OffloadPolicy, Residency, RetryPolicy, Staging,
)
from repro_torch.core.scoreboard import (
    ISSUED, GraphError, GraphNode, InflightWindow, Ref, Scoreboard,
    resolve_graph,
)
from repro_torch.core.stream import OffloadStream

#: dispatch-constant phases — paid once per launch, amortized by fusion
CONST_PHASES = (Phase.A, Phase.B, Phase.C, Phase.D, Phase.H, Phase.I)


def nbytes_of(value: Any) -> int:
    """Bytes of a numpy array, a tensor on any device, or an array-like
    (read from its shape and dtype, never from its data)."""
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    return int(np.asarray(value).nbytes)


def amortized_per_job(phases: Mapping[Phase, float], fuse: int,
                      window: int) -> float:
    """The per-job amortization model over a set of eq.-4 phase terms
    (module docstring): t_const/B + t_E + t_F + t_G serially, with the
    host-side work (constant + staging) hidden behind the previous
    launch's device phases once the window is open.  Shared by
    :meth:`Planner.per_job_cycles` and :func:`estimate` so the model has
    one definition."""
    const = sum(phases.get(p, 0.0) for p in CONST_PHASES)
    e = phases.get(Phase.E, 0.0)
    fg = phases.get(Phase.F, 0.0) + phases.get(Phase.G, 0.0)
    if window > 1:
        return max(const / fuse + e, fg)
    return const / fuse + e + fg


def predict_staging(nbytes: float, clusters: Union[int, Sequence[int]],
                    staging: Union[str, Staging],
                    params: OccamyParams = DEFAULT_PARAMS) -> float:
    """Closed-form host-link staging prediction for one replicated operand.

    The §6-style contract surface for phase-E staging: ``DIRECT`` and
    ``HOST_FANOUT`` both move O(n) logical host-link bytes and share the
    O(n) closed form; ``TREE`` / ``TREE_RESHARD`` share the O(1)-upload
    tree form (< 15 % vs. the discrete-event ``simulate_staging``, as the
    reference validates it).
    """
    staging = Staging(staging)
    mode = ("tree" if staging in (Staging.TREE, Staging.TREE_RESHARD)
            else "host_fanout")
    return simulator.staging_model(nbytes, clusters, mode, params)


@dataclasses.dataclass(frozen=True)
class PlanDecision:
    """The planner's resolution of an :class:`OffloadPolicy`'s open fields."""

    n: int
    staging: Staging
    fuse: int                 # B instances per launch (1 = unfused)
    window: int               # in-flight launches (1 = synchronous)
    residency: Residency
    reason: str = ""          # one-line planner note (why these modes)


@dataclasses.dataclass(frozen=True)
class Estimate:
    """Predicted cost of an offload under a decision (paper §6 surface).

    ``phases`` are the eq.-4 per-phase terms of ONE job on ``n`` clusters
    (multicast implementation; the baseline is simulated instead —
    §5.6).  ``job_cycles`` is the modeled end-to-end runtime of one job
    (with the beyond-paper port-saturation bound); ``per_job_cycles``
    applies the decision's fusion/pipelining amortization.
    ``staging_cycles`` predicts the host-link staging leg of the
    replicated operands for every staging strategy (the comparison the
    planner ran), keyed by ``Staging`` value.
    """

    job: str
    n: int
    batch: int
    decision: PlanDecision
    phases: Mapping[Phase, float]
    job_cycles: float
    per_job_cycles: float
    staging_cycles: Mapping[str, float]
    replicated_bytes: int

    @property
    def per_launch_phases(self) -> Dict[Phase, float]:
        """Phase terms of ONE fused launch under the decision: the
        dispatch-constant phases are paid once, the batch-scaling phases
        (E operand staging, F compute, G writeback) carry all B stacked
        instances.  Equal to ``phases`` when the launch is unfused."""
        B = self.decision.fuse
        return {ph: (v if ph in CONST_PHASES else v * B)
                for ph, v in self.phases.items()}

    @property
    def per_instance_phases(self) -> Dict[Phase, float]:
        """Phase terms attributable to one instance of a fused launch:
        the dispatch constant amortized over B, the batch-scaling phases
        at their single-instance size.  Equal to ``phases`` when
        unfused."""
        B = self.decision.fuse
        return {ph: (v / B if ph in CONST_PHASES else v)
                for ph, v in self.phases.items()}

    def table(self) -> str:
        """Phase-by-phase breakdown, render-ready (fig. 11 shape).

        For a fused decision (B > 1) each phase reports the
        *per-instance* and *per-launch* terms side by side — a stacked
        batch is otherwise ambiguous about which of the two a number
        means."""
        lines = [f"estimate {self.job} n={self.n} batch={self.batch} "
                 f"[staging={self.decision.staging.value} "
                 f"fuse={self.decision.fuse} window={self.decision.window}]"]
        B = self.decision.fuse
        per_inst = self.per_instance_phases
        per_launch = self.per_launch_phases
        for ph in Phase:
            if ph in self.phases:
                if B > 1:
                    lines.append(
                        f"  phase {ph.name}: per-instance "
                        f"{per_inst[ph]:12.1f} cyc | per-launch (B={B}) "
                        f"{per_launch[ph]:12.1f} cyc")
                else:
                    lines.append(f"  phase {ph.name}: "
                                 f"{self.phases[ph]:12.1f} cyc")
        lines.append(f"  job total:  {self.job_cycles:12.1f} cyc "
                     f"(per-job amortized: {self.per_job_cycles:.1f})")
        if self.replicated_bytes:
            stag = ", ".join(f"{k}={v:.0f}"
                             for k, v in self.staging_cycles.items())
            lines.append(f"  staging leg ({self.replicated_bytes} replicated "
                         f"bytes): {stag} cyc")
        if self.decision.reason:
            lines.append(f"  planner: {self.decision.reason}")
        return "\n".join(lines)

    __str__ = table


class Planner:
    """Model-driven mode selection: fills an ``OffloadPolicy``'s open
    fields from the simulator's dispatch and staging cost models."""

    #: candidate fusion factors (powers of two keep the compiled-program
    #: count per plan small; 8 matches the reference's bench sweep)
    FUSE_CANDIDATES = (1, 2, 4, 8)

    #: substrate-validity guard for tree staging in :meth:`decide`: the
    #: cycle model (a serial host link, §4.1) says the fan-out tree wins
    #: from n >= 4 at any size, but a real substrate's host link is
    #: parallel and cache-dominated: a sub-MiB replicated upload is
    #: near-free and device tree copies are not, so the tree wins
    #: wall-clock only in the bandwidth-bound regime.  The value is the
    #: reference's, so both packages make the same decisions.  Below
    #: this footprint ``decide`` stays on the substrate's native DIRECT
    #: path; set it to 0 for a model-faithful (Occamy-like, serial-link)
    #: substrate.  ``pick_staging`` itself is the pure cycle-domain
    #: ordering either way — it is what ``estimate`` reports and what the
    #: staging-suite acceptance validates.
    TREE_MIN_BYTES = 8 << 20

    def __init__(self, params: OccamyParams = DEFAULT_PARAMS,
                 max_fuse: int = 8,
                 tree_min_bytes: Optional[int] = None):
        self.params = params
        self.max_fuse = max_fuse
        self.tree_min_bytes = (self.TREE_MIN_BYTES if tree_min_bytes is None
                               else tree_min_bytes)

    # -- model pieces -------------------------------------------------------

    def replicated_bytes(self, job: PaperJob,
                         operands: Optional[Mapping[str, Any]] = None) -> int:
        """Host-link-replicated operand footprint (shard_axes None)."""
        if operands is None:
            operands, _ = job.make_instance(0)
        return sum(nbytes_of(v)
                   for k, v in operands.items()
                   if job.shard_axes.get(k) is None)

    def staging_cost(self, nbytes: int,
                     clusters: Union[int, Sequence[int]],
                     staging: Staging) -> float:
        """Discrete-event staging cycles of the replicated footprint —
        the simulator's view, used for *decisions* (the closed form of
        :func:`predict_staging` is the prediction contract)."""
        if nbytes <= 0:
            return 0.0
        mode = ("tree" if staging in (Staging.TREE, Staging.TREE_RESHARD)
                else "host_fanout")
        return simulator.simulate_staging(nbytes, clusters, mode, self.params)

    def per_job_cycles(self, spec: simulator.JobSpec, n: int,
                       fuse: int = 1, window: int = 1) -> float:
        """The amortization model (module docstring): eq.-4 terms with
        the dispatch constant paid per launch and host work overlapped
        when the window is open."""
        return amortized_per_job(amodel.predict(spec, n, self.params).terms,
                                 fuse, window)

    # -- decisions ----------------------------------------------------------

    def pick_staging(self, nbytes: int,
                     clusters: Union[int, Sequence[int]]) -> Staging:
        n = clusters if isinstance(clusters, int) else len(list(clusters))
        if nbytes <= 0 or n < 2:
            return Staging.DIRECT   # nothing to fan out
        tree = self.staging_cost(nbytes, clusters, Staging.TREE)
        fanout = self.staging_cost(nbytes, clusters, Staging.HOST_FANOUT)
        # DIRECT delegates to the substrate but moves the same O(n)
        # logical host-link bytes as the explicit fan-out
        return Staging.TREE if tree <= fanout else Staging.DIRECT

    def pick_fuse(self, spec: simulator.JobSpec, n: int, batch: int) -> int:
        """Fuse when (and only when) the job is dispatch/staging-bound.

        The eq.-4 terms split a launch into host-side work (the dispatch
        constant + phase-E staging) and device work (F + G).  In the
        fine-grained regime — host work >= device work, the paper's
        motivating case — fusing amortizes the host critical path across
        the largest batch.  Compute-bound jobs pipeline instead: the
        open window already hides the host work behind the previous
        launch's compute, while fusing would defer job 0's launch behind
        B-1 extra stacked stagings for no modeled gain (per-job device
        work is B-independent).
        """
        cands = [b for b in self.FUSE_CANDIDATES
                 if b <= min(batch, self.max_fuse)]
        if len(cands) <= 1:
            return 1
        terms = amodel.predict(spec, n, self.params).terms
        host = (sum(terms.get(p, 0.0) for p in CONST_PHASES)
                + terms.get(Phase.E, 0.0))
        device = terms.get(Phase.F, 0.0) + terms.get(Phase.G, 0.0)
        return max(cands) if host >= device else 1

    def pick_window(self, batch: int, fuse: int, n_units: int) -> int:
        """In-flight launches: the eq.-4 overlap model says pipelining
        never hurts (host constant + staging hide behind device phases),
        so open the window to the completion-unit bound.  A multi-job
        submit needs no more than its launch count; a single-job submit
        keeps the window open for the submits that follow it (the
        session is the stream)."""
        if batch > 1:
            launches = math.ceil(batch / fuse)
            return max(1, min(n_units, launches))
        return max(1, n_units)

    def decide(self, job: PaperJob, clusters: Union[int, Sequence[int]],
               batch: int, policy: OffloadPolicy, n_units: int,
               operands: Optional[Mapping[str, Any]] = None) -> PlanDecision:
        n = clusters if isinstance(clusters, int) else len(list(clusters))
        resident = policy.residency is Residency.RESIDENT
        if policy.fuse is not None:
            # a pinned fuse factor is clamped to the submitted batch —
            # the launches that actually run (mirrors pick_fuse's cap),
            # so explain()/estimate never report a mode that never ran
            fuse = min(policy.fuse, max(batch, 1))
        elif resident and batch <= 1:
            # resident single-job redispatch reuses unfused buffers;
            # fusing would need a staged (B, ...) batch
            fuse = 1
        else:
            fuse = self.pick_fuse(job.spec, n, batch)
        if policy.staging is not None:
            staging = policy.staging
        elif resident:
            staging = Staging.DIRECT  # resident redispatch stages nothing
        else:
            # a fused launch stages the stacked batch as ONE B-times
            # larger replicated transfer (the B instances ride one
            # tree), so the bandwidth-regime guard sees B * rep bytes
            rep = self.replicated_bytes(job, operands) * fuse
            # the TREE_MIN_BYTES guard: only ride the tree where the
            # serial-link model's premise holds on this substrate
            staging = (self.pick_staging(rep, clusters)
                       if rep >= self.tree_min_bytes else Staging.DIRECT)
        window = (policy.window if policy.window is not None
                  else self.pick_window(batch, fuse, n_units))
        reason = (f"staging={staging.value} "
                  f"({'pinned' if policy.staging is not None else 'model'}), "
                  f"fuse={fuse} "
                  f"({'pinned' if policy.fuse is not None else 'model'}), "
                  f"window={window} "
                  f"({'pinned' if policy.window is not None else 'model'})")
        return PlanDecision(n=n, staging=staging, fuse=fuse, window=window,
                            residency=policy.residency, reason=reason)


def estimate(job: PaperJob, *,
             n: Optional[int] = None,
             clusters: Optional[Sequence[int]] = None,
             batch: int = 1,
             policy: Optional[OffloadPolicy] = None,
             n_units: int = 4,
             params: OccamyParams = DEFAULT_PARAMS,
             operands: Optional[Mapping[str, Any]] = None,
             planner: Optional[Planner] = None) -> Estimate:
    """Predict an offload's phase-by-phase cost under ``policy`` (model
    only — needs no devices, works at any ``n`` up to the Occamy
    topology).  The session's ``<15 %``-error contract surface: for the
    multicast implementation ``job_cycles`` is the paper's §6 analytical
    model (with the port-saturation refinement); the baseline
    implementation is simulated instead (§5.6: the paper models the
    extended system only).
    """
    policy = AUTO if policy is None else policy
    if (n is None) == (clusters is None):
        raise ValueError("give exactly one of n / clusters")
    sel: Union[int, List[int]] = (int(n) if n is not None
                                  else sorted(int(c) for c in clusters))
    n_eff = sel if isinstance(sel, int) else len(sel)
    if not (1 <= n_eff <= params.num_clusters):
        raise ValueError(f"n={n_eff} outside [1, {params.num_clusters}]")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    planner = planner or Planner(params)
    decision = planner.decide(job, sel, batch, policy, n_units,
                              operands=operands)

    if policy.info_dist is InfoDist.MULTICAST:
        phases = dict(amodel.predict(job.spec, n_eff, params).terms)
        job_cycles = amodel.predict_total_v2(job.spec, n_eff, params)
    else:
        sim = simulator.simulate(job.spec, n_eff, "baseline", params)
        phases = {ph: st.max for ph, st in sim.phase_stats().items()}
        job_cycles = sim.total

    per_job = amortized_per_job(phases, decision.fuse, decision.window)

    rep_bytes = planner.replicated_bytes(job, operands)
    staging_cycles = {}
    if rep_bytes > 0:
        for s in (Staging.DIRECT, Staging.HOST_FANOUT, Staging.TREE):
            staging_cycles[s.value] = predict_staging(rep_bytes, sel, s,
                                                      params)
    return Estimate(job=job.spec.name, n=n_eff, batch=batch,
                    decision=decision, phases=phases, job_cycles=job_cycles,
                    per_job_cycles=per_job, staging_cycles=staging_cycles,
                    replicated_bytes=rep_bytes)


@dataclasses.dataclass
class Explain:
    """Predicted breakdown next to the measured dispatch counters."""

    estimate: Estimate
    stats: PlanStats            # measured counters of the plans involved
    jobs: int
    wall_s: Optional[float] = None   # end-to-end, once waited
    findings: List[Any] = dataclasses.field(default_factory=list)

    def table(self) -> str:
        lines = [self.estimate.table(), f"measured ({self.jobs} jobs):"]
        for f in dataclasses.fields(PlanStats):
            lines.append(f"  {f.name}: {getattr(self.stats, f.name)}")
        if self.wall_s is not None:
            lines.append(f"  wall_s: {self.wall_s:.6f} "
                         f"({self.wall_s / max(self.jobs, 1) * 1e6:.1f} "
                         "us/job)")
        if self.findings:
            lines.append(f"perf findings ({len(self.findings)}):")
            for pf in self.findings:
                lines.append(f"  {pf}")
        return "\n".join(lines)

    __str__ = table


class SessionHandle:
    """In-flight submit: one job or a fused/pipelined batch of them.

    ``wait()`` returns the result (single submit) or the per-job results
    in submit order (list submit).  ``explain()`` returns the
    :class:`Explain` pairing the predicted breakdown with measured
    :class:`PlanStats`.
    """

    def __init__(self, session: "Session", job: PaperJob,
                 est: Estimate, parts: List[Tuple[str, Any]],
                 multi: bool, plans: List[Any], submitted_at: float,
                 findings: Sequence[Any] = ()):
        self.session = session
        self.job = job
        self._estimate = est
        self._parts = parts        # [("single", JobHandle) | ("fused", FusedHandle)]
        self._multi = multi
        self._plans = plans
        self._submitted_at = submitted_at
        self._wall: Optional[float] = None
        self._result: Any = None
        self._done = False
        #: advisory OFLP1## perf findings (submit ran with lint=True)
        self.findings: List[Any] = list(findings)

    @property
    def jobs(self) -> int:
        return sum(h.batch if kind == "fused" else 1
                   for kind, h in self._parts)

    @property
    def decision(self) -> PlanDecision:
        return self._estimate.decision

    def wait(self) -> Any:
        if self._done:
            return self._result
        out: List[Any] = []
        for kind, h in self._parts:
            if kind == "fused":
                out.extend(h.wait_each())
            else:
                out.append(h.wait())
        self._wall = time.monotonic() - self._submitted_at
        self._result = out if self._multi else out[0]
        self._done = True
        return self._result

    def explain(self) -> Explain:
        """Predicted phase breakdown (paper §6) next to measured stats.

        The measured counters are the cumulative :class:`PlanStats` of
        every dispatch plan this submit ran through (plans are shared
        across submits of the same (job, selection) pair — the counters
        are the plan's running totals, the same hooks the fast-path
        tests assert against).
        """
        agg = PlanStats()
        for plan in self._plans:
            if plan is not None:
                agg.accumulate(plan.stats)
        return Explain(estimate=self._estimate, stats=agg, jobs=self.jobs,
                       wall_s=self._wall, findings=list(self.findings))


class ReliableHandle:
    """In-flight *reliable* submit — the fault-tolerant path's handle.

    A policy with ``retry=RetryPolicy(...)`` routes ``Session.submit``
    here: every job instance runs under a model-driven deadline
    (:func:`repro_torch.core.faults.deadline_cycles` over the §6 estimate) and,
    on a trip, the session walks the escalation ladder — resubmit in
    place, disjoint backup window, full lease failover.  ``wait()``
    executes the ladder synchronously per instance and returns results in
    submit order; recoverable faults leave the results bit-identical to a
    fault-free run.
    """

    def __init__(self, session: "Session", job: PaperJob, est: Estimate,
                 instances: List[Mapping[str, np.ndarray]],
                 args_list: Optional[List[np.ndarray]],
                 pol: OffloadPolicy, retry: RetryPolicy,
                 multi: bool, sel: Sequence[int]):
        self.session = session
        self.job = job
        self._estimate = est
        self._instances = instances
        self._args: List[Optional[np.ndarray]] = (
            list(args_list) if args_list is not None
            else [None] * len(instances))
        self._pol = pol
        self._retry = retry
        self._multi = multi
        self._sel = list(sel)
        self._result: Any = None
        self._done = False

    @property
    def jobs(self) -> int:
        return len(self._instances)

    @property
    def decision(self) -> PlanDecision:
        return self._estimate.decision

    def wait(self) -> Any:
        if self._done:
            return self._result
        out: List[Any] = []
        for inst, args in zip(self._instances, self._args):
            data, sel = self.session._run_reliable(
                self.job, inst, args, self._pol, self._retry,
                list(self._sel))
            # job k+1 starts from the post-recovery selection: a failover
            # or degradation carries forward instead of re-tripping
            self._sel = list(sel)
            out.append(data)
        self._result = out if self._multi else out[0]
        self._done = True
        return self._result

    def explain(self) -> Explain:
        return Explain(estimate=self._estimate, stats=self.session.stats,
                       jobs=self.jobs, wall_s=None)


class GraphHandle:
    """An in-flight dependency graph (:meth:`Session.submit_graph`).

    One :class:`~repro_torch.core.offload.JobHandle` per node, issued by the
    scoreboard in dependency order with producer results forwarded
    device-to-device.  ``wait()`` retires every node (completion
    doorbells only) and fetches just the *fetch* nodes' results — the
    sinks by default — keyed by node name (or index when unnamed);
    intermediate results never cross the host link, which the owning
    plans' ``stats.d2h_bytes`` counters prove exactly.  ``result(node)``
    fetches any single node on demand.  Both are idempotent.

    ``forwarded`` maps each dataflow edge ``(producer, consumer,
    operand)`` to its logical d2d byte count (0 for a same-sharding
    alias or rename copy — no fabric edge crossed).
    """

    def __init__(self, nodes: Sequence[GraphNode], sb: Scoreboard,
                 handles: List[JobHandle], fetch: List[int],
                 forwarded: Dict[Tuple[int, int, str], int],
                 window_stalls: int):
        self.nodes = list(nodes)
        self._sb = sb
        self._handles = handles
        self._fetch = fetch
        self.forwarded = forwarded
        self.window_stalls = window_stalls
        self._keys: List[Union[int, str]] = [
            nd.name if nd.name is not None else i
            for i, nd in enumerate(self.nodes)]
        self._results: Optional[Dict[Union[int, str], Any]] = None
        #: advisory OFLP1## perf findings (graph submitted with lint=True)
        self.findings: List[Any] = []

    @property
    def issue_order(self) -> List[int]:
        """The order the scoreboard actually issued nodes in."""
        return list(self._sb.issue_order)

    @property
    def max_inflight(self) -> int:
        return self._sb.max_inflight

    def _node_index(self, node: Union[int, str]) -> int:
        if isinstance(node, str):
            for i, nd in enumerate(self.nodes):
                if nd.name == node:
                    return i
            raise GraphError(f"unknown node name {node!r}")
        idx = int(node)
        if not 0 <= idx < len(self.nodes):
            raise GraphError(
                f"node index {idx} outside [0, {len(self.nodes)})")
        return idx

    def _retire_all(self) -> None:
        """Retire every node (completion only, no result fetch).

        Tolerant in shape: a :class:`CompletionTimeout` on one node
        still retires the rest (abandoning them would leak their
        completion-unit copies), then the first fault re-raises.
        """
        fault: Optional[CompletionTimeout] = None
        for i, h in enumerate(self._handles):
            try:
                h.retire()
            except CompletionTimeout as exc:
                if fault is None:
                    fault = exc
            if self._sb.state[i] == ISSUED:
                self._sb.retire(i)
        if fault is not None:
            raise fault

    def wait(self) -> Dict[Union[int, str], Any]:
        """Retire the whole graph; fetch and return the fetch nodes'
        results, keyed by node name (or index when unnamed)."""
        if self._results is not None:
            return dict(self._results)
        self._retire_all()
        self._results = {self._keys[i]: self._handles[i].wait()
                         for i in self._fetch}
        return dict(self._results)

    def result(self, node: Union[int, str]) -> Any:
        """Fetch one node's result by name or index (idempotent; counts
        its payload into the owning plan's ``d2h_bytes`` on first
        fetch)."""
        return self._handles[self._node_index(node)].wait()


class Session:
    """The unified offload front door: typed policies, one submit path.

    A session owns one :class:`OffloadRuntime` per distinct
    :class:`OffloadConfig` a policy implies (multicast and baseline
    submits may share a session), a planner, and the pipelined stream
    state that makes successive single submits overlap.  ``policy``
    (default :data:`~repro_torch.core.policy.AUTO`) is the session default;
    every ``submit``/``estimate`` accepts a per-call override.

    ``device=None`` means the card (``resolve_device``: raises when no
    CUDA device is present); ``num_clusters`` sizes the window of logical
    clusters (Occamy's 32 by default).  The reference takes a device list
    instead, one device per cluster.  ``lease=`` binds a fabric lease's
    window, ``runtime=`` adopts an existing runtime.
    """

    def __init__(self, device: Union[None, str, torch.device] = None, *,
                 num_clusters: Optional[int] = None,
                 lease: Optional[ClusterLease] = None,
                 policy: OffloadPolicy = AUTO,
                 n_units: int = 4,
                 params: OccamyParams = DEFAULT_PARAMS,
                 planner: Optional[Planner] = None,
                 runtime: Optional[OffloadRuntime] = None,
                 faults: Optional[FaultInjector] = None,
                 verify: bool = True,
                 lint: bool = False,
                 diag_limit: int = 256):
        own = device is not None or num_clusters is not None
        if runtime is not None and own:
            raise ValueError("give a device or a runtime, not both")
        if lease is not None and (own or runtime is not None):
            raise ValueError("give a lease or a device/runtime, not both")
        if not isinstance(policy, OffloadPolicy):
            raise TypeError(f"policy must be an OffloadPolicy, got "
                            f"{type(policy).__name__}")
        self.policy = policy
        self.n_units = n_units
        self.verify = bool(verify)
        self.lint = bool(lint)
        self.params = params
        self.planner = planner or Planner(params)
        self._faults = faults
        self._health = SessionHealth()
        self._runtimes: Dict[OffloadConfig, OffloadRuntime] = {}
        self._closed = False
        self._suspended = False       # lease preempted, awaiting re-place
        self._preempt_snaps: List[Tuple] = []
        self._drain_deadline = 0.0    # model drain budget of the last suspend
        if lease is not None:
            # the session binds the lease's fabric window, not the whole
            # fabric: submits select within it, plans/trees key on its
            # global cluster ids, close() returns it to the scheduler
            self._device = lease.device
            self._cluster_ids: Tuple[int, ...] = tuple(lease.clusters)
            self._lease: Optional[ClusterLease] = lease
            if lease.scheduler is not None:
                # register for failover callbacks: fail_clusters() rebinds
                # this session onto the replacement window in place
                lease.scheduler._bind_session(lease, self)
        elif runtime is not None:
            self._device = runtime.device
            self._cluster_ids = tuple(runtime.cluster_ids)
            self._lease = None
            if faults is not None:
                runtime.fault_injector = faults
            self._runtimes[self._cfg_key(runtime.config)] = runtime
        else:
            # the card unless the caller asks for the CPU (raises without
            # one); the window is num_clusters logical clusters
            self._device = resolve_device(device)
            self._cluster_ids = tuple(range(
                num_clusters if num_clusters is not None
                else DEFAULT_PARAMS.num_clusters))
            self._lease = None
        self._streams: Dict[Tuple, OffloadStream] = {}
        self._fused_inflight: Deque[FusedHandle] = collections.deque()
        self._graphs: List["GraphHandle"] = []
        # estimates are deterministic per (job, selection, batch, policy):
        # cache them so warm submits pay no model arithmetic
        self._est_cache: Dict[Tuple, Estimate] = {}
        # perf-lint findings are deterministic over the same key
        self._lint_cache: Dict[Tuple, List[Any]] = {}
        # verify warnings + lint findings land here, ring-buffered so a
        # long-lived serve loop holds memory flat (diag_limit caps it)
        self._diags = DiagnosticsLog(diag_limit)
        # stage() residency ledger for the OFLP106 pass: (job, selection)
        # -> staging cycles paid and how many resident submits reused it
        self._staged_residency: Dict[Tuple, Dict[str, Any]] = {}

    @property
    def device(self) -> torch.device:
        """The device whose logical clusters this session dispatches to."""
        return self._device

    @property
    def num_clusters(self) -> int:
        """The size of the session's cluster window."""
        return len(self._cluster_ids)

    @property
    def diagnostics(self) -> "DiagnosticsLog":
        """The session's bounded diagnostics table: the most recent
        ``diag_limit`` verify warnings and perf-lint findings
        (:class:`~repro_torch.analysis.diagnostics.DiagnosticsLog`), with
        ``total``/``dropped`` counters that never lose count."""
        return self._diags

    @property
    def lease(self) -> ClusterLease:
        """The fabric window this session owns.  A session constructed
        the pre-scheduler way (device / runtime / default) reports its
        whole window as a synthesized one-tenant lease — the legacy
        whole-fabric path *is* the single-tenant special case."""
        if self._lease is not None:
            return self._lease
        # the descriptor names the cluster *set*; an adopted runtime may
        # order its window arbitrarily (device i <-> cluster_ids[i])
        return ClusterLease(lease_id=0, tenant="default",
                            clusters=tuple(sorted(self._cluster_ids)))

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Drain in-flight work and release the lease (idempotent).

        After ``close()`` every submit/stage/estimate raises
        :class:`RuntimeError` — a scheduler may have re-leased the
        window to another tenant."""
        if self._closed:
            return
        self.drain()
        self._closed = True
        if self._lease is not None and self._lease.scheduler is not None:
            self._lease.scheduler._unbind_session(self._lease)
            if self._lease.active:
                # already-released (or externally resized) leases are left
                # alone — close() is cleanup, not a second release
                self._lease.release()

    def _check_open(self, op: str) -> None:
        if self._closed:
            raise RuntimeError(
                f"{op} on a closed session (its lease over clusters "
                f"{self._cluster_ids} was released)")
        if self._suspended:
            raise RuntimeError(
                f"{op} on a suspended session: its lease was preempted "
                "and is queued for re-placement (resident operands are "
                "snapshotted and restage on resume)")

    # -- plumbing -----------------------------------------------------------

    @staticmethod
    def _cfg_key(cfg: OffloadConfig) -> OffloadConfig:
        """Runtime-map key: the session passes the staging mode on every
        stage call, so a runtime's staging *default* must not split the
        map (an adopted runtime with staging=TREE still backs DIRECT
        submits and vice versa)."""
        return dataclasses.replace(cfg, staging=Staging.DIRECT)

    def _runtime_for(self, policy: OffloadPolicy) -> OffloadRuntime:
        cfg = OffloadConfig(info_dist=policy.info_dist,
                            completion=policy.completion,
                            donate_operands=policy.donate_operands)
        return self._runtime_from_cfg(cfg)

    def _runtime_from_cfg(self, cfg: OffloadConfig) -> OffloadRuntime:
        key = self._cfg_key(cfg)
        rt = self._runtimes.get(key)
        if rt is None:
            rt = OffloadRuntime(self._device, config=cfg,
                                n_units=self.n_units,
                                cluster_ids=self._cluster_ids,
                                fault_injector=self._faults)
            self._runtimes[key] = rt
        return rt

    @staticmethod
    def _sel_key(n, request, clusters) -> Tuple:
        if request is not None:
            return ("request", request.addr, request.mask)
        if clusters is not None:
            return ("clusters", tuple(sorted(clusters)))
        return ("n", n)

    def _selection_ids(self, policy: OffloadPolicy, n, request, clusters
                       ) -> Tuple[List[int], Optional[int]]:
        rt = self._runtime_for(policy)
        if n is None and request is None and clusters is None:
            n = len(self._cluster_ids)
        _, ids = rt.select_clusters(
            n=n if (request is None and clusters is None) else None,
            request=request, clusters=clusters)
        return list(ids), n

    def _stream_for(self, job: PaperJob, policy: OffloadPolicy,
                    decision: PlanDecision, n, request, clusters
                    ) -> OffloadStream:
        rt = self._runtime_for(policy)
        key = (job.spec.name, self._sel_key(n, request, clusters),
               rt.config, decision.staging, decision.window, policy.depth)
        stream = self._streams.get(key)
        if stream is None:
            stream = OffloadStream(rt, job, n=n, request=request,
                                   clusters=clusters, depth=policy.depth,
                                   window=decision.window,
                                   staging=decision.staging, _warn=False)
            self._streams[key] = stream
        return stream

    # -- the submit path ----------------------------------------------------

    def submit(self, job: PaperJob,
               operands: Union[Mapping[str, np.ndarray],
                               Sequence[Mapping[str, np.ndarray]],
                               Residency],
               *,
               policy: Optional[OffloadPolicy] = None,
               job_args: Optional[Union[np.ndarray,
                                        Sequence[np.ndarray]]] = None,
               n: Optional[int] = None,
               request: Optional[mc.MulticastRequest] = None,
               clusters: Optional[Sequence[int]] = None,
               after: Sequence[Any] = (),
               lint: Optional[bool] = None) -> SessionHandle:
        """Dispatch ``job`` under a typed policy — the one submit path.

        ``after`` adds ordering edges on in-flight handles
        (:class:`SessionHandle`, :class:`GraphHandle`, or raw job
        handles): a predecessor sharing clusters with this selection is
        ordered for free (per-device launch order serializes on the
        shared lease), a disjoint one gets a conservative completion
        barrier — its doorbell is collected (``retire()``), never its
        result payload.  For dataflow (consuming a predecessor's
        *result*), use :meth:`submit_graph`.

        ``operands`` selects the shape of the submit:

        * a dict — one job instance (phase-E staged per the decision's
          staging mode, pipelined against other in-flight submits of the
          same (job, selection) pair when the window is open);
        * a sequence of dicts — B(atch) instances; the planner (or the
          pinned policy) fuses them into ⌈batch/fuse⌉ launches and
          pipelines those through the window;
        * ``Residency.RESIDENT`` — redispatch the plan's resident
          buffers with zero staging (``policy.fuse`` > 1 selects the
          resident *fused* batch).

        Returns a :class:`SessionHandle`; ``wait()`` yields the result
        (dict submit) or per-job results in submit order (list submit),
        ``explain()`` the predicted-vs-measured breakdown.

        ``lint=True`` (or ``Session(lint=True)``) additionally runs the
        performance linter (:mod:`repro_torch.analysis.perflint`) over the
        submit: advisory ``OFLP1##`` findings — never a gate — land in
        :attr:`Session.diagnostics`, on ``handle.findings``, and in
        ``handle.explain()``.
        """
        self._check_open("submit")
        pol = self.policy if policy is None else policy
        if pol.retry is not None:
            # reliable dispatch is synchronous: barrier every predecessor
            for h in after:
                for jh in self._job_handles_of(h):
                    jh.retire()
            return self._submit_reliable(job, operands, pol, job_args,
                                         n, request, clusters)
        resident = isinstance(operands, Residency)
        if resident:
            if operands is not Residency.RESIDENT:
                raise ValueError(
                    "pass an operand dict, a sequence of them, or "
                    "Residency.RESIDENT")
            # a resident submit stages nothing: drop any pinned staging
            # along with the residency pin, so a policy whose staging
            # primed the buffers (e.g. TREE via sess.stage) is reusable
            # here instead of tripping the RESIDENT+staging contradiction
            pol = pol.pinned(residency=Residency.RESIDENT, staging=None)
        elif isinstance(operands, str):
            raise TypeError(
                "the session API takes typed operands: an operand dict, a "
                "sequence of them, or Residency.RESIDENT (the legacy "
                "'resident' string lives on offload() only)")
        multi = (not resident
                 and isinstance(operands, (list, tuple)))
        if multi and not operands:
            raise ValueError("empty instance list")
        if not multi and not resident and not isinstance(operands, Mapping):
            raise TypeError(f"unsupported operands {type(operands)!r}")
        if self.verify and not resident:
            self._verify_submit(job, operands, n, request, clusters)

        ids, n = self._selection_ids(pol, n, request, clusters)
        if after:
            mine = set(ids)
            for h in after:
                for jh in self._job_handles_of(h):
                    if not (set(jh.cluster_ids) & mine):
                        jh.retire()   # disjoint: completion barrier
        batch = (len(operands) if multi
                 else (pol.fuse or 1) if resident else 1)
        first_ops = (operands[0] if multi
                     else None if resident else operands)
        if resident:
            entry = self._staged_residency.get((job.spec.name, tuple(ids)))
            if entry is not None:
                entry["uses"] += 1
        cache_key = (job.spec.name, tuple(ids), batch, pol)
        est = self._est_cache.get(cache_key)
        if est is None:
            est = estimate(job, clusters=ids, batch=batch, policy=pol,
                           n_units=self.n_units, params=self.params,
                           operands=first_ops, planner=self.planner)
            self._est_cache[cache_key] = est
        findings = self._lint_submit(
            job, first_ops, pol, batch, ids,
            self.lint if lint is None else lint, cache_key)
        self._slo_gate(est, batch)
        decision = est.decision
        rt = self._runtime_for(pol)
        t0 = time.monotonic()
        parts: List[Tuple[str, Any]] = []
        plans: List[Any] = []

        if resident and decision.fuse > 1:
            h = rt._offload_fused(job, Residency.RESIDENT,
                                  job_args=_one_args(job_args),
                                  n=n, request=request, clusters=clusters,
                                  batch=decision.fuse,
                                  staging=decision.staging)
            parts.append(("fused", h))
            plans.append(self._last_fused_plan(rt, job, decision.fuse, ids))
        elif not multi:
            stream = self._stream_for(job, pol, decision, n, request,
                                      clusters)
            h = stream.submit(
                Residency.RESIDENT if resident else operands,
                _one_args(job_args))
            parts.append(("single", h))
            plans.append(stream.plan)
        else:
            B = decision.fuse
            args_list = _args_list(job_args, batch)
            i = 0
            if B > 1:
                # like OffloadStream, the in-flight window is capped by
                # the runtime's completion-unit copies: launch k and
                # launch k + n_units share a unit, so k must have
                # completed first
                window = min(decision.window, rt.unit.n_units)
                while batch - i >= B:
                    group = list(operands[i:i + B])
                    gargs = _stack_args(args_list, i, B)
                    while (len(self._fused_inflight) >= window
                           and self._fused_inflight):
                        self._fused_inflight.popleft().wait()
                    h = rt._offload_fused(job, group, job_args=gargs,
                                          n=n, request=request,
                                          clusters=clusters,
                                          staging=decision.staging)
                    self._fused_inflight.append(h)
                    parts.append(("fused", h))
                    i += B
                if parts:
                    plans.append(self._last_fused_plan(rt, job,
                                                       decision.fuse, ids))
            if i < batch:
                # remainder (or the unfused path): pipelined singles
                stream = self._stream_for(job, pol, decision, n, request,
                                          clusters)
                for k in range(i, batch):
                    h = stream.submit(
                        operands[k],
                        args_list[k] if args_list is not None else None)
                    parts.append(("single", h))
                plans.append(stream.plan)

        return SessionHandle(self, job, est, parts, multi or
                             (resident and decision.fuse > 1), plans, t0,
                             findings=findings)

    def _lint_submit(self, job: PaperJob, first_ops: Any,
                     pol: OffloadPolicy, batch: int, ids: Sequence[int],
                     lint: bool, cache_key: Tuple) -> List[Any]:
        """Run (and cache) the perf linter for one submit; findings are
        recorded in the session diagnostics log the first time only."""
        if not lint:
            return []
        findings = self._lint_cache.get(cache_key)
        if findings is None:
            from repro_torch.analysis import perflint
            findings = perflint.lint(
                job, first_ops, policy=pol, batch=batch,
                clusters=list(ids), allowed=self._cluster_ids,
                n_units=self.n_units, params=self.params,
                planner=self.planner)
            self._lint_cache[cache_key] = findings
            self._diags.record(f.diagnostic for f in findings)
        return findings

    def _verify_submit(self, job: PaperJob, operands: Any, n, request,
                       clusters) -> None:
        """The static pre-dispatch gate (``Session(verify=False)`` skips).

        Use-after-donate (OFL003) raises the historical
        :class:`~repro_torch.core.offload.DonatedOperandError` — now *before*
        any staging instead of at wait time; other error diagnostics
        (sharding mismatch OFL006, inactive lease OFL011) raise
        :class:`~repro_torch.analysis.verifier.VerificationError`.
        """
        from repro_torch.analysis import verifier as _verifier
        from repro_torch.analysis.diagnostics import Severity
        if n is None and request is None and clusters is None:
            n = len(self._cluster_ids)
        diags = _verifier.verify(job, lease=self._lease, operands=operands,
                                 n=None if request is not None else n,
                                 clusters=clusters, n_units=self.n_units)
        # every diagnostic — warnings included — lands in the session's
        # ring-buffered log (they used to be computed then discarded)
        self._diags.record(diags)
        errors = [d for d in diags if d.severity is Severity.ERROR]
        if not errors:
            return
        donated = [d for d in errors if d.code == "OFL003"]
        if donated:
            from repro_torch.core.offload import DonatedOperandError
            # the diagnostic message is "<what> was deleted by ...": hand
            # the <what> back to the historical exception type
            what = donated[0].message.split(" was deleted by ")[0]
            raise DonatedOperandError(what)
        raise _verifier.VerificationError(errors)

    @staticmethod
    def _job_handles_of(h: Any) -> List[JobHandle]:
        """Flatten an ``after=`` predecessor to its raw job handles."""
        if isinstance(h, SessionHandle):
            return [p for _, p in h._parts]
        if isinstance(h, GraphHandle):
            return list(h._handles)
        if isinstance(h, JobHandle):
            return [h]
        raise TypeError(
            f"after= takes session/graph/job handles, got "
            f"{type(h).__name__}")

    # -- dependent job graphs -----------------------------------------------

    def submit_graph(self, nodes: Sequence[GraphNode], *,
                     policy: Optional[OffloadPolicy] = None,
                     lint: Optional[bool] = None) -> GraphHandle:
        """Dispatch a DAG of dependent jobs like an out-of-order core.

        ``nodes`` are :class:`~repro_torch.core.scoreboard.GraphNode`\\ s whose
        operands may be host arrays, ``Residency.RESIDENT``, or
        :class:`~repro_torch.core.scoreboard.Ref`\\ s to earlier nodes'
        results; ``after=`` entries add pure ordering edges.  The
        scoreboard (Active List + Integer Queue) issues every node whose
        producers have *issued* — async dispatch chains the data
        device-side, so independent sub-DAGs issue concurrently across
        the in-flight window (and across leases, for nodes carrying
        ``session=`` of another session).  Producer results are
        forwarded device-to-device to each consumer's sharding
        (:meth:`DispatchPlan.forward <repro_torch.core.offload.DispatchPlan.forward>`
        — alias, rename copy, reshard, or fan-out tree); they are never
        fetched to the host unless the node is a *fetch* node (a sink,
        or ``fetch=True``).  WAR/WAW hazards against resident buffers
        and donating consumers are broken by renaming: graph staging
        always lands in fresh buffers.

        Returns a :class:`GraphHandle`; its ``wait()`` yields the fetch
        nodes' results keyed by name (or index).
        """
        self._check_open("submit_graph")
        pol = self.policy if policy is None else policy
        if pol.retry is not None:
            raise GraphError(
                "graph submits do not ride the retry/deadline ladder; "
                "drop policy.retry (wrap individual submits for "
                "fault-tolerant dispatch)")
        nodes = list(nodes)
        for nd in nodes:
            if not isinstance(nd, GraphNode):
                raise GraphError(
                    f"submit_graph takes GraphNode entries, got "
                    f"{type(nd).__name__}")
        if self.verify:
            from repro_torch.analysis import verifier as _verifier
            diags = _verifier.verify_graph(
                nodes, policy=pol, n_units=self.n_units,
                default_width=len(self._cluster_ids), session=self)
            self._diags.record(diags)
            _verifier.raise_errors(diags)
        findings: List[Any] = []
        if self.lint if lint is None else lint:
            from repro_torch.analysis import perflint
            findings = perflint.lint_graph(
                nodes, policy=pol, n_units=self.n_units,
                default_width=len(self._cluster_ids),
                allowed=self._cluster_ids, params=self.params,
                planner=self.planner)
            self._diags.record(f.diagnostic for f in findings)
        deps, data_edges = resolve_graph(nodes)
        sb = Scoreboard(deps)
        targets: List["Session"] = []
        rts: List[OffloadRuntime] = []
        sel_kwargs: List[Dict[str, Any]] = []
        for i, nd in enumerate(nodes):
            t = nd.session if nd.session is not None else self
            if not isinstance(t, Session):
                raise GraphError(
                    f"node {i}: session= must be a Session, got "
                    f"{type(t).__name__}")
            t._check_open(f"submit_graph node {i}")
            _, n_eff = t._selection_ids(pol, nd.n, nd.request, nd.clusters)
            targets.append(t)
            rts.append(t._runtime_for(pol))
            sel_kwargs.append(dict(n=n_eff, request=nd.request,
                                   clusters=nd.clusters))
        via = pol.staging          # None -> the runtime's substrate default
        windows: Dict[int, InflightWindow] = {}
        handles: List[Optional[JobHandle]] = [None] * len(nodes)
        forwarded: Dict[Tuple[int, int, str], int] = {}

        def _drain(entry: Tuple[int, JobHandle]) -> None:
            j, h = entry
            h.retire()
            if sb.state[j] == ISSUED:
                sb.retire(j)

        while not sb.all_issued:
            i = sb.ready()[0]              # Integer Queue, age order
            nd, rt = nodes[i], rts[i]
            win = windows.get(id(rt))
            if win is None:
                limit = (pol.window if pol.window is not None
                         else rt.unit.n_units)
                win = InflightWindow(max(1, min(limit, rt.unit.n_units)))
                windows[id(rt)] = win
            job_args = np.asarray(
                nd.job_args if nd.job_args is not None
                else np.ones((8,), dtype=np.float64), dtype=np.float64)
            if isinstance(nd.operands, Residency):
                if nd.operands is not Residency.RESIDENT:
                    raise GraphError(
                        f"node {i}: pass an operand dict or "
                        "Residency.RESIDENT")
                plan = rt.plan(nd.job, operands=None,
                               args_shape=job_args.shape, **sel_kwargs[i])
                win.make_room(_drain)
                args_dev = plan.stage_args(job_args, via=via)
                staged = plan.resident_operands()
                handle = rt._launch(plan, args_dev, staged)
            else:
                ops = dict(nd.operands)
                sources = {}
                for src, op_name in data_edges[i]:
                    # the producer's (possibly still in-flight) output —
                    # stream order chains it on the device
                    ops[op_name] = handles[src].result
                    sources[op_name] = handles[src].placement
                # shapes/dtypes only: a forwarded tensor is never copied
                # to the host here
                meta = {
                    k: (np.broadcast_to(np.zeros((), numpy_dtype(v.dtype)),
                                        tuple(v.shape))
                        if isinstance(v, torch.Tensor) else np.asarray(v))
                    for k, v in ops.items()}
                plan = rt.plan(nd.job, operands=meta,
                               args_shape=job_args.shape, **sel_kwargs[i])
                win.make_room(_drain)
                args_dev = plan.stage_args(job_args, via=via)
                staged, fwd = plan.stage_renamed(ops, via=via,
                                                 sources=sources)
                for src, op_name in data_edges[i]:
                    forwarded[(src, i, op_name)] = fwd.get(op_name, 0)
                handle = rt._launch(plan, args_dev, staged,
                                    consumed_resident=False)
            handles[i] = handle
            sb.issue(i)
            win.push((i, handle))

        sinks = set(sb.sinks())
        fetch = [i for i, nd in enumerate(nodes)
                 if (nd.fetch if nd.fetch is not None else i in sinks)]
        gh = GraphHandle(nodes, sb, handles, fetch, forwarded,
                         sum(w.stalls for w in windows.values()))
        gh.findings = findings
        for t in {id(t): t for t in [self] + targets}.values():
            t._graphs.append(gh)
        return gh

    # -- the fault-tolerant path --------------------------------------------

    def _submit_reliable(self, job: PaperJob, operands, pol: OffloadPolicy,
                         job_args, n, request, clusters) -> "ReliableHandle":
        """Route a retrying submit: deadline-checked synchronous singles.

        The reliable path snapshots host operands so any attempt can be
        replayed bit-identically — ``Residency.RESIDENT`` (device-only
        buffers) therefore cannot ride it."""
        retry = pol.retry
        assert retry is not None
        if isinstance(operands, (Residency, str)):
            raise ValueError(
                "retry needs host operand snapshots to replay an attempt; "
                "submit operand dicts, not Residency.RESIDENT")
        multi = isinstance(operands, (list, tuple))
        if multi and not operands:
            raise ValueError("empty instance list")
        instances = (
            [dict(o) for o in operands] if multi else [dict(operands)])
        args_list = _args_list(job_args, len(instances))
        # reliable dispatch is synchronous singles: a deadline race needs
        # one completion per attempt, not a fused/pipelined batch
        rpol = pol.pinned(
            fuse=1, window=1,
            staging=pol.staging if pol.staging is not None
            else Staging.DIRECT)
        ids, _ = self._selection_ids(rpol, n, request, clusters)
        est = self._reliable_est(job, ids, rpol)
        self._slo_gate(est, len(instances))
        return ReliableHandle(self, job, est, instances, args_list,
                              rpol, retry, multi, ids)

    def _reliable_est(self, job: PaperJob, sel_glob: Sequence[int],
                      rpol: OffloadPolicy) -> Estimate:
        key = ("reliable", job.spec.name, tuple(sel_glob), rpol)
        est = self._est_cache.get(key)
        if est is None:
            est = estimate(job, clusters=list(sel_glob), batch=1,
                           policy=rpol, n_units=self.n_units,
                           params=self.params, planner=self.planner)
            self._est_cache[key] = est
        return est

    def _rel_ids(self, globs: Sequence[int]) -> List[int]:
        """Global fabric ids -> window-relative indices (the selection
        vocabulary ``OffloadRuntime.select_clusters`` takes)."""
        idx = {c: i for i, c in enumerate(self._cluster_ids)}
        return [idx[c] for c in globs]

    def _run_reliable(self, job: PaperJob, inst: Mapping[str, np.ndarray],
                      args: Optional[np.ndarray], rpol: OffloadPolicy,
                      retry: RetryPolicy, sel_glob: List[int]
                      ) -> Tuple[Any, List[int]]:
        """One job instance through the deadline/escalation machinery.

        Returns ``(result, selection)`` — the selection the job finally
        ran on, so the caller can carry a failover forward.  All deadline
        arithmetic is in the §6 model's virtual-cycle domain: recovery is
        deterministic, never wallclock-dependent."""
        known_dead: set = set()
        attempt = 0
        while True:
            # re-fetched every attempt: a failover swaps the runtimes out
            rt = self._runtime_for(rpol)
            base = self._reliable_est(job, sel_glob, rpol).job_cycles
            deadline = deadline_cycles(base, retry, attempt)
            try:
                handle = rt.offload(job, dict(inst), job_args=args,
                                    clusters=self._rel_ids(sel_glob))
                data = handle.wait()
            except CompletionTimeout as exc:
                self._health.deadline_trips += 1
                self._health.virtual_cycles += deadline
                attempt += 1
                if attempt >= retry.max_attempts:
                    self._health.jobs_failed += 1
                    raise FaultError(
                        f"job {job.spec.name!r} failed after {attempt} "
                        f"attempts on clusters {tuple(sel_glob)} "
                        f"({exc.missing} arrivals missing)") from exc
                known_dead |= self._probe_dead(rt, retry, exc)
                sel_glob = self._next_selection(job, rpol, retry, sel_glob,
                                                known_dead)
                self._health.retries += 1
                continue
            # completed — race the deadline in the virtual-cycle domain: a
            # straggling primary that finishes past its deadline loses to
            # a backup launched *at* the deadline on a disjoint window
            inj = self._faults
            delay = (inj.delay_cycles(rt, handle.job_id)
                     if inj is not None else 0.0)
            finish = base + delay
            if finish > deadline and retry.backup:
                self._health.deadline_trips += 1
                avoid = set(known_dead)
                if inj is not None:
                    avoid |= set(inj.dead_clusters)
                backup_sel = self._disjoint_window(sel_glob, avoid)
                if backup_sel is not None:
                    try:
                        bh = rt.offload(job, dict(inst), job_args=args,
                                        clusters=self._rel_ids(backup_sel))
                        bdata = bh.wait()
                        bdelay = (inj.delay_cycles(rt, bh.job_id)
                                  if inj is not None else 0.0)
                        # the backup launches when the primary's deadline
                        # expires; first completion wins
                        b_finish = deadline + base + bdelay
                        self._health.backups += 1
                        if b_finish < finish:
                            data, finish = bdata, b_finish
                    except CompletionTimeout:
                        pass   # primary already has the result in hand
            self._health.virtual_cycles += finish
            self._health.jobs_ok += 1
            return data, sel_glob

    def _probe_dead(self, rt: OffloadRuntime, retry: RetryPolicy,
                    exc: CompletionTimeout) -> set:
        """Localize dead clusters after a trip.

        The completion unit already says *how many* arrivals are missing
        (``exc.missing`` — the §4.3 machinery as a failure detector);
        bisection probes with a small AXPY narrow down *which* clusters.
        A probe group whose miss count equals its size is entirely dead —
        the shortcut that makes localization O(log n) per dead cluster.
        Without an injector there is nothing to probe against: the whole
        selection is conservatively suspect."""
        inj = self._faults
        if inj is None:
            return set(exc.clusters)
        probe_job = make_axpy(PROBE_N)
        dead: set = set()
        stack: List[List[int]] = [sorted(exc.clusters)]
        while stack:
            grp = stack.pop()
            if not grp:
                continue
            self._health.probes += 1
            p_est = amodel.predict_total_v2(probe_job.spec, len(grp),
                                            self.params)
            ops, _ = probe_job.make_instance(0)
            try:
                rt.offload(probe_job, ops,
                           clusters=self._rel_ids(grp)).wait()
                self._health.virtual_cycles += p_est
            except CompletionTimeout as pe:
                # a failed probe costs its own deadline, not its estimate
                self._health.virtual_cycles += retry.deadline_factor * p_est
                if pe.missing >= len(grp) or len(grp) == 1:
                    dead.update(grp)
                else:
                    mid = len(grp) // 2
                    stack.append(grp[:mid])
                    stack.append(grp[mid:])
        return dead

    def _disjoint_window(self, sel_glob: Sequence[int],
                         avoid: set) -> Optional[List[int]]:
        """An equal-size healthy window in the lease, disjoint from the
        current selection (rung 2 of the ladder; the selection is later
        greedily covered by address-mask subcube requests)."""
        want = len(sel_glob)
        used = set(sel_glob) | set(avoid)
        pool = [c for c in self._cluster_ids if c not in used]
        return pool[:want] if len(pool) >= want else None

    def _next_selection(self, job: PaperJob, rpol: OffloadPolicy,
                        retry: RetryPolicy, sel_glob: List[int],
                        known_dead: set) -> List[int]:
        """The escalation ladder: where does the next attempt run?

        1. no dead cluster in the selection → transient fault (lost
           arrival, stall): resubmit in place;
        2. a disjoint equal-size healthy window inside the lease → the
           backup window;
        3. ``FabricScheduler.fail_clusters`` → full lease failover (the
           scheduler rebinds this session onto a healthy window, restaging
           resident operands); without a scheduler, degrade to the largest
           power-of-two healthy prefix of the window.
        """
        if not (set(sel_glob) & known_dead):
            return sel_glob                      # rung 1: resubmit in place
        if retry.backup:
            backup = self._disjoint_window(sel_glob, known_dead)
            if backup is not None:
                self._health.backups += 1        # rung 2: backup window
                return backup
        sched = self._lease.scheduler if self._lease is not None else None
        if retry.failover and sched is not None:  # rung 3: lease failover
            dead_here = sorted(known_dead & set(self._cluster_ids))
            if dead_here:
                sched.fail_clusters(dead_here)   # -> self._rebind(...)
            if self._closed or self._lease is None:
                self._health.jobs_failed += 1
                raise FaultError(
                    f"lease lost: no healthy window to fail over to "
                    f"(dead clusters {sorted(known_dead)})")
            healthy = [c for c in self._cluster_ids if c not in known_dead]
        else:
            # no scheduler (or failover disabled): degrade in the window
            healthy = [c for c in self._cluster_ids if c not in known_dead]
        n_ok = min(len(sel_glob), len(healthy))
        if n_ok == 0:
            self._health.jobs_failed += 1
            raise FaultError(
                f"no healthy clusters left in window {self._cluster_ids} "
                f"(dead: {sorted(known_dead)})")
        # power-of-two selections keep every job's shard split valid
        n_sel = 1 << (n_ok.bit_length() - 1)
        if n_sel < len(sel_glob):
            self._health.degraded += 1
        return healthy[:n_sel]

    def _snapshot_resident(self) -> List[Tuple]:
        """Host-side snapshots of every fully-resident plan — the
        failover/preemption snapshot path.  Each entry carries what a
        restage needs: the job, the host operand dict, the
        window-relative placement, the staging strategy the operands
        originally rode, and the runtime config."""
        old_ids = list(self._cluster_ids)
        snapshots = []
        for rt in self._runtimes.values():
            for plan in rt._plans.values():
                src = dict(plan._resident_src)
                if len(src) != len(plan.op_meta):
                    continue    # nothing (or only partial) residency
                rel = [old_ids.index(c) for c in plan.cluster_ids]
                snapshots.append((plan.job, src, rel, plan._staged_via,
                                  plan.fuse, plan.args_shape, rt.config))
        return snapshots

    def _drop_runtimes(self) -> None:
        self._runtimes = {}
        self._streams = {}
        self._fused_inflight = collections.deque()
        self._est_cache = {}
        self._lint_cache = {}
        # the failover window invalidates the ledger's selections
        self._staged_residency = {}

    def _restage(self, snapshots: List[Tuple]) -> int:
        """Replay resident snapshots onto the current window through the
        same staging strategy they originally rode (a tree-staged weight
        re-crosses the host link once, to the new root).  Returns the
        number of operands restaged."""
        restaged = 0
        for job, src, rel, via, fuse, args_shape, cfg in snapshots:
            if max(rel) >= len(self._cluster_ids):
                continue        # shrunken window: this placement is gone
            rt = self._runtime_from_cfg(cfg)
            plan = rt.plan(job, operands=src, clusters=rel,
                           args_shape=args_shape, fuse=fuse)
            plan.stage(src, _caller_owned=False, via=via)
            restaged += len(src)
        return restaged

    def _rebind(self, new_lease: Optional[ClusterLease]) -> int:
        """Failover callback from ``FabricScheduler.fail_clusters``: move
        this session onto ``new_lease``'s window (``None`` = no healthy
        window existed; the session closes).  Returns the number of
        operands restaged."""
        self._drain_tolerant()
        if new_lease is None:
            self._closed = True
            self._lease = None
            return 0
        snapshots = self._snapshot_resident()
        self._lease = new_lease
        self._device = new_lease.device
        self._cluster_ids = tuple(new_lease.clusters)
        self._drop_runtimes()
        restaged = self._restage(snapshots)
        self._health.failovers += 1
        self._health.restages += restaged
        return restaged

    def _suspend(self, drain_deadline: float = 0.0) -> int:
        """Preemption callback from ``FabricScheduler.preempt``: drain
        the in-flight window (the victim's drain budget is the §6-model
        ``drain_deadline`` the scheduler computed; jobs that blow it trip
        the fault ladder's ``CompletionTimeout`` and are absorbed like
        any drain), snapshot resident state on the host, drop the
        old-window runtimes, and suspend — every submit until
        :meth:`_resume` raises.  Returns the snapshot count."""
        self._drain_deadline = float(drain_deadline)
        self._drain_tolerant()
        self._preempt_snaps = self._snapshot_resident()
        self._drop_runtimes()
        self._suspended = True
        return len(self._preempt_snaps)

    def _resume(self, new_lease: ClusterLease) -> int:
        """Re-placement callback: adopt the re-granted window, restage
        the preemption snapshots through the broadcast tree they
        originally rode, and reopen for submits.  Returns the number of
        operands restaged — results after resume are bit-identical to an
        unpreempted run (``tests/test_torch_fabric.py`` asserts it)."""
        self._lease = new_lease
        self._device = new_lease.device
        self._cluster_ids = tuple(new_lease.clusters)
        self._suspended = False
        restaged = self._restage(self._preempt_snaps)
        self._preempt_snaps = []
        self._health.restages += restaged
        return restaged

    def _close_revoked(self) -> None:
        """Permanent revocation (``FabricScheduler.revoke``): the lease
        is gone and will not be re-placed."""
        self._preempt_snaps = []
        self._suspended = False
        self._closed = True
        self._lease = None

    def _inflight_launches(self) -> int:
        """Launches currently in flight across the fused deque and every
        open stream — the backlog term of the SLO backpressure model."""
        return (len(self._fused_inflight)
                + sum(len(s._inflight) for s in self._streams.values()))

    def _slo_gate(self, est: Estimate, batch: int) -> None:
        """Submit-side backpressure: when this session's lease belongs
        to a tenant with a declared SLO, predict the submit's completion
        — the in-flight backlog at the per-job pipeline period, plus the
        batch itself on top of the first-launch latency — and shed with
        a typed :class:`Overloaded` when it cannot fit, instead of
        silently deepening the pipeline."""
        lease = self._lease
        if lease is None or lease.scheduler is None:
            return
        ten = lease.scheduler.tenant(lease.tenant)
        if ten is None or ten.slo is None:
            return
        backlog = self._inflight_launches() * est.per_job_cycles
        total = (backlog + est.job_cycles
                 + est.staging_cycles.get("direct", 0.0)
                 + max(0, batch - 1) * est.per_job_cycles)
        if total > ten.slo:
            raise Overloaded(
                f"tenant {ten.name!r} slo={ten.slo:.0f} cycles < predicted "
                f"completion {total:.0f} (backlog {backlog:.0f}); submit "
                "shed — drain() and retry",
                retry_after_cycles=backlog)

    def _drain_tolerant(self) -> None:
        """Drain in-flight work, absorbing completion trips (a failover
        must not abandon the other streams' handles mid-deque)."""
        while self._fused_inflight:
            try:
                self._fused_inflight.popleft().wait()
            except CompletionTimeout:
                self._health.jobs_failed += 1
        for stream in self._streams.values():
            while stream._inflight:
                try:
                    stream._inflight.popleft().wait()
                    stream._stats["drained"] += 1
                except CompletionTimeout:
                    self._health.jobs_failed += 1
        for gh in self._graphs:
            try:
                gh._retire_all()
            except CompletionTimeout:
                self._health.jobs_failed += 1
        self._graphs.clear()

    def health(self) -> SessionHealth:
        """Fault/recovery counters of this session (a snapshot)."""
        return self._health.snapshot()

    def stage(self, job: PaperJob,
              operands: Union[Mapping[str, np.ndarray],
                              Sequence[Mapping[str, np.ndarray]]],
              *,
              policy: Optional[OffloadPolicy] = None,
              n: Optional[int] = None,
              request: Optional[mc.MulticastRequest] = None,
              clusters: Optional[Sequence[int]] = None) -> PlanDecision:
        """Phase-E stage ``operands`` as the plan's *resident* buffers.

        Primes the zero-``device_put`` warm path: subsequent
        ``submit(job, Residency.RESIDENT, ...)`` calls redispatch these
        buffers.  A sequence of B dicts stages the fused (B, ...) batch
        (for resident fused redispatch under ``policy.fuse=B``).  Staging
        strategy follows the policy/planner decision; returns it.
        """
        self._check_open("stage")
        pol = self.policy if policy is None else policy
        multi = isinstance(operands, (list, tuple))
        batch = len(operands) if multi else 1
        ids, n = self._selection_ids(pol, n, request, clusters)
        first_ops = operands[0] if multi else operands
        decision = self.planner.decide(
            job, ids, batch, pol.pinned(fuse=pol.fuse or (batch if multi
                                                          else 1)),
            self.n_units, operands=first_ops)
        rt = self._runtime_for(pol)
        stacked = stack_instances(operands) if multi else dict(operands)
        plan = rt.plan(job, operands=stacked, n=n, request=request,
                       clusters=clusters,
                       args_shape=(batch, 8) if multi else (8,),
                       fuse=batch if multi else None)
        plan.stage(stacked, _caller_owned=not multi,
                   via=decision.staging)
        # OFLP106 ledger: remember what this stage cost; resident submits
        # of the same (job, selection) bump the use counter, and
        # perflint.lint_session flags entries nothing ever redispatched
        rep = self.planner.replicated_bytes(job, first_ops) * batch
        total = sum(int(np.asarray(v).nbytes)
                    for v in first_ops.values()) * batch
        cycles = (self.planner.staging_cost(rep, ids, decision.staging)
                  if rep > 0 else 0.0)
        if total > rep:   # sharded operands ride the host link once
            cycles += (self.params.dma_setup_one
                       + (total - rep) / self.params.wide_bw_bytes_per_cycle
                       + self.params.dma_latency)
        self._staged_residency[(job.spec.name, tuple(ids))] = {
            "cycles": cycles, "uses": 0, "batch": batch,
        }
        return decision

    @staticmethod
    def _last_fused_plan(rt: OffloadRuntime, job: PaperJob, fuse: int,
                         ids: Sequence[int]):
        fused = [p for k, p in rt._plans.items()
                 if k[0] == job.spec.name and k[1] == tuple(ids)
                 and k[3] == fuse]
        return fused[-1] if fused else None

    def runtime(self, policy: Optional[OffloadPolicy] = None
                ) -> OffloadRuntime:
        """The :class:`OffloadRuntime` backing ``policy`` (the session
        default when omitted) — the escape hatch to plan/trace
        introspection (``launch_trace``, ``plan``, per-plan stats)."""
        return self._runtime_for(self.policy if policy is None else policy)

    # -- prediction ---------------------------------------------------------

    def estimate(self, job: PaperJob, *,
                 batch: int = 1,
                 policy: Optional[OffloadPolicy] = None,
                 n: Optional[int] = None,
                 clusters: Optional[Sequence[int]] = None,
                 operands: Optional[Mapping[str, Any]] = None) -> Estimate:
        """Predict a submit without dispatching (see module
        :func:`estimate`); defaults to every cluster of the session.
        ``n`` beyond the session's cluster count is allowed — the model
        covers the full Occamy topology even when the window is
        smaller."""
        self._check_open("estimate")
        pol = self.policy if policy is None else policy
        if n is None and clusters is None:
            # default to the session's own fabric window, so a lease's
            # placement (quadrant structure) shapes the prediction
            clusters = list(self._cluster_ids)
        return estimate(job, n=n, clusters=clusters, batch=batch, policy=pol,
                        n_units=self.n_units, params=self.params,
                        operands=operands, planner=self.planner)

    # -- bookkeeping --------------------------------------------------------

    def drain(self) -> None:
        """Block until every in-flight submit has completed.

        Completion trips (injected faults) are absorbed into
        ``health().jobs_failed`` rather than raised: drain is cleanup,
        and a raise mid-deque would abandon the remaining handles."""
        self._drain_tolerant()

    @property
    def stats(self) -> PlanStats:
        """Aggregated dispatch counters across the session's runtimes."""
        agg = PlanStats()
        for rt in self._runtimes.values():
            agg.accumulate(rt.stats)
        return agg


def _one_args(job_args) -> Optional[np.ndarray]:
    if job_args is None:
        return None
    if isinstance(job_args, (list, tuple)):
        raise ValueError("per-job args need a list submit")
    return np.asarray(job_args)


def _args_list(job_args, batch: int) -> Optional[List[np.ndarray]]:
    if job_args is None:
        return None
    if isinstance(job_args, (list, tuple)):
        if len(job_args) != batch:
            raise ValueError(
                f"{len(job_args)} job_args for {batch} instances")
        return [np.asarray(a) for a in job_args]
    return [np.asarray(job_args)] * batch


def _stack_args(args_list: Optional[List[np.ndarray]], i: int, B: int
                ) -> Optional[np.ndarray]:
    if args_list is None:
        return None
    return np.stack(args_list[i:i + B])
