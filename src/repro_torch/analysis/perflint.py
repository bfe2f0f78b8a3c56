"""Model-driven performance linting — the §6 cost model as a compiler pass
(twin of ``repro.analysis.perflint``).

The verifier answers *"is this submission correct?"*; this module
answers the paper's other question: *"is it leaving predicted cycles on
the table?"*.  Every pass abstractly interprets a submission — a
(job, policy, selection) triple or a ``submit_graph`` node list —
against the validated cost models (``staging_model`` /
``simulate_staging``, the eq.-4 amortization terms,
``graph_critical_path`` / ``forward_model``, the multicast subcube
encoder) and emits ``OFLP1##`` findings with severity
:attr:`~repro_torch.analysis.diagnostics.Severity.PERF`:

=======  ==============================================================
OFLP101  pinned ``staging=`` slower than the model's best mode
OFLP102  batched submit pins ``fuse=`` below the model-optimal factor
OFLP103  ``window=`` pins the pipeline below the model's pick
OFLP104  a dataflow edge pays a d2d reshard on the critical path
OFLP105  the cluster selection needs >1 multicast request
OFLP106  ``Session.stage()`` residency never redispatched
OFLP107  donation disabled where fused stacked buffers die at launch
=======  ==============================================================

Each :class:`PerfFinding` carries the model-predicted cycles of the
current configuration, the cycles with the fix applied, and a
machine-applicable :class:`Fix`; :func:`apply` rewrites a policy /
node list / selection from a batch of findings, and
:func:`suggested_policy` is the one-liner for the common policy case.

PERF findings never gate a submit (``raise_errors`` raises on ERROR
only); they surface through ``Session.submit(..., lint=True)``,
``handle.explain()`` and the ``python -m repro_torch.lint`` CLI
(JSON/SARIF, baselines, suppressions).

Like the verifier, linting is advisory *static* analysis: it needs no
device and never touches the runtime.  Operands may be numpy arrays or
tensors on any device (``meta`` included): only their shapes, dtypes and
byte counts are read, never their data.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (
    Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union,
)

import numpy as np
import torch

from repro_torch.core import model as amodel
from repro_torch.core import simulator
from repro_torch.core.params import DEFAULT_PARAMS, OccamyParams
from repro_torch.core.phases import Phase
from repro_torch.core.policy import (
    AUTO, InfoDist, OffloadPolicy, Residency, Staging,
)
from repro_torch.core.scoreboard import GraphNode, Ref
from repro_torch.core.session import Planner, amortized_per_job, nbytes_of

from . import verifier as _verifier
from .diagnostics import CODES, Diagnostic, Severity

__all__ = [
    "Applied", "Fix", "PerfFinding", "apply", "dispatch_replay_cycles",
    "donation_copy_cycles", "graph_jobs", "lint", "lint_graph",
    "lint_session", "suggested_policy",
]

#: a finding must beat the baseline by this fraction of its own cost
#: (plus an absolute floor of one cycle) — the §6 model's error bar is
#: 15 %, so sub-2 % "improvements" are noise, not advice
MIN_DELTA_FRAC = 0.02

#: dispatch front-end phases replayed per extra multicast request
#: (send job information, wakeup, pointer + argument retrieval)
_REPLAY_PHASES = (Phase.A, Phase.B, Phase.C, Phase.D)


# -- records -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Fix:
    """One machine-applicable rewrite.

    ``target`` says what :func:`apply` patches: ``"policy"`` pins a
    policy field, ``"node"`` rewrites an attribute of graph node
    ``node``, ``"selection"`` replaces a submit's ``clusters=``, and
    ``"stage"`` asks the caller to drop a dead ``Session.stage()`` call
    (advice only — apply() cannot un-stage device memory).
    """

    target: str
    field: str
    value: Any
    node: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class PerfFinding:
    """One ``OFLP1##`` finding: a diagnostic plus its cycle economics.

    ``predicted_cycles`` models the affected leg under the current
    configuration, ``optimal_cycles`` the same leg with ``fix``
    applied; ``delta`` is the predicted saving.
    """

    diagnostic: Diagnostic
    predicted_cycles: float
    optimal_cycles: float
    fix: Optional[Fix] = None

    @property
    def code(self) -> str:
        return self.diagnostic.code

    @property
    def node(self) -> Optional[int]:
        return self.diagnostic.node

    @property
    def delta(self) -> float:
        return self.predicted_cycles - self.optimal_cycles

    def key(self) -> str:
        """Stable identity for baselines: code + fix site, no cycle
        numbers (model retunes must not churn a committed baseline)."""
        fx = self.fix
        site = (f"{fx.target}.{fx.field}" if fx is not None else "-")
        where = "-" if self.node is None else str(self.node)
        return f"{self.code}:{site}:node={where}"

    def __str__(self) -> str:
        return (f"{self.diagnostic} (predicted -{self.delta:.0f} cycles: "
                f"{self.predicted_cycles:.0f} -> "
                f"{self.optimal_cycles:.0f})")

    def to_payload(self) -> Dict[str, Any]:
        import json
        return {
            "diagnostic": json.loads(self.diagnostic.to_json()),
            "predicted_cycles": self.predicted_cycles,
            "optimal_cycles": self.optimal_cycles,
            "fix": None if self.fix is None else dataclasses.asdict(self.fix),
            "key": self.key(),
        }

    @classmethod
    def from_payload(cls, d: Mapping[str, Any]) -> "PerfFinding":
        diag = d["diagnostic"]
        fix = d.get("fix")
        fx: Optional[Fix] = None
        if fix is not None:
            value = fix["value"]
            if isinstance(value, list):
                value = tuple(value)
            fx = Fix(target=fix["target"], field=fix["field"], value=value,
                     node=fix.get("node"))
        return cls(
            diagnostic=Diagnostic(
                code=diag["code"], message=diag["message"],
                severity=Severity(diag["severity"]), node=diag.get("node"),
                name=diag.get("name"),
                suggestion=diag.get("suggestion", "")),
            predicted_cycles=float(d["predicted_cycles"]),
            optimal_cycles=float(d["optimal_cycles"]), fix=fx)


@dataclasses.dataclass
class Applied:
    """What :func:`apply` rewrote (and what it could not)."""

    policy: Optional[OffloadPolicy] = None
    nodes: Optional[List[GraphNode]] = None
    clusters: Optional[Tuple[int, ...]] = None
    applied: List[PerfFinding] = dataclasses.field(default_factory=list)
    skipped: List[PerfFinding] = dataclasses.field(default_factory=list)


# -- shared model pieces -----------------------------------------------------


def dispatch_replay_cycles(spec: simulator.JobSpec, n: int,
                           params: OccamyParams = DEFAULT_PARAMS) -> float:
    """Dispatch front-end cycles replayed per extra multicast request
    (phases A-D of the eq.-4 terms at width ``n``)."""
    terms = amodel.predict(spec, n, params).terms
    return sum(terms.get(p, 0.0) for p in _REPLAY_PHASES)


def donation_copy_cycles(nbytes: float,
                         params: OccamyParams = DEFAULT_PARAMS) -> float:
    """Device-side buffer copy one non-donating fused launch pays to
    materialize its output instead of aliasing the dead stacked operand
    (the same per-hop DMA term the forward model charges)."""
    p = params
    return (p.dma_setup_one + max(1.0, nbytes / p.wide_bw_bytes_per_cycle)
            + p.dma_latency)


def _significant(cur: float, opt: float) -> bool:
    return (cur - opt) > max(1.0, MIN_DELTA_FRAC * max(cur, 1.0))


def _finding(code: str, message: str, cur: float, opt: float,
             fix: Optional[Fix] = None, node: Optional[int] = None,
             name: Optional[str] = None,
             suggestion: str = "") -> PerfFinding:
    return PerfFinding(
        diagnostic=Diagnostic(code, message, severity=CODES[code].severity,
                              node=node, name=name, suggestion=suggestion),
        predicted_cycles=float(cur), optimal_cycles=float(opt), fix=fix)


def _phase_terms(spec: simulator.JobSpec, n: int, policy: OffloadPolicy,
                 params: OccamyParams) -> Dict[Phase, float]:
    """The eq.-4 per-phase terms `estimate` would report for this
    implementation (closed form for multicast, simulated baseline)."""
    if policy.info_dist is InfoDist.MULTICAST:
        return dict(amodel.predict(spec, n, params).terms)
    sim = simulator.simulate(spec, n, "baseline", params)
    return {ph: st.max for ph, st in sim.phase_stats().items()}


def _normalize_selection(n: Optional[int], clusters: Optional[Sequence[int]],
                         params: OccamyParams) -> List[int]:
    if clusters is not None:
        return sorted({int(c) for c in clusters})
    width = int(n) if n is not None else min(8, params.num_clusters)
    return list(range(width))


def _itemsize(value: Any) -> int:
    """Bytes per element of a numpy array, tensor or array-like."""
    if isinstance(value, torch.Tensor):
        return value.element_size()
    return int(np.asarray(value).dtype.itemsize)


def _host_shapes(job: Any, operands: Mapping[str, Any]
                 ) -> Optional[Dict[str, Tuple[int, ...]]]:
    shapes: Dict[str, Tuple[int, ...]] = {}
    for name, v in operands.items():
        shape = _verifier._shape_of(v)
        if shape is None:
            return None
        shapes[name] = shape
    return shapes


def _shard_ok(job: Any, operands: Mapping[str, Any], width: int) -> bool:
    """Would every sharded operand split evenly over ``width`` clusters?"""
    for name, v in operands.items():
        axis = job.shard_axes.get(name)
        if axis is None:
            continue
        shape = _verifier._shape_of(v)
        if shape is None or axis >= len(shape) or shape[axis] % width:
            return False
    return True


def _aligned_windows(width: int, allowed: Sequence[int],
                     num_clusters: int) -> List[Tuple[int, ...]]:
    """Single-request candidates near ``width``: aligned power-of-two
    windows (size = the pow2 bracket around ``width``) inside the
    allowed cluster set."""
    lo = 1 << max(0, int(math.floor(math.log2(max(1, width)))))
    sizes = {lo} if lo == width else {lo, min(num_clusters, lo << 1)}
    allow = set(int(c) for c in allowed)
    out: List[Tuple[int, ...]] = []
    for k in sorted(sizes):
        for base in range(0, num_clusters, k):
            w = tuple(range(base, base + k))
            if set(w) <= allow:
                out.append(w)
    return out


# -- the single-submit passes ------------------------------------------------


def lint(job: Any, operands: Optional[Mapping[str, Any]] = None, *,
         policy: Optional[OffloadPolicy] = None,
         batch: int = 1,
         n: Optional[int] = None,
         clusters: Optional[Sequence[int]] = None,
         allowed: Optional[Sequence[int]] = None,
         n_units: int = 4,
         params: OccamyParams = DEFAULT_PARAMS,
         planner: Optional[Planner] = None) -> List[PerfFinding]:
    """Perf-lint one ``Session.submit``-shaped dispatch (model only).

    Mirrors :func:`repro_torch.core.session.estimate`'s inputs; ``allowed``
    bounds OFLP105's rewrite candidates to a lease window (defaults to
    the full mesh).  Returns findings sorted by predicted saving;
    configurations the verifier rejects return no findings (lint is
    meaningful for *valid* submissions only).
    """
    pol = AUTO if policy is None else policy
    if any(d.severity is Severity.ERROR
           for d in _verifier.verify_policy(pol)):
        return []
    sel = _normalize_selection(n, clusters, params)
    width = len(sel)
    if width < 1 or batch < 1:
        return []
    plan = planner or Planner(params)
    if operands is None:
        operands, _ = job.make_instance(0)
    resident = pol.residency is Residency.RESIDENT
    decision = plan.decide(job, sel, batch, pol, n_units, operands=operands)
    rep = plan.replicated_bytes(job, operands)
    terms = _phase_terms(job.spec, width, pol, params)
    findings: List[PerfFinding] = []

    # OFLP101 — pinned staging mode vs. the model's best (cycle domain,
    # the ordering the staging suite validates; the code's explain text
    # carries the substrate wallclock caveat).
    if pol.staging is not None and not resident and rep > 0 and width >= 2:
        eff = rep * decision.fuse
        fan = plan.staging_cost(eff, sel, Staging.HOST_FANOUT)
        tree = plan.staging_cost(eff, sel, Staging.TREE)
        cur = tree if pol.staging in (Staging.TREE, Staging.TREE_RESHARD) \
            else fan
        best_mode = Staging.TREE if tree < fan else Staging.DIRECT
        best = min(tree, fan)
        if _significant(cur, best):
            findings.append(_finding(
                "OFLP101",
                f"staging={pol.staging.value} moves {eff} replicated "
                f"bytes in {cur:.0f} cycles where "
                f"{best_mode.value} takes {best:.0f}",
                cur, best, fix=Fix("policy", "staging", best_mode.value),
                name="staging",
                suggestion=f"pin staging={best_mode.value!r} (or leave it "
                           f"open for the planner)"))

    # OFLP102 — pinned fuse below the planner's pick on a batched submit.
    if batch > 1 and pol.fuse is not None and not resident:
        best_f = min(plan.pick_fuse(job.spec, width, batch), batch)
        if decision.fuse < best_f:
            def _total(f: int) -> float:
                w = (pol.window if pol.window is not None
                     else plan.pick_window(batch, f, n_units))
                return batch * amortized_per_job(terms, f, w)
            cur, opt = _total(decision.fuse), _total(best_f)
            if _significant(cur, opt):
                findings.append(_finding(
                    "OFLP102",
                    f"fuse={decision.fuse} pays the dispatch constant "
                    f"{math.ceil(batch / decision.fuse)}x over batch="
                    f"{batch}; fuse={best_f} amortizes it",
                    cur, opt, fix=Fix("policy", "fuse", best_f),
                    name="fuse",
                    suggestion=f"pin fuse={best_f} (or leave it open)"))

    # OFLP103 — pinned window below the planner's pick.
    if pol.window is not None and not resident:
        opt_w = plan.pick_window(batch, decision.fuse, n_units)
        if decision.window < opt_w:
            cur = batch * amortized_per_job(terms, decision.fuse,
                                            decision.window)
            opt = batch * amortized_per_job(terms, decision.fuse, opt_w)
            if _significant(cur, opt):
                findings.append(_finding(
                    "OFLP103",
                    f"window={decision.window} runs the pipeline "
                    f"synchronously; window={opt_w} overlaps host work "
                    f"with device phases",
                    cur, opt, fix=Fix("policy", "window", opt_w),
                    name="window",
                    suggestion=f"pin window={opt_w} (or leave it open)"))

    # OFLP105 — the selection decomposes into several multicast requests.
    if clusters is not None:
        f105 = _lint_selection(job, operands, sel, decision, rep, params,
                               plan, allowed=allowed)
        if f105 is not None:
            findings.append(f105)

    # OFLP107 — fused fresh staging with donation off and an output-
    # shaped operand: the stacked input buffers die at launch.
    if (not pol.donate_operands and not resident and decision.fuse > 1
            and isinstance(operands, Mapping)):
        f107 = _lint_donation(job, operands, decision, batch, params)
        if f107 is not None:
            findings.append(f107)

    findings.sort(key=lambda f: -f.delta)
    return findings


def _submit_selection_cost(job: Any, s: Sequence[int], rep: int,
                           staging: Staging, params: OccamyParams,
                           plan: Planner) -> float:
    r = simulator.selection_requests(s, params.num_clusters)
    total = amodel.predict_total_v2(job.spec, len(s), params)
    stag = plan.staging_cost(rep, s, staging) if rep > 0 else 0.0
    return total + stag + (r - 1) * dispatch_replay_cycles(
        job.spec, len(s), params)


def _lint_selection(job: Any, operands: Mapping[str, Any],
                    sel: List[int], decision: Any, rep: int,
                    params: OccamyParams, plan: Planner, *,
                    allowed: Optional[Sequence[int]] = None,
                    node: Optional[int] = None,
                    name: Optional[str] = None) -> Optional[PerfFinding]:
    """OFLP105 for one explicit selection (submit or graph node)."""
    r = simulator.selection_requests(sel, params.num_clusters)
    if r <= 1:
        return None
    allow = (list(allowed) if allowed is not None
             else list(range(params.num_clusters)))
    cands = [w for w in _aligned_windows(len(sel), allow, params.num_clusters)
             if _shard_ok(job, operands, len(w))]
    if not cands:
        return None
    cur = _submit_selection_cost(job, sel, rep, decision.staging, params,
                                 plan)
    scored = sorted(
        (_submit_selection_cost(job, w, rep, decision.staging, params,
                                plan), w) for w in cands)
    best_cost, best = scored[0]
    if not _significant(cur, best_cost):
        return None
    target = "node" if node is not None else "selection"
    return _finding(
        "OFLP105",
        f"clusters={list(sel)} needs {r} multicast requests; the "
        f"aligned window {list(best)} dispatches in one",
        cur, best_cost,
        fix=Fix(target, "clusters", tuple(best), node=node),
        node=node, name=name,
        suggestion=f"select the aligned power-of-two window {list(best)}")


def _lint_donation(job: Any, operands: Mapping[str, Any], decision: Any,
                   batch: int, params: OccamyParams
                   ) -> Optional[PerfFinding]:
    """OFLP107: fused fresh launches with a dead output-shaped operand."""
    for v in operands.values():
        if (isinstance(v, torch.Tensor)
                or callable(getattr(v, "is_deleted", None))):
            return None          # live device buffers may have readers
    shapes = _host_shapes(job, operands)
    if shapes is None:
        return None
    status, out_shape = _verifier._eval_out_shape(job, shapes)
    if status != "ok":
        return None
    match = next((nm for nm, sh in shapes.items() if sh == tuple(out_shape)),
                 None)
    if match is None:
        return None
    nbytes = nbytes_of(operands[match]) * decision.fuse
    launches = math.ceil(batch / decision.fuse)
    cur = launches * donation_copy_cycles(nbytes, params)
    if not _significant(cur, 0.0):
        return None
    return _finding(
        "OFLP107",
        f"donate_operands=False allocates+fills a fresh output per "
        f"launch; the stacked {match!r} buffer dies at launch and "
        f"matches the output shape",
        cur, 0.0, fix=Fix("policy", "donate_operands", True),
        name="donate_operands",
        suggestion="pin donate_operands=True for fused fresh submits")


# -- the graph passes --------------------------------------------------------


def graph_jobs(nodes: Sequence[GraphNode], *,
               default_width: Optional[int] = None,
               params: OccamyParams = DEFAULT_PARAMS
               ) -> Tuple[List[simulator.GraphJob], Dict[str, Any]]:
    """Lower GraphNodes to the simulator's :class:`GraphJob` vocabulary.

    Returns the parallel job list plus metadata (``data_edges`` as
    ``(producer, consumer, operand)`` triples and per-node
    ``out_bytes``).  The shared lowering between :func:`lint_graph` and
    the ``perflint`` bench, so findings and measurements see the same
    structure.
    """
    n_nodes = len(nodes)
    names: Dict[str, int] = {nd.name: i for i, nd in enumerate(nodes)
                             if nd.name}
    sels: List[Tuple[int, ...]] = []
    for nd in nodes:
        if nd.clusters is not None:
            sels.append(tuple(sorted({int(c) for c in nd.clusters})))
        elif nd.n is not None:
            sels.append(tuple(range(int(nd.n))))
        else:
            sels.append(tuple(range(default_width
                                    if default_width is not None else 8)))
    edges: List[Tuple[int, int, str]] = []
    for i, nd in enumerate(nodes):
        if not isinstance(nd.operands, Mapping):
            continue
        for opname, v in nd.operands.items():
            if isinstance(v, Ref):
                d = _verifier._resolve_ref(v.node, names, n_nodes)
                if d is not None:
                    edges.append((d, i, opname))
    # shape propagation in topo order (Kahn over dataflow edges)
    indeg = [0] * n_nodes
    outs: List[List[int]] = [[] for _ in range(n_nodes)]
    for d, v, _ in edges:
        indeg[v] += 1
        outs[d].append(v)
    order = [i for i in range(n_nodes) if indeg[i] == 0]
    for i in order:
        for v in outs[i]:
            indeg[v] -= 1
            if indeg[v] == 0:
                order.append(v)
    out_bytes = [0.0] * n_nodes
    out_shapes: List[Optional[Tuple[int, ...]]] = [None] * n_nodes
    for i in order:
        nd = nodes[i]
        if not isinstance(nd.operands, Mapping):
            continue
        shapes: Dict[str, Tuple[int, ...]] = {}
        itemsize = 8
        complete = True
        for opname, v in nd.operands.items():
            if isinstance(v, Ref):
                d = _verifier._resolve_ref(v.node, names, n_nodes)
                shape = out_shapes[d] if d is not None else None
            else:
                shape = _verifier._shape_of(v)
                if shape is not None:
                    itemsize = _itemsize(v)
            if shape is None:
                complete = False
                break
            shapes[opname] = shape
        if not complete:
            continue
        status, out = _verifier._eval_out_shape(nd.job, shapes)
        if status == "ok":
            out_shapes[i] = tuple(out)
            out_bytes[i] = float(int(np.prod(out)) * itemsize)
    jobs: List[simulator.GraphJob] = []
    for i, nd in enumerate(nodes):
        deps = tuple(d for d, v, _ in edges if v == i)
        rep_in = any(
            isinstance(nd.operands, Mapping)
            and nd.job.shard_axes.get(opname) is None
            for d, v, opname in edges if v == i)
        jobs.append(simulator.GraphJob(
            spec=nd.job.spec, clusters=sels[i], deps=deps,
            out_bytes=out_bytes[i], replicate_in=rep_in))
    return jobs, {"data_edges": edges, "out_bytes": out_bytes,
                  "selections": sels}


def _patched(nodes: Sequence[GraphNode], idx: int,
             sel: Sequence[int]) -> List[GraphNode]:
    out = list(nodes)
    out[idx] = dataclasses.replace(out[idx], clusters=list(sel))
    return out


def _graph_clean(nodes: Sequence[GraphNode],
                 policy: Optional[OffloadPolicy], n_units: int,
                 default_width: Optional[int]) -> bool:
    return not any(
        d.severity is Severity.ERROR
        for d in _verifier.verify_graph(nodes, policy=policy,
                                        n_units=n_units,
                                        default_width=default_width))


def lint_graph(nodes: Sequence[GraphNode], *,
               policy: Optional[OffloadPolicy] = None,
               n_units: int = 4,
               default_width: Optional[int] = None,
               allowed: Optional[Sequence[int]] = None,
               params: OccamyParams = DEFAULT_PARAMS,
               planner: Optional[Planner] = None) -> List[PerfFinding]:
    """Perf-lint a ``submit_graph`` node list against the graph models.

    Runs OFLP104 (cross-selection forward on the critical path — the
    fix realigns the consumer's ``clusters=`` with its producer) and
    OFLP105 (multi-request selections) per node.  Every proposed
    rewrite is re-verified: a fix that would introduce a correctness
    diagnostic is never suggested.  Graphs the verifier rejects return
    no findings.
    """
    if not nodes:
        return []
    if not _graph_clean(nodes, policy, n_units, default_width):
        return []
    plan = planner or Planner(params)
    jobs, meta = graph_jobs(nodes, default_width=default_width,
                            params=params)
    sels = meta["selections"]
    base = simulator.graph_critical_path(jobs, params)
    findings: List[PerfFinding] = []

    # OFLP104 — one finding per consumer paying a forward leg, aligned
    # to whichever producer lowers the closed-form makespan most.
    consumers = sorted({v for _, v, _ in meta["data_edges"]})
    for v in consumers:
        producers = sorted({d for d, vv, _ in meta["data_edges"] if vv == v})
        crossing = [d for d in producers if sels[d] != sels[v]]
        if not crossing:
            continue
        best: Optional[Tuple[float, int, Tuple[int, ...]]] = None
        for d in crossing:
            cand_sel = sels[d]
            nd = nodes[v]
            if (isinstance(nd.operands, Mapping)
                    and not _shard_ok(nd.job, {
                        k: o for k, o in nd.operands.items()
                        if not isinstance(o, Ref)}, len(cand_sel))):
                continue
            cand_jobs = [dataclasses.replace(j, clusters=cand_sel)
                         if i == v else j for i, j in enumerate(jobs)]
            cp = simulator.graph_critical_path(cand_jobs, params)
            if best is None or cp < best[0]:
                best = (cp, d, cand_sel)
        if best is None:
            continue
        cp, d, cand_sel = best
        if not _significant(base, cp):
            continue
        if not _graph_clean(_patched(nodes, v, cand_sel), policy, n_units,
                            default_width):
            continue
        fwd = simulator.forward_model(
            meta["out_bytes"][d], sels[d], sels[v],
            replicate=jobs[v].replicate_in, params=params)
        findings.append(_finding(
            "OFLP104",
            f"node {v} reads node {d} across selections "
            f"({list(sels[d])} -> {list(sels[v])}), paying a "
            f"{fwd:.0f}-cycle forward on the critical path",
            base, cp, fix=Fix("node", "clusters", cand_sel, node=v),
            node=v, name=nodes[v].name,
            suggestion=f"align node {v} clusters= with its producer "
                       f"({list(cand_sel)}) to forward by aliasing"))

    # OFLP105 — per-node multi-request selections (explicit clusters only;
    # request-encoded nodes are the runtime's business).
    for i, nd in enumerate(nodes):
        if nd.clusters is None or nd.request is not None:
            continue
        if not isinstance(nd.operands, Mapping):
            continue
        host_ops = {k: v for k, v in nd.operands.items()
                    if not isinstance(v, Ref)}
        rep = sum(nbytes_of(v) for k, v in host_ops.items()
                  if nd.job.shard_axes.get(k) is None)
        decision = plan.decide(nd.job, list(sels[i]), 1,
                               policy or AUTO, n_units, operands=host_ops)
        f = _lint_selection(nd.job, host_ops, list(sels[i]), decision, rep,
                            params, plan, allowed=allowed, node=i,
                            name=nd.name)
        if f is not None and f.fix is not None:
            if _graph_clean(_patched(nodes, i, f.fix.value), policy,
                            n_units, default_width):
                findings.append(f)

    findings.sort(key=lambda f: -f.delta)
    return findings


# -- the session pass --------------------------------------------------------


def lint_session(session: Any) -> List[PerfFinding]:
    """OFLP106: ``stage()``d residency no later submit redispatched.

    Reads the session's staged-residency ledger (every ``stage()`` call
    records its staging cycles; resident submits bump the use counter)
    and flags entries whose staging leg was pure waste.
    """
    staged: Mapping[Any, Dict[str, Any]] = getattr(
        session, "_staged_residency", {})
    findings: List[PerfFinding] = []
    for key, rec in staged.items():
        if rec.get("uses", 0) > 0:
            continue
        job_name, ids = key
        cyc = float(rec.get("cycles", 0.0))
        findings.append(_finding(
            "OFLP106",
            f"stage({job_name!r}) on clusters {list(ids)} paid "
            f"{cyc:.0f} staging cycles but no submit used "
            f"residency=RESIDENT",
            cyc, 0.0, fix=Fix("stage", "drop", (job_name, tuple(ids))),
            name=job_name,
            suggestion="drop the stage() call, or redispatch with "
                       "operands=Residency.RESIDENT"))
    findings.sort(key=lambda f: -f.delta)
    return findings


# -- autofix -----------------------------------------------------------------


def apply(findings: Iterable[PerfFinding], *,
          policy: Optional[OffloadPolicy] = None,
          nodes: Optional[Sequence[GraphNode]] = None,
          clusters: Optional[Sequence[int]] = None) -> Applied:
    """Apply every machine-applicable fix to the given artifacts.

    Pass whichever of ``policy`` / ``nodes`` / ``clusters`` the findings
    target; fixes without a matching artifact (and advice-only fixes
    like dropping a dead stage) land in ``Applied.skipped``.  ``nodes``
    is never mutated — a patched copy comes back.
    """
    new_nodes = list(nodes) if nodes is not None else None
    new_clusters = (tuple(int(c) for c in clusters)
                    if clusters is not None else None)
    out = Applied(policy=policy, nodes=new_nodes, clusters=new_clusters)
    for f in findings:
        fx = f.fix
        if fx is None:
            out.skipped.append(f)
            continue
        if fx.target == "policy" and out.policy is not None:
            out.policy = out.policy.pinned(**{fx.field: fx.value})
        elif (fx.target == "node" and out.nodes is not None
                and fx.node is not None and 0 <= fx.node < len(out.nodes)):
            value = (list(fx.value) if fx.field == "clusters"
                     else fx.value)
            out.nodes[fx.node] = dataclasses.replace(
                out.nodes[fx.node], **{fx.field: value})
        elif fx.target == "selection" and out.clusters is not None:
            out.clusters = tuple(int(c) for c in fx.value)
        else:
            out.skipped.append(f)
            continue
        out.applied.append(f)
    return out


def suggested_policy(findings: Iterable[PerfFinding],
                     policy: OffloadPolicy) -> OffloadPolicy:
    """The policy with every policy-targeted fix pinned (see
    :meth:`OffloadPolicy.diff` for rendering what changed)."""
    result = apply(findings, policy=policy).policy
    assert result is not None
    return result
