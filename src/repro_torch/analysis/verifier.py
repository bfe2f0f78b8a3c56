"""Static offload verifier: walk the descriptor, not the kernel.

Twin of ``repro.analysis.verifier``.  The paper's central lesson is that
offload correctness and cost live in the *descriptor* — hazards,
completion races and mis-sized windows are knowable before a single cycle
runs.  :func:`verify_graph` walks a ``submit_graph`` node list (and
:func:`verify` a single submit) against the same invariants the runtime
enforces piecemeal, reporting every finding as a typed
:class:`~repro_torch.analysis.diagnostics.Diagnostic` with a stable
``OFL###`` code instead of the first ad-hoc exception.

:class:`Session` runs these automatically at the top of ``submit`` /
``submit_graph`` (disable with ``Session(verify=False)``); error-severity
findings raise :class:`VerificationError` — a :class:`~repro_torch.core.
scoreboard.GraphError` subclass, so existing ``except GraphError``
call sites keep working — before any staging touches a device.

Checks are conservative: a fact the verifier cannot establish statically
(mask-encoded selections, ``Residency.RESIDENT`` operand shapes, foreign
sessions) is skipped, never guessed — a defect-free graph verifies clean.
Producer output shapes are propagated through the DAG by running the
jobs' computations on ``device="meta"`` tensors (shapes only — no data,
no device work; memoized per (kernel, shapes)), where the reference calls
``jax.eval_shape``.  A computation whose control flow reads its data (the
BFS frontier loop) cannot run on meta tensors; it runs once on zeros of
the same shapes on the CPU instead, as the reference's traced loop
stands for every iteration count.
"""

from __future__ import annotations

import collections
from typing import (
    Any, Dict, List, Mapping, Optional, Sequence, Tuple,
)

import torch

from repro_torch.core.policy import OffloadPolicy, Residency, RetryPolicy, Staging
from repro_torch.core.scoreboard import GraphError, GraphNode, Ref

from .diagnostics import (
    Diagnostic, Severity, contradiction, invalid_field, invalid_mode,
    use_after_donate,
)

__all__ = [
    "VerificationError", "verify", "verify_graph", "verify_policy",
]


class VerificationError(GraphError):
    """Static verification found error-severity diagnostics.

    Subclasses :class:`~repro_torch.core.scoreboard.GraphError` (itself a
    ``ValueError``) so pre-verifier ``except`` clauses keep catching
    malformed graphs; ``.diagnostics`` carries the typed findings and
    ``.codes`` their stable codes.
    """

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics: List[Diagnostic] = list(diagnostics)
        lines = "\n  ".join(str(d) for d in self.diagnostics)
        super().__init__(
            f"static verification failed ({len(self.diagnostics)} "
            f"diagnostic(s)):\n  {lines}")

    @property
    def codes(self) -> Tuple[str, ...]:
        return tuple(d.code for d in self.diagnostics)


def raise_errors(diags: Sequence[Diagnostic]) -> None:
    """Raise :class:`VerificationError` for error-severity findings."""
    errors = [d for d in diags if d.severity is Severity.ERROR]
    if errors:
        raise VerificationError(errors)


# -- helpers -----------------------------------------------------------------


def _is_deleted(value: Any) -> bool:
    """Donated-buffer probe: a tensor whose storage a donating dispatch
    released (``repro_torch.core.offload``), or any object with an
    ``is_deleted()`` that says so (the reference's duck type)."""
    if isinstance(value, torch.Tensor):
        return (value.numel() > 0
                and value.untyped_storage().nbytes() == 0)
    probe = getattr(value, "is_deleted", None)
    return callable(probe) and bool(probe())


def _shape_of(value: Any) -> Optional[Tuple[int, ...]]:
    shape = getattr(value, "shape", None)
    if shape is not None:
        return tuple(shape)
    try:
        import numpy as np
        return tuple(np.asarray(value).shape)
    except Exception:                                      # noqa: BLE001
        return None


#: memoized shape-evaluation results: (kernel id, sorted shapes) -> result
_SHAPE_CACHE: Dict[Tuple, Tuple[str, Any]] = {}

#: operand dtype of the shape pass (the paper's jobs are double precision)
_SHAPE_DTYPE = torch.float64


def _run_on(job: Any, shapes: Mapping[str, Tuple[int, ...]],
            device: str) -> Tuple[int, ...]:
    """The global output shape of ``job`` over operands of ``shapes``.

    ``job.compute`` takes cluster-major operands; one cluster holds the
    whole operand, so each global shape gains a leading cluster axis of
    1 and the result loses it (a reduced or replicated result on one
    cluster is the global result)."""
    args = [torch.zeros((1,) + tuple(shapes[name]), dtype=_SHAPE_DTYPE,
                        device=device)
            for name in sorted(shapes)]
    out = job.compute(*args)
    return tuple(out.shape[1:])


def _data_dependent(e: Exception) -> bool:
    """True for the error a meta tensor raises when code reads its data."""
    return "meta" in str(e).lower()


def _eval_out_shape(job: Any, shapes: Mapping[str, Tuple[int, ...]]
                    ) -> Tuple[str, Any]:
    """-> ("ok", out_shape) | ("fail", reason) | ("skip", None).

    Runs the job's computation over meta tensors of the inferred global
    operand shapes — the runtime contract is that the graph result of a
    node has this shape (sharded outputs reassemble to it, reduced and
    broadcast-class outputs equal it outright).  A computation that reads
    its data runs once on CPU zeros of the same shapes instead.
    """
    key = (id(job.compute), tuple(sorted(shapes.items())))
    hit = _SHAPE_CACHE.get(key)
    if hit is not None:
        return hit
    try:
        try:
            out = _run_on(job, shapes, "meta")
        except Exception as e:                             # noqa: BLE001
            if not _data_dependent(e):
                raise
            out = _run_on(job, shapes, "cpu")
        result: Tuple[str, Any] = ("ok", out)
    except Exception as e:                                 # noqa: BLE001
        result = ("fail", f"{type(e).__name__}: {e}")
    if len(_SHAPE_CACHE) > 512:
        _SHAPE_CACHE.clear()
    _SHAPE_CACHE[key] = result
    return result


def _node_width(nd: GraphNode, default_width: Optional[int],
                session: Any) -> Optional[int]:
    """Statically-known cluster-selection size of a node (None = unknown)."""
    if nd.clusters is not None:
        return len(set(int(c) for c in nd.clusters))
    if nd.request is not None:
        return None          # mask-encoded; the runtime resolves it
    if nd.n is not None:
        return int(nd.n)
    if nd.session is not None and nd.session is not session:
        return None          # a foreign lease's width is its business
    return default_width


def _resolve_ref(node: Any, names: Mapping[str, int], n_nodes: int
                 ) -> Optional[int]:
    if isinstance(node, str):
        return names.get(node)
    try:
        idx = int(node)
    except (TypeError, ValueError):
        return None
    return idx if 0 <= idx < n_nodes else None


# -- the passes --------------------------------------------------------------


def verify_policy(policy: Optional[OffloadPolicy] = None,
                  **fields: Any) -> List[Diagnostic]:
    """Validate policy fields without constructing (or raising).

    With ``policy`` given its (already-validated) fields seed the check;
    ``fields`` override/extend with raw values — the pre-flight a config
    loader runs before ``OffloadPolicy(**fields)`` would raise.  Returns
    OFL008 (bad mode value), OFL009 (out-of-range field) and OFL010
    (contradiction) diagnostics.
    """
    from repro_torch.core.policy import Completion, InfoDist
    merged: Dict[str, Any] = {}
    if policy is not None:
        for f in ("staging", "residency", "info_dist", "completion",
                  "fuse", "window", "depth", "donate_operands", "retry"):
            merged[f] = getattr(policy, f)
    merged.update(fields)

    diags: List[Diagnostic] = []
    enums = (("staging", Staging, True), ("residency", Residency, False),
             ("info_dist", InfoDist, False), ("completion", Completion, False))
    coerced: Dict[str, Any] = {}
    for field, enum_cls, optional in enums:
        value = merged.get(field)
        if value is None:
            if not optional and field in merged:
                diags.append(invalid_mode(field, value,
                                          tuple(m.value for m in enum_cls)))
            continue
        try:
            coerced[field] = enum_cls(value)
        except ValueError:
            diags.append(invalid_mode(field, value,
                                      tuple(m.value for m in enum_cls)))
    for field in ("fuse", "window", "depth"):
        v = merged.get(field)
        if v is not None and (not isinstance(v, int) or v < 1):
            diags.append(invalid_field(
                field, f"{field} must be an int >= 1, got {v!r}"))
    retry = merged.get("retry")
    if retry is not None and not isinstance(retry, RetryPolicy):
        diags.append(invalid_field(
            "retry", f"retry must be a RetryPolicy, got "
                     f"{type(retry).__name__}"))
    if (coerced.get("residency") is Residency.RESIDENT
            and coerced.get("staging") is not None
            and coerced.get("staging") is not Staging.DIRECT):
        diags.append(contradiction(
            f"residency=RESIDENT stages no operands; pinning "
            f"staging={coerced['staging'].value!r} is contradictory "
            "(leave staging unset or DIRECT)", name="staging"))
    return diags


def verify(job: Any, policy: Optional[OffloadPolicy] = None,
           lease: Any = None, *,
           operands: Any = None,
           n: Optional[int] = None,
           clusters: Optional[Sequence[int]] = None,
           n_units: int = 4) -> List[Diagnostic]:
    """Statically verify one submit: (job, policy, lease, operands).

    Returns every finding (errors *and* warnings); ``Session.submit``
    raises the error subset through the OFL003 donation shim.  Checks:
    deleted operand buffers (OFL003), operand-name and shard-axis
    divisibility mismatches (OFL006), policy contradictions
    (OFL008/9/10 via :func:`verify_policy`), and an inactive lease
    (OFL011).
    """
    diags: List[Diagnostic] = []
    if policy is not None:
        diags.extend(verify_policy(policy))
    if lease is not None and not getattr(lease, "active", True):
        diags.append(Diagnostic(
            "OFL011",
            f"lease {getattr(lease, 'lease_id', '?')} over clusters "
            f"{tuple(getattr(lease, 'clusters', ()))} is no longer "
            "active (released, revoked, or resized away)"))

    if operands is None or isinstance(operands, (Residency, str)):
        return diags
    instances = (list(operands) if isinstance(operands, (list, tuple))
                 else [operands])
    width: Optional[int] = None
    if clusters is not None:
        width = len(set(int(c) for c in clusters))
    elif n is not None:
        width = int(n)
    elif lease is not None and getattr(lease, "clusters", None) is not None:
        width = len(lease.clusters)
    shard_axes = getattr(job, "shard_axes", None)
    for b, inst in enumerate(instances):
        if not isinstance(inst, Mapping):
            continue
        tag = f" (instance {b})" if len(instances) > 1 else ""
        for name, value in inst.items():
            if _is_deleted(value):
                diags.append(use_after_donate(
                    f"submitted operand {name!r}{tag}", name=name))
        if shard_axes is None:
            continue
        if set(inst) != set(shard_axes):
            diags.append(Diagnostic(
                "OFL006",
                f"operand names {sorted(inst)}{tag} do not match job "
                f"{job.spec.name}'s {sorted(shard_axes)}"))
            continue
        if not width:
            continue
        for name, value in inst.items():
            axis = shard_axes[name]
            shape = _shape_of(value)
            if axis is None or shape is None or axis >= len(shape):
                continue
            if shape[axis] % width:
                diags.append(Diagnostic(
                    "OFL006",
                    f"operand {name!r}{tag} axis {axis} ({shape[axis]}) "
                    f"not divisible by {width} clusters", name=name))
    return diags


def verify_graph(nodes: Sequence[GraphNode], *,
                 policy: Optional[OffloadPolicy] = None,
                 n_units: int = 4,
                 default_width: Optional[int] = None,
                 session: Any = None) -> List[Diagnostic]:
    """Statically verify a ``submit_graph`` node list.

    Walks structure (OFL001 cycles, OFL002 dangling/malformed
    references), donated operand buffers (OFL003), donation renames
    (OFL004, warning), cross-lease circular waits (OFL005, warning),
    shard/forward-edge shape consistency (OFL006 — producer output
    shapes propagated over meta tensors), graph width vs the
    in-flight window (OFL007, warning) and the graph-policy
    contradiction (OFL010).  Structural errors short-circuit the deeper
    passes (their node indices would be unreliable).

    ``default_width`` is the submitting session's device count (the
    selection a node with no ``n``/``clusters``/``request`` gets);
    ``session`` identifies that session so foreign-lease nodes are
    skipped conservatively.
    """
    diags: List[Diagnostic] = []
    nodes = list(nodes)
    if not nodes:
        return [Diagnostic("OFL002", "empty graph")]
    for i, nd in enumerate(nodes):
        if not isinstance(nd, GraphNode):
            diags.append(Diagnostic(
                "OFL002", f"entry {i} is not a GraphNode "
                          f"(got {type(nd).__name__})", node=i))
    if diags:
        return diags

    n_nodes = len(nodes)
    names: Dict[str, int] = {}
    for i, nd in enumerate(nodes):
        if nd.name is None:
            continue
        if nd.name in names:
            diags.append(Diagnostic(
                "OFL002", f"duplicate node name {nd.name!r} (nodes "
                          f"{names[nd.name]} and {i})", node=i,
                name=nd.name))
        else:
            names[nd.name] = i

    deps: List[List[int]] = []
    data_edges: List[List[Tuple[int, str]]] = []
    for i, nd in enumerate(nodes):
        where = f"node {i}" + (f" ({nd.name})" if nd.name else "")
        d: set = set()
        edges: List[Tuple[int, str]] = []
        if isinstance(nd.operands, Mapping):
            for op_name, value in nd.operands.items():
                if not isinstance(value, Ref):
                    continue
                src = _resolve_ref(value.node, names, n_nodes)
                if src is None:
                    diags.append(Diagnostic(
                        "OFL002",
                        f"{where} operand {op_name!r}: dangling Ref "
                        f"{value.node!r} (known names: {sorted(names)}, "
                        f"indices [0, {n_nodes}))", node=i, name=nd.name))
                elif src == i:
                    diags.append(Diagnostic(
                        "OFL001", f"{where} operand {op_name!r} depends "
                                  "on the node itself", node=i,
                        name=nd.name))
                else:
                    edges.append((src, op_name))
                    d.add(src)
        elif not isinstance(nd.operands, Residency):
            diags.append(Diagnostic(
                "OFL002",
                f"{where}: operands must be a mapping or "
                f"Residency.RESIDENT, got {type(nd.operands).__name__}",
                node=i, name=nd.name))
        for ref in nd.after:
            src = _resolve_ref(ref.node if isinstance(ref, Ref) else ref,
                               names, n_nodes)
            if src is None:
                diags.append(Diagnostic(
                    "OFL002", f"{where} after: dangling reference "
                              f"{ref!r}", node=i, name=nd.name))
            elif src == i:
                diags.append(Diagnostic(
                    "OFL001", f"{where} after: depends on itself",
                    node=i, name=nd.name))
            else:
                d.add(src)
        deps.append(sorted(d))
        data_edges.append(edges)
    if diags:
        return diags

    # cycle detection (Kahn) + the topological order the shape pass uses
    succs: List[List[int]] = [[] for _ in range(n_nodes)]
    indeg = [len(d) for d in deps]
    for i, d in enumerate(deps):
        for p in d:
            succs[p].append(i)
    queue = collections.deque(i for i, k in enumerate(indeg) if k == 0)
    topo: List[int] = []
    while queue:
        i = queue.popleft()
        topo.append(i)
        for s in succs[i]:
            indeg[s] -= 1
            if indeg[s] == 0:
                queue.append(s)
    if len(topo) != n_nodes:
        stuck = sorted(i for i, k in enumerate(indeg) if k > 0)
        diags.append(Diagnostic(
            "OFL001", f"dependency cycle through nodes {stuck}",
            node=stuck[0]))
        return diags

    pol = policy
    if pol is not None:
        if pol.retry is not None:
            diags.append(contradiction(
                "graph submits do not ride the retry/deadline ladder; "
                "drop policy.retry (wrap individual submits for "
                "fault-tolerant dispatch)", name="retry"))
        diags.extend(verify_policy(pol))

    # OFL003: an operand buffer a donating dispatch already consumed
    for i, nd in enumerate(nodes):
        if not isinstance(nd.operands, Mapping):
            continue
        for op_name, value in nd.operands.items():
            if not isinstance(value, Ref) and _is_deleted(value):
                diags.append(use_after_donate(
                    f"node {i} operand {op_name!r}", node=i,
                    name=nd.name))
    if any(d.severity is Severity.ERROR for d in diags):
        return diags

    # OFL004 (warning): donation renames every forwarded read
    if pol is not None and pol.donate_operands:
        reads: Dict[int, int] = collections.Counter(
            src for i in range(n_nodes) for src, _ in data_edges[i])
        for src in sorted(reads):
            diags.append(Diagnostic(
                "OFL004",
                f"donating policy: {reads[src]} forwarded read(s) of "
                f"node {src}'s result will be renamed (copied) to break "
                "the WAR/WAW hazard", severity=Severity.WARNING,
                node=src, name=nodes[src].name))

    # OFL006: shard divisibility + forward-edge shape propagation
    out_shape: List[Optional[Tuple[int, ...]]] = [None] * n_nodes
    edge_src = [dict((op, src) for src, op in data_edges[i])
                for i in range(n_nodes)]
    for i in topo:
        nd = nodes[i]
        if not isinstance(nd.operands, Mapping):
            continue
        shard_axes = getattr(nd.job, "shard_axes", None)
        if shard_axes is not None and set(nd.operands) != set(shard_axes):
            diags.append(Diagnostic(
                "OFL006",
                f"node {i} operand names {sorted(nd.operands)} do not "
                f"match job {nd.job.spec.name}'s {sorted(shard_axes)}",
                node=i, name=nd.name))
            continue
        shapes: Dict[str, Optional[Tuple[int, ...]]] = {}
        for op_name, value in nd.operands.items():
            if isinstance(value, Ref):
                shapes[op_name] = out_shape[edge_src[i][op_name]]
            else:
                shapes[op_name] = _shape_of(value)
        width = _node_width(nd, default_width, session)
        if shard_axes is not None and width:
            for op_name, shape in shapes.items():
                axis = shard_axes[op_name]
                if axis is None or shape is None or axis >= len(shape):
                    continue
                if shape[axis] % width:
                    via = (" (forwarded from node "
                           f"{edge_src[i][op_name]})"
                           if op_name in edge_src[i] else "")
                    diags.append(Diagnostic(
                        "OFL006",
                        f"node {i} operand {op_name!r}{via} axis {axis} "
                        f"({shape[axis]}) not divisible by {width} "
                        "clusters", node=i, name=nd.name))
        if shapes and all(s is not None for s in shapes.values()):
            status, out = _eval_out_shape(nd.job, shapes)  # type: ignore[arg-type]
            if status == "ok":
                out_shape[i] = out
            elif status == "fail":
                diags.append(Diagnostic(
                    "OFL006",
                    f"node {i}: operands {dict(sorted(shapes.items()))} "
                    f"are not shape-consistent for job "
                    f"{nd.job.spec.name}: {out}", node=i, name=nd.name))

    # OFL007 (warning): peak ready-width vs the in-flight window
    limit = max(1, min(pol.window if pol is not None and pol.window
                       is not None else n_units, n_units))
    level = [0] * n_nodes
    for i in topo:
        level[i] = 1 + max((level[p] for p in deps[i]), default=-1)
    width_per_level = collections.Counter(level)
    peak = max(width_per_level.values())
    if peak > limit:
        widest = max(width_per_level, key=lambda lv: width_per_level[lv])
        diags.append(Diagnostic(
            "OFL007",
            f"graph width {peak} (level {widest}) exceeds the in-flight "
            f"window {limit}; issue will stall draining the oldest "
            "in-flight job", severity=Severity.WARNING))

    # OFL005 (warning): condensed lease graph must not cycle
    group_of = [id(nd.session) if nd.session is not None else 0
                for nd in nodes]
    group_edges: Dict[int, set] = collections.defaultdict(set)
    for i, d in enumerate(deps):
        for p in d:
            if group_of[p] != group_of[i]:
                group_edges[group_of[p]].add(group_of[i])
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[int, int] = collections.defaultdict(int)

    def _cycles_from(g: int) -> bool:
        stack = [(g, iter(group_edges.get(g, ())))]
        color[g] = GRAY
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if color[nxt] == GRAY:
                    return True
                if color[nxt] == WHITE:
                    color[nxt] = GRAY
                    stack.append((nxt, iter(group_edges.get(nxt, ()))))
                    advanced = True
                    break
            if not advanced:
                color[node] = BLACK
                stack.pop()
        return False

    if any(color[g] == WHITE and _cycles_from(g)
           for g in list(group_edges)):
        diags.append(Diagnostic(
            "OFL005",
            "dependency edges cross session leases in a cycle — the "
            "leases cannot drain independently (a distributed "
            "dispatcher would circular-wait)",
            severity=Severity.WARNING))

    return diags
