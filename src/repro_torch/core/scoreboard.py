"""Out-of-order dependent dispatch: the host-side issue scoreboard.

Twin of ``repro.core.scoreboard``, unchanged but for its imports.  The
paper's dispatch path treats every job as independent: a chain of K
dependent jobs pays K host round trips — fetch
the producer's result to the host (d2h), restage it for the consumer
(h2d) — and serializes on the host even when sub-DAGs are independent.
This module is the host dispatcher's answer, structured like an
out-of-order core's issue logic (R10K-style Active List + Integer
Queue):

* the **Active List** holds every node of a submitted graph in program
  order with its lifecycle state (``waiting -> issued -> retired``) —
  retirement bookkeeping stays in order per completion unit while issue
  does not;
* the **Integer Queue** is the ready station: a node becomes *issuable*
  the moment every producer it depends on has been **issued** (not
  completed — kernel launches are asynchronous and stream-ordered, so a
  consumer launch can consume a producer's not-yet-materialized result
  and the device chains them);
* **buffer renaming** breaks WAR/WAW hazards: graph staging never
  overwrites a plan's resident buffers (every node stages into fresh
  renamed buffers), and a forwarded producer result that a donating
  consumer would consume is copied to a fresh buffer first —
  ``pending_readers`` tells the dispatcher when a rename copy is
  required instead of stalling.

The scoreboard itself is pure host-side bookkeeping (no torch imports) —
:meth:`Session.submit_graph <repro_torch.core.session.Session.submit_graph>`
drives it, and the property tests drive it with synthetic random DAGs.

:class:`InflightWindow` is the bounded in-flight companion structure:
at most ``limit`` issued-but-not-retired jobs per runtime (one
completion-unit copy each, fig. 6).  It generalizes the window-stall
logic :class:`~repro_torch.core.stream.OffloadStream` had inline — stream and
graph dispatch now share it.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import (
    Any, Callable, Deque, Dict, Iterable, List, Mapping, Optional,
    Sequence, Tuple, Union,
)

from repro_torch.analysis import sanitizer as _san

__all__ = [
    "GraphError", "GraphNode", "InflightWindow", "Ref", "Scoreboard",
    "resolve_graph",
]


class GraphError(ValueError):
    """A malformed job graph: unknown reference, duplicate name, cycle,
    or an issue/retire call that violates the scoreboard protocol."""


@dataclasses.dataclass(frozen=True)
class Ref:
    """A dataflow edge: *this operand is node* ``node``'s *result*.

    ``node`` names a producer by index (position in the node list) or by
    its ``GraphNode.name``.  The consumer's operand is the producer's
    output forwarded device-to-device to the consumer's sharding — never
    fetched to the host.
    """

    node: Union[int, str]


@dataclasses.dataclass
class GraphNode:
    """One job of a dependency graph (the ``submit_graph`` vocabulary).

    ``operands`` maps operand names to host arrays or :class:`Ref`s to
    producer nodes (or is ``Residency.RESIDENT`` to reuse the plan's
    resident buffers).  ``after`` adds pure ordering edges on top of the
    dataflow.  ``fetch`` controls whether ``GraphHandle.wait`` returns
    this node's result (default: only *sink* nodes — results no other
    node consumes — are fetched; intermediates stay on-fabric).
    ``session`` dispatches the node through another session's lease (a
    graph spanning multiple leases issues concurrently across them).
    """

    job: Any                                 # PaperJob
    operands: Any                            # Mapping[str, ndarray|Ref] | Residency
    name: Optional[str] = None
    job_args: Optional[Any] = None
    after: Sequence[Union[int, str, Ref]] = ()
    n: Optional[int] = None
    request: Optional[Any] = None
    clusters: Optional[Sequence[int]] = None
    fetch: Optional[bool] = None
    session: Optional[Any] = None


def _dep_id(ref: Union[int, str, Ref], names: Dict[str, int],
            n_nodes: int, where: str) -> int:
    node = ref.node if isinstance(ref, Ref) else ref
    if isinstance(node, str):
        if node not in names:
            raise GraphError(f"{where}: unknown node name {node!r} "
                             f"(known: {sorted(names)})")
        return names[node]
    idx = int(node)
    if not 0 <= idx < n_nodes:
        raise GraphError(f"{where}: node index {idx} outside "
                         f"[0, {n_nodes})")
    return idx


def resolve_graph(nodes: Sequence[GraphNode]
                  ) -> Tuple[List[List[int]], List[List[Tuple[int, str]]]]:
    """Resolve names/refs of ``nodes`` -> (deps, data_edges) per node.

    ``deps[i]`` are all predecessor indices of node i (dataflow and
    ``after`` ordering edges merged); ``data_edges[i]`` the dataflow
    subset as ``(producer, operand_name)``.  Raises :class:`GraphError`
    on duplicate names, unresolvable references, or self-dependencies
    (cycles are caught by :class:`Scoreboard`).
    """
    if not nodes:
        raise GraphError("empty graph")
    names: Dict[str, int] = {}
    for i, nd in enumerate(nodes):
        if nd.name is not None:
            if nd.name in names:
                raise GraphError(f"duplicate node name {nd.name!r} "
                                 f"(nodes {names[nd.name]} and {i})")
            names[nd.name] = i
    deps: List[List[int]] = []
    data_edges: List[List[Tuple[int, str]]] = []
    for i, nd in enumerate(nodes):
        where = f"node {i}" + (f" ({nd.name})" if nd.name else "")
        d: List[int] = []
        edges: List[Tuple[int, str]] = []
        if isinstance(nd.operands, Mapping):
            for op_name, value in nd.operands.items():
                if isinstance(value, Ref):
                    src = _dep_id(value, names, len(nodes),
                                  f"{where} operand {op_name!r}")
                    edges.append((src, op_name))
                    d.append(src)
        for ref in nd.after:
            d.append(_dep_id(ref, names, len(nodes), f"{where} after"))
        if i in d:
            raise GraphError(f"{where} depends on itself")
        deps.append(sorted(set(d)))
        data_edges.append(edges)
    return deps, data_edges


#: Active-List lifecycle states
WAITING, ISSUED, RETIRED = "waiting", "issued", "retired"


class Scoreboard:
    """Active-List/Integer-Queue issue engine over a dependency DAG.

    Constructed from per-node predecessor lists (see
    :func:`resolve_graph`); raises :class:`GraphError` on a cycle.  The
    dispatch loop is::

        sb = Scoreboard(deps)
        while not sb.all_retired:
            for i in sb.ready():      # Integer Queue, age order
                dispatch(i); sb.issue(i)
            sb.retire(oldest_inflight)   # when a unit must be freed

    ``issue`` requires readiness (every predecessor issued) and
    ``retire`` requires ``issued`` — protocol violations raise rather
    than corrupt state, so the property tests can drive random
    interleavings hard.
    """

    def __init__(self, deps: Sequence[Iterable[int]]):
        self.deps: List[Tuple[int, ...]] = [
            tuple(sorted(set(int(x) for x in d))) for d in deps]
        n = len(self.deps)
        for i, d in enumerate(self.deps):
            for p in d:
                if not 0 <= p < n:
                    raise GraphError(
                        f"node {i} depends on out-of-range node {p}")
            if i in d:
                raise GraphError(f"node {i} depends on itself")
        self.succs: List[List[int]] = [[] for _ in range(n)]
        for i, d in enumerate(self.deps):
            for p in d:
                self.succs[p].append(i)
        self._check_acyclic()
        #: the Active List: program-order lifecycle states
        self.state: List[str] = [WAITING] * n
        self._unissued_preds = [len(d) for d in self.deps]
        #: unissued *dataflow-or-ordering* consumers per producer — while
        #: > 0 a producer's result buffer must survive (a donating
        #: consumer renames instead of consuming it)
        self._pending_readers = [len(s) for s in self.succs]
        self.issue_order: List[int] = []
        self.retire_order: List[int] = []
        self._inflight = 0
        self.max_inflight = 0

    def _check_acyclic(self) -> None:
        indeg = [len(d) for d in self.deps]
        q = collections.deque(i for i, d in enumerate(indeg) if d == 0)
        seen = 0
        while q:
            i = q.popleft()
            seen += 1
            for s in self.succs[i]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    q.append(s)
        if seen != len(self.deps):
            stuck = [i for i, d in enumerate(indeg) if d > 0]
            raise GraphError(f"dependency cycle through nodes {stuck}")

    def __len__(self) -> int:
        return len(self.deps)

    # -- Integer Queue ------------------------------------------------------

    def ready(self) -> List[int]:
        """Issuable nodes in age (program) order: waiting, all
        predecessors issued.  Issue readiness is *dispatch*-based, not
        completion-based — async dispatch lets a consumer launch chain on
        a producer's in-flight device array."""
        return [i for i in range(len(self.deps))
                if self.state[i] == WAITING
                and self._unissued_preds[i] == 0]

    def issue(self, i: int) -> None:
        if self.state[i] != WAITING:
            raise GraphError(f"node {i} already {self.state[i]}")
        if self._unissued_preds[i]:
            raise GraphError(
                f"node {i} is not ready: {self._unissued_preds[i]} "
                "unissued predecessors")
        s = _san.active()
        if s is not None:
            s.sb_issue(self, i, self.deps[i])
        self.state[i] = ISSUED
        self.issue_order.append(i)
        self._inflight += 1
        self.max_inflight = max(self.max_inflight, self._inflight)
        for s in self.succs[i]:
            self._unissued_preds[s] -= 1
        for p in self.deps[i]:
            self._pending_readers[p] -= 1

    def retire(self, i: int) -> None:
        """Completion-side retirement (the job's completion cause was
        collected and its unit copy freed) — any order relative to
        issue order of *other* nodes."""
        if self.state[i] != ISSUED:
            raise GraphError(f"cannot retire node {i}: {self.state[i]}")
        s = _san.active()
        if s is not None:
            s.sb_retire(self, i)
        self.state[i] = RETIRED
        self.retire_order.append(i)
        self._inflight -= 1

    # -- rename/readiness queries ------------------------------------------

    def pending_readers(self, i: int) -> int:
        """Consumers of node ``i`` not yet issued.  A donating consumer
        must *rename* (copy) the forwarded buffer while this is > 0 —
        consuming it in place would be a WAR hazard on the remaining
        readers."""
        return self._pending_readers[i]

    @property
    def inflight(self) -> int:
        return self._inflight

    @property
    def all_issued(self) -> bool:
        return all(s != WAITING for s in self.state)

    @property
    def all_retired(self) -> bool:
        return all(s == RETIRED for s in self.state)

    def sinks(self) -> List[int]:
        """Nodes with no consumers — the graph's results by default."""
        return [i for i, s in enumerate(self.succs) if not s]


class InflightWindow:
    """Bounded issued-but-not-retired window (completion-unit copies).

    Job k and job k + ``limit`` share a completion-unit copy, so k must
    have retired before k + ``limit`` issues (fig. 6).  ``make_room``
    drains oldest-first through the caller's ``drain`` callback (wait or
    retire — the stream waits for data, the graph dispatcher retires
    completion-only), counting each forced drain as a stall.
    """

    def __init__(self, limit: int):
        if limit < 1:
            raise ValueError(f"window limit must be >= 1, got {limit}")
        self.limit = limit
        self._q: Deque[Any] = collections.deque()
        self.stalls = 0

    def __len__(self) -> int:
        return len(self._q)

    def make_room(self, drain: Callable[[Any], Any]) -> None:
        while len(self._q) >= self.limit:
            drain(self._q.popleft())
            self.stalls += 1

    def push(self, handle: Any) -> None:
        self._q.append(handle)

    def popleft(self) -> Any:
        """Remove and return the oldest in-flight handle (caller drains)."""
        return self._q.popleft()

    def drain_all(self, drain: Callable[[Any], Any]) -> List[Any]:
        out = []
        while self._q:
            out.append(drain(self._q.popleft()))
        return out
