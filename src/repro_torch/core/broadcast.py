"""Hierarchical broadcast staging — the multicast selection lowered to a
data path, on the logical clusters of one device.

Twin of ``repro.core.broadcast``.  The tree half (:class:`BroadcastTree`,
:func:`build_tree`, :func:`depth_bound`, :func:`tree_from_request`) is the
reference's, unchanged: it is pure Python over cluster ids.

The data half maps clusters onto one device.  A plan's clusters are rows
of cluster-major tensors: an operand's :class:`Placement` either splits
one axis into n equal contiguous blocks, block c in row c (the
``PartitionSpec`` semantics of the reference), or replicates it, one full
copy per row.  :class:`TreeStager` executes a tree as a staging data path:
the operand crosses the host link **once**, into the root cluster's row,
then each tree level is one batched device-to-device copy between rows.
Host-link bytes drop from O(n)·size to O(1)·size.  ``reshard=True`` is
the one-call fast path: root upload, then one batched copy from the root
row to every other row.

Byte accounting: every entry point takes an optional ``stats`` object with
``h2d_bytes`` / ``d2d_bytes`` counters (duck-typed —
:class:`repro_torch.core.offload.PlanStats` qualifies).  The counters are
the **logical link bytes of the staging strategy**, and equal the
reference's for the same calls.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import (
    Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple,
)

import numpy as np
import torch

from repro_torch.core import multicast as mc

Edge = Tuple[int, int]          # (src cluster id, dst cluster id)

#: every replicated-placement strategy the runtime understands (the single
#: source of truth — ``repro_torch.core.offload`` re-exports it, the serve engine
#: accepts the non-baseline subset)
STAGING_MODES = ("direct", "host_fanout", "tree", "tree_reshard")
#: the strategies that route through the fan-out tree
TREE_MODES = ("tree", "tree_reshard")
#: the two explicit data-path strategies the staging cost model covers
DATA_PATH_MODES = ("host_fanout", "tree")


@dataclasses.dataclass(frozen=True)
class BroadcastTree:
    """A levelled fan-out tree over a cluster selection.

    ``levels[k]`` holds the (src, dst) copies of step k; all edges of a
    level are independent (no node appears twice in one level, and every
    source already holds the data), so a level is one parallel round of
    transfers.  Every selected cluster is reached exactly once: the tree
    has ``len(clusters) - 1`` edges and each non-root node one parent.
    """

    clusters: Tuple[int, ...]                      # sorted selection
    root: int
    levels: Tuple[Tuple[Edge, ...], ...]

    @property
    def depth(self) -> int:
        return len(self.levels)

    @property
    def edges(self) -> Tuple[Edge, ...]:
        return tuple(e for level in self.levels for e in level)

    @property
    def n_edges(self) -> int:
        return len(self.clusters) - 1

    def parents(self) -> Dict[int, int]:
        """dst -> src over every edge (each dst appears exactly once)."""
        return {d: s for s, d in self.edges}

    def reached(self) -> Tuple[int, ...]:
        """Every cluster the broadcast covers (root + all edge dsts)."""
        return tuple(sorted({self.root} | {d for _, d in self.edges}))

    def cross_quadrant_edges(
        self, clusters_per_quadrant: int = mc.CLUSTERS_PER_QUADRANT
    ) -> int:
        """How many tree edges cross a quadrant boundary.

        Cross-quadrant hops pay the long narrow-network latency (§5.5 C),
        so this is the placement-sensitive part of the tree staging cost.
        The fabric scheduler's placement objective is the full
        discrete-event staging cost (``simulate_staging``, which resolves
        these edges among everything else); this count is the cheap,
        testable proxy for it — a window inside one quadrant has zero, a
        straddling window at least one — used to assert placement
        quality.
        """
        return sum(
            1 for s, d in self.edges
            if s // clusters_per_quadrant != d // clusters_per_quadrant
        )


def depth_bound(cluster_ids: Iterable[int],
                clusters_per_quadrant: int = mc.CLUSTERS_PER_QUADRANT) -> int:
    """``ceil(log2 Q) + ceil(log2 C_max)`` for a selection: the fig.-5 bound
    (Q = selected quadrants, C_max = most clusters selected in one quadrant).
    """
    by_q: Dict[int, int] = {}
    for c in set(cluster_ids):
        by_q[c // clusters_per_quadrant] = by_q.get(c // clusters_per_quadrant, 0) + 1
    if not by_q:
        return 0
    return (math.ceil(math.log2(len(by_q)))
            + math.ceil(math.log2(max(by_q.values()))))


def _binomial_rounds(have: List[int], todo: List[int]) -> List[List[Edge]]:
    """Recursive-doubling rounds: every holder forwards to one receiver."""
    rounds: List[List[Edge]] = []
    while todo:
        edges: List[Edge] = []
        for src in list(have):
            if not todo:
                break
            dst = todo.pop(0)
            edges.append((src, dst))
            have.append(dst)
        rounds.append(edges)
    return rounds


def build_tree(cluster_ids: Iterable[int],
               clusters_per_quadrant: int = mc.CLUSTERS_PER_QUADRANT
               ) -> BroadcastTree:
    """Derive the quadrant-aware fan-out tree for a cluster selection.

    Phase 1 broadcasts across quadrant representatives (the lowest selected
    cluster of each quadrant), phase 2 broadcasts within every quadrant in
    parallel.  Works for any non-empty selection — degenerate n=1 (no
    edges) and non-power-of-two selections included.
    """
    ids = sorted(set(int(c) for c in cluster_ids))
    if not ids:
        raise ValueError("empty cluster selection")
    if ids[0] < 0:
        raise ValueError(f"negative cluster id {ids[0]}")
    by_q: Dict[int, List[int]] = {}
    for c in ids:
        by_q.setdefault(c // clusters_per_quadrant, []).append(c)
    reps = [members[0] for _, members in sorted(by_q.items())]
    root = ids[0]                     # lowest id == its quadrant's rep
    assert root in reps
    inter = _binomial_rounds([root], [r for r in reps if r != root])
    # Phase 2: all quadrants fan out in parallel — one binomial broadcast
    # per quadrant, merged round-wise into shared levels.
    per_q = [_binomial_rounds([members[0]], members[1:])
             for _, members in sorted(by_q.items())]
    intra = [sum(rounds, []) for rounds in
             itertools.zip_longest(*per_q, fillvalue=[])]
    levels = tuple(tuple(lv) for lv in inter + intra if lv)
    return BroadcastTree(tuple(ids), root, levels)


def tree_from_request(req: mc.MulticastRequest,
                      num_clusters: int = mc.NUM_CLUSTERS,
                      clusters_per_quadrant: int = mc.CLUSTERS_PER_QUADRANT
                      ) -> BroadcastTree:
    """The fan-out tree of an address-mask multicast request (fig. 5)."""
    ids = mc.decode_cluster_selection(req, num_clusters)
    if not ids:
        raise ValueError(f"request {req} selects no clusters")
    return build_tree(ids, clusters_per_quadrant)




# ---------------------------------------------------------------------------
# The staging data path: clusters as rows of one device's tensors.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    """How an operand lies on a plan's ``n`` clusters — the port's twin of
    a ``NamedSharding`` over a 1-D cluster mesh.

    ``axis=None`` replicates: every cluster holds the full array.  Else
    ``axis`` is split into n equal contiguous blocks and cluster c holds
    block c.  On the device the operand is always cluster-major:
    ``(n, *shard_shape)``.
    """

    n: int
    axis: Optional[int] = None

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        shape = tuple(shape)
        if self.axis is None:
            return shape
        if shape[self.axis] % self.n:
            raise ValueError(
                f"axis {self.axis} ({shape[self.axis]}) not divisible by "
                f"{self.n} clusters")
        return (shape[:self.axis] + (shape[self.axis] // self.n,)
                + shape[self.axis + 1:])

    def to_clusters(self, arr: np.ndarray) -> np.ndarray:
        """The host array in cluster-major layout (a view where possible;
        a replicated array is a broadcast view)."""
        arr = np.asarray(arr)
        if self.axis is None:
            return np.broadcast_to(arr, (self.n,) + arr.shape)
        a = self.axis
        self.shard_shape(arr.shape)
        split = arr.reshape(arr.shape[:a] + (self.n, arr.shape[a] // self.n)
                            + arr.shape[a + 1:])
        return np.moveaxis(split, a, 0)

    def from_clusters(self, t: torch.Tensor) -> torch.Tensor:
        """A cluster-major tensor in the global layout (cluster 0's copy
        of a replicated one)."""
        if self.axis is None:
            return t[0]
        moved = t.movedim(0, self.axis)
        a = self.axis
        return moved.reshape(moved.shape[:a] + (-1,) + moved.shape[a + 2:])

    def tensor_to_clusters(self, t: torch.Tensor) -> torch.Tensor:
        """A global-layout device tensor in cluster-major layout — the
        device-side twin of :meth:`to_clusters`.  A view of ``t`` (a
        replicated placement is a stride-0 expansion), never a copy."""
        if self.axis is None:
            return t.unsqueeze(0).expand((self.n,) + tuple(t.shape))
        a = self.axis
        self.shard_shape(t.shape)
        split = t.reshape(tuple(t.shape[:a]) + (self.n, t.shape[a] // self.n)
                          + tuple(t.shape[a + 1:]))
        return split.movedim(a, 0)


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``arr``'s data (copied only when it must be:
    non-contiguous or read-only arrays)."""
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous or not arr.flags.writeable:
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr)


def staging_source(arr: np.ndarray, device: torch.device,
                   pinned: bool = False) -> torch.Tensor:
    """The host side of an upload to ``device``: ``arr``'s data, copied
    into page-locked memory when ``pinned`` and the device is a card, so
    the copy can run asynchronously on the current stream (the caller's
    array may change as soon as this returns)."""
    src = host_tensor(arr)
    if pinned and device.type == "cuda":
        src = src.pin_memory()
    return src


def upload(arr: np.ndarray, device: torch.device,
           pinned: bool = False) -> torch.Tensor:
    """One host->device transfer into a fresh buffer (never an alias of the
    caller's array, on the CPU too); ``pinned`` makes it asynchronous on
    a card (:func:`staging_source`)."""
    src = staging_source(arr, device, pinned)
    return torch.empty(src.shape, dtype=src.dtype, device=device).copy_(
        src, non_blocking=pinned)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TreeStager:
    """Executes a :class:`BroadcastTree` as a replicated-operand data path.

    Row ``i`` of a staged tensor realizes ``cluster_ids[i]``; the stager
    uploads once into the root's row and fans out level by level.  One
    stager per (selection, device) — plans cache it.
    """

    def __init__(self, device: torch.device,
                 cluster_ids: Sequence[int],
                 clusters_per_quadrant: int = mc.CLUSTERS_PER_QUADRANT):
        ids = [int(c) for c in cluster_ids]
        self.device = torch.device(device)
        self.tree = build_tree(ids, clusters_per_quadrant)
        row = {c: i for i, c in enumerate(ids)}
        self._n = len(ids)
        self._root = row[self.tree.root]

        def rows(xs: Sequence[int]) -> torch.Tensor:
            return torch.tensor(xs, dtype=torch.long, device=self.device)

        # per level: (source rows, destination rows), on the device once
        self._levels = [(rows([row[s] for s, _ in lv]),
                         rows([row[d] for _, d in lv]))
                        for lv in self.tree.levels]
        self._others = rows([i for i in range(self._n) if i != self._root])
        self._root_row = rows([self._root])

    def put_replicated(self, arr: np.ndarray, *, reshard: bool = False,
                       stats: Optional[Any] = None,
                       pinned: bool = False) -> torch.Tensor:
        """Stage ``arr`` replicated onto the clusters with ONE host upload.

        Returns the ``(n, *arr.shape)`` cluster-major tensor.
        ``stats.h2d_bytes`` grows by ``arr.nbytes`` and
        ``stats.d2d_bytes`` by ``(n-1) * arr.nbytes`` either way — the
        logical link bytes of the strategy.  ``pinned`` uploads from
        page-locked memory, asynchronously (:func:`staging_source`).
        """
        src = staging_source(arr, self.device, pinned)
        out = torch.empty((self._n,) + tuple(src.shape), dtype=src.dtype,
                          device=self.device)
        out[self._root].copy_(src, non_blocking=pinned)
        if stats is not None:
            stats.h2d_bytes += src.nbytes
            stats.d2d_bytes += src.nbytes * (self._n - 1)
        if self._n == 1:
            return out
        if reshard:
            out[self._others] = out.index_select(0, self._root_row)
            return out
        for src_rows, dst_rows in self._levels:   # one batched copy a level
            out[dst_rows] = out[src_rows]
        return out

    def forward_replicated(self, value: torch.Tensor, *,
                           stats: Optional[Any] = None) -> torch.Tensor:
        """Fan a *device-resident* producer result out replicated — the
        forwarding counterpart of :meth:`put_replicated`.

        ``value`` is a global-layout tensor on the device (a dependent
        job's producer output, possibly still being computed: the copies
        queue behind it on the stream).  One device copy puts it in the
        root's row, then the same levelled fan-out runs; the host link is
        never touched, so ``stats.h2d_bytes`` stays put and the whole
        ``n * nbytes`` logical movement lands in ``stats.forward_bytes``
        (and ``d2d_bytes`` — forwarding is fan-out traffic too), as in the
        reference.  Returns the ``(n, *value.shape)`` cluster-major tensor.
        """
        n = self._n
        nbytes = int(value.nbytes)
        out = torch.empty((n,) + tuple(value.shape), dtype=value.dtype,
                          device=self.device)
        out[self._root].copy_(value)
        if stats is not None:
            stats.forward_bytes += nbytes * n
            stats.d2d_bytes += nbytes * n
        for src_rows, dst_rows in self._levels:   # one batched copy a level
            out[dst_rows] = out[src_rows]
        return out


def is_replicated(placement: Placement) -> bool:
    """True iff ``placement`` puts the full array on every cluster."""
    return placement.axis is None


def placement_bytes(arr: np.ndarray, placement: Placement) -> int:
    """Logical host-link bytes of a *direct* placement: per-cluster shard
    bytes × cluster count.  A replicated array costs n·size, a sharded
    operand exactly size."""
    arr = np.asarray(arr)
    shard = placement.shard_shape(arr.shape)
    per = int(np.prod(shard, dtype=np.int64)) * arr.dtype.itemsize
    return per * placement.n


def place_pytree(tree: Any, placements: Any, stager: TreeStager,
                 *, reshard: bool = False, stats: Optional[Any] = None) -> Any:
    """Place a nested mapping of host arrays, routing replicated leaves
    through the tree.

    ``placements`` has ``tree``'s structure with one :class:`Placement` per
    leaf.  Sharded leaves cross the host link once regardless of n (each
    cluster row receives only its block), so they take the direct path;
    replicated leaves — the O(n) host-link offenders — go through
    :meth:`TreeStager.put_replicated`.  ``stats`` counts both classes, as
    the reference's ``place_pytree`` does.  Every leaf comes back
    cluster-major: ``(n, *shard_shape)``.
    """
    if isinstance(tree, Mapping):
        return {k: place_pytree(v, placements[k], stager, reshard=reshard,
                                stats=stats) for k, v in tree.items()}
    arr = np.asarray(tree)
    if is_replicated(placements):
        return stager.put_replicated(arr, reshard=reshard, stats=stats)
    if stats is not None:
        stats.h2d_bytes += placement_bytes(arr, placements)
    return upload(placements.to_clusters(arr), stager.device)
