"""Fabric scheduler — multi-tenant cluster leases over the offload fabric.

Twin of ``repro.core.fabric``.  The fabric is the logical clusters of one
device (``repro_torch.core.offload``): a lease owns a window of them, and
a session on the lease builds its runtime over exactly that window
(``OffloadRuntime(device, cluster_ids=lease.clusters)``).  Everything
else is host bookkeeping and the §6 model, as in the reference.

The paper's measurements assume one host job owns the whole 200+-core
fabric, but its own scaling data argues against that as an operating
point: offload overheads grow with n while fine-grained jobs stop
profiting from extra clusters early (fig. 7 / §5.3), so a small job on
the whole fabric wastes most of it.  ESP-style SoC research treats
accelerator tiles as *schedulable resources*, and the companion offload
work (arXiv:2404.01908) chooses offload modes from a cost model — this
module applies both ideas to the fabric itself:

* :class:`ClusterLease` — ownership of a contiguous cluster window.
  Sessions bind a lease instead of the whole fabric; disjoint leases run
  concurrently and bit-identically to sequential whole-fabric runs (the
  placements and launch programs depend only on the lease's cluster
  window).  Aligned
  power-of-two windows encode as ONE multicast request
  (:func:`repro_torch.core.multicast.encode_contiguous_window`), so the
  paper's O(1) wakeup and the fan-out staging tree stay legal per lease.
* :class:`FabricScheduler` — admits, places, queues, and resizes leases.
  Placement and slice sizing are *model-driven*: candidate windows are
  scored by the §6 cost model (dispatch + staging + compute via
  ``repro_torch.core.session.estimate`` and the quadrant-aware
  ``simulate_staging``), so a lease lands where the predicted makespan
  is smallest — e.g. inside one quadrant rather than straddling two.
* :class:`Tenant` / :class:`SchedulerPolicy` — the typed vocabulary:
  resident ``SERVE`` tenants hold a floor lease and burst between decode
  batches (``resize``), bursty ``OFFLOAD`` tenants lease for a job
  stream and release.

The multi-tenant *contention* these placements imply (every tenant's
dispatch and resume serializes on the one host core) is modeled by
:func:`repro_torch.core.simulator.simulate_fabric`.

The scheduler is *overload-robust* as well as fault-robust: leases are revocable (:meth:`FabricScheduler.preempt`
drains the victim under a §6-model drain deadline, snapshots residency
through the failover host-snapshot path, and re-places it later with
resident operands restaged through the broadcast tree — bit-identical
outputs), admission is SLO-aware (``Tenant(slo=..., priority=...)``, a
typed :class:`Overloaded` instead of silent queue growth), grant
ordering uses ``Tenant.weight`` with aging so backfill cannot starve
large requests, and pressure walks a graceful-degradation ladder
(compaction → elastic floor shrink → pow2 degrade → priority
preemption) before anything is shed.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import weakref
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.analysis import sanitizer as _san
from repro_torch.core import broadcast as bc
from repro_torch.core import multicast as mc
from repro_torch.core import simulator
from repro_torch.core.offload import resolve_device
from repro_torch.core.params import DEFAULT_PARAMS, OccamyParams
from repro_torch.core.policy import TenantKind
from repro_torch.core.scoreboard import GraphError

#: replicated-operand footprint assumed when a lease request names no job —
#: placement still prefers quadrant-local windows over straddling ones
NOMINAL_STAGE_BYTES = 64 << 10


class LeaseError(RuntimeError):
    """A lease operation on released/stale/foreign state."""


class LeaseUnavailable(LeaseError):
    """No placement satisfies the request right now (queueable)."""


class Overloaded(LeaseUnavailable):
    """Typed admission backpressure: the contention model predicts the
    request would violate its tenant's SLO (or the queue is at its
    configured depth), so the scheduler *sheds* instead of silently
    queueing.  ``retry_after_cycles`` is the model-predicted virtual
    cycles until capacity next frees — the earliest re-submit worth
    making."""

    def __init__(self, message: str, *, retry_after_cycles: float = 0.0):
        super().__init__(message)
        self.retry_after_cycles = float(retry_after_cycles)


@dataclasses.dataclass
class FabricHealth:
    """Scheduler-side recovery counters (the fabric analogue of
    :class:`repro_torch.core.faults.SessionHealth`)."""

    failed_clusters: int = 0     # clusters ever marked unhealthy
    failovers: int = 0           # leases re-placed onto healthy windows
    degradations: int = 0        # failovers that had to shrink the lease
    lost_leases: int = 0         # leases with no healthy window at all
    restaged_operands: int = 0   # resident operands re-staged on failover
    preemptions: int = 0         # leases revoked (drained + re-queued)
    migrations: int = 0          # leases moved by defragmenting compaction
    floor_shrinks: int = 0       # elastic serve floors halved under pressure
    degraded_grants: int = 0     # requests granted a smaller pow2 window
    overloaded: int = 0          # admissions shed with a typed Overloaded

    def snapshot(self) -> "FabricHealth":
        return dataclasses.replace(self)


@dataclasses.dataclass(frozen=True)
class Tenant:
    """A fabric tenant, to the scheduler's admission model.

    ``weight`` is the fair-share weight inside a priority class (grant
    ordering ages it, see :meth:`FabricScheduler._admit_pending`);
    ``priority`` is the preemption class — under a ``preemption``
    policy, higher-priority requests may revoke lower-priority leases.
    ``slo`` (virtual cycles) arms SLO admission: a request whose
    model-predicted queue wait + makespan exceeds it is shed with a
    typed :class:`Overloaded` instead of queueing.
    """

    name: str
    kind: TenantKind = TenantKind.OFFLOAD
    weight: float = 1.0          # fair-share weight within a priority class
    slo: Optional[float] = None  # max predicted wait+makespan, virtual cycles
    priority: int = 0            # preemption class; higher may revoke lower

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        object.__setattr__(self, "kind", TenantKind(self.kind))
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")
        if self.slo is not None and self.slo <= 0:
            raise ValueError(f"tenant slo must be > 0 cycles, got {self.slo}")
        object.__setattr__(self, "priority", int(self.priority))


@dataclasses.dataclass(frozen=True)
class SchedulerPolicy:
    """How the scheduler places and sizes leases.

    * ``placement`` — ``"model"`` scores every feasible contiguous window
      by the predicted staging cost of the request's operand footprint
      (quadrant-aware, ties to the lowest start); ``"first_fit"`` takes
      the lowest free window unscored.
    * ``align`` — prefer windows whose start is aligned to the largest
      power of two in the lease size, so the window encodes as a single
      multicast request and buddy-style packing limits fragmentation.
      Falls back to unaligned windows when no aligned one is free.
    * ``share_slack`` — when the model sizes a slice (``n=None`` with a
      job), any smaller candidate within ``1 + share_slack`` of the best
      predicted makespan wins, leaving head-room for co-tenants.
    * ``preemption`` — ``"off"`` keeps admission cooperative;
      ``"priority"`` arms the overload ladder: a request that cannot
      place first compacts the fabric, then shrinks elastic serve
      floors, then degrades itself to a smaller pow2 window at
      model-equal makespan, then revokes strictly-lower-priority leases
      (drain → snapshot → re-queue), before shedding.
    * ``max_queue_depth`` — ``queue=True`` requests beyond this depth
      are shed with a typed :class:`Overloaded` instead of enqueued
      (``None`` = unbounded).
    * ``aging_grants`` — starvation bound for the pending queue: once a
      blocked entry has been bypassed by this many backfill grants it
      reserves the fabric (no further backfill behind it) until it
      places.
    """

    placement: str = "model"
    align: bool = True
    share_slack: float = 0.05
    preemption: str = "off"
    max_queue_depth: Optional[int] = None
    aging_grants: int = 8

    def __post_init__(self) -> None:
        if self.placement not in ("model", "first_fit"):
            raise ValueError(
                f"placement {self.placement!r} not in ('model', 'first_fit')")
        if self.share_slack < 0:
            raise ValueError(
                f"share_slack must be >= 0, got {self.share_slack}")
        if self.preemption not in ("off", "priority"):
            raise ValueError(
                f"preemption {self.preemption!r} not in ('off', 'priority')")
        if self.max_queue_depth is not None and self.max_queue_depth < 0:
            raise ValueError(
                f"max_queue_depth must be >= 0, got {self.max_queue_depth}")
        if self.aging_grants < 1:
            raise ValueError(
                f"aging_grants must be >= 1, got {self.aging_grants}")


@dataclasses.dataclass(frozen=True)
class ClusterLease:
    """Ownership of a contiguous cluster window of the fabric.

    The window is expressed in *global* cluster ids — they key dispatch
    plans, drive quadrant-aware staging trees, and make concurrent
    sessions on disjoint leases bit-equal to sequential whole-fabric runs
    on the same selections.
    """

    lease_id: int
    tenant: str
    clusters: Tuple[int, ...]
    scheduler: Optional["FabricScheduler"] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self) -> None:
        ids = tuple(int(c) for c in self.clusters)
        if not ids:
            raise ValueError("a lease must cover at least one cluster")
        if ids != tuple(sorted(set(ids))) or ids[0] < 0:
            raise ValueError(
                f"lease clusters must be sorted, unique, non-negative "
                f"ids; got {ids}")
        object.__setattr__(self, "clusters", ids)

    @property
    def n(self) -> int:
        return len(self.clusters)

    @property
    def start(self) -> int:
        return self.clusters[0]

    @property
    def active(self) -> bool:
        """True while this exact lease is the scheduler's current grant."""
        if self.scheduler is None:
            return True          # a synthesized whole-fabric descriptor
        return self.scheduler._current(self) is self

    def requests(self) -> List[mc.MulticastRequest]:
        """The multicast cover of this lease's cluster set — ONE request
        when the window is a size-aligned power-of-two block (the
        legality the scheduler's aligned placement preserves).  Encodes
        the *actual* set, so a synthesized lease over a non-contiguous
        runtime window still covers exactly its clusters (with more
        requests)."""
        num = (self.scheduler.num_clusters if self.scheduler is not None
               else max(mc.NUM_CLUSTERS, self.clusters[-1] + 1))
        return mc.encode_cluster_selection_multi(self.clusters, num)

    def tree(self, clusters_per_quadrant: int = mc.CLUSTERS_PER_QUADRANT
             ) -> bc.BroadcastTree:
        """The lease's quadrant-aware fan-out tree (the staging path)."""
        return bc.build_tree(self.clusters, clusters_per_quadrant)

    @property
    def device(self) -> torch.device:
        """The device whose logical clusters this lease owns (the
        reference's per-cluster ``devices``)."""
        if self.scheduler is None:
            raise LeaseError("synthesized lease carries no device")
        return self.scheduler.devices_for(self.clusters)

    def release(self) -> None:
        if self.scheduler is not None:
            self.scheduler.release(self)


class PendingLease:
    """A queued lease request; ``lease`` is set when the grant lands.

    ``skipped`` counts backfill grants that bypassed this entry while it
    was blocked — the aging input to grant ordering and the head
    reservation that bounds starvation.  A pending entry produced by
    :meth:`FabricScheduler.preempt` carries ``resume_id`` (the revoked
    lease's id): its grant re-keys under that id and resumes the
    suspended session with its snapshots restaged.
    """

    def __init__(self, tenant: str, n: Optional[int],
                 clusters: Optional[Tuple[int, ...]],
                 job: Any, batch: int):
        self.tenant = tenant
        self.n = n
        self.clusters = clusters
        self.job = job
        self.batch = batch
        self.lease: Optional[ClusterLease] = None
        self.seq: int = 0                      # FIFO arrival order
        self.skipped: int = 0                  # bypassing backfill grants
        self.cancelled: bool = False
        self.resume_id: Optional[int] = None   # preempted lease to resume

    @property
    def ready(self) -> bool:
        return self.lease is not None


class FabricScheduler:
    """Admission, placement, and resizing of cluster leases.

    ``device`` makes leases executable — sessions bind them to windows of
    its ``num_clusters`` logical clusters (Occamy's 32 by default);
    ``device=None`` means the card and raises when none is present.  With
    ``num_clusters`` alone and no device the scheduler runs model-only
    (the model-only mode).  Placement candidates are
    contiguous free windows; the ``"model"`` policy scores them with the
    quadrant-aware staging model, slice sizing (``n=None`` + ``job``)
    minimizes the predicted makespan of the submitted batch.
    """

    def __init__(self, device: Union[None, str, torch.device] = None, *,
                 num_clusters: Optional[int] = None,
                 params: OccamyParams = DEFAULT_PARAMS,
                 policy: SchedulerPolicy = SchedulerPolicy()):
        # model-only: a cluster count and no device (the reference's
        # num_clusters-without-devices mode); otherwise the card by default
        self._device: Optional[torch.device] = (
            None if device is None and num_clusters is not None
            else resolve_device(device))
        if num_clusters is None:
            num_clusters = DEFAULT_PARAMS.num_clusters
        if num_clusters < 1:
            raise ValueError(f"num_clusters must be >= 1, got {num_clusters}")
        self.num_clusters = int(num_clusters)
        self.params = params
        self.policy = policy
        self._owner: Dict[int, int] = {}          # cluster -> lease_id
        self._leases: Dict[int, ClusterLease] = {}
        self._tenants: Dict[str, Tenant] = {}
        self._pending: Deque[PendingLease] = collections.deque()
        self._next_id = itertools.count(1)
        self._next_seq = itertools.count(1)       # pending arrival order
        self._unhealthy: set = set()              # failed global cluster ids
        self._health = FabricHealth()
        # lease_id -> weakref to the bound Session (failover callback)
        self._sessions: Dict[int, Any] = {}
        # lease_id -> (job, batch) as granted — drain deadlines + ETAs
        self._grant_info: Dict[int, Tuple[Any, int]] = {}
        # lease_id -> predicted makespan at grant (admission ETA model)
        self._eta: Dict[int, float] = {}
        # lease_id -> elastic floor (serve tenants; pressure ladder rung 2)
        self._elastic: Dict[int, int] = {}
        self._hold_admit = False                  # defer grants mid-ladder

    # -- introspection ------------------------------------------------------

    @property
    def leases(self) -> Tuple[ClusterLease, ...]:
        return tuple(self._leases[i] for i in sorted(self._leases))

    @property
    def pending(self) -> Tuple[PendingLease, ...]:
        return tuple(self._pending)

    def free_clusters(self) -> Tuple[int, ...]:
        return tuple(c for c in range(self.num_clusters)
                     if c not in self._owner and c not in self._unhealthy)

    def unhealthy_clusters(self) -> Tuple[int, ...]:
        return tuple(sorted(self._unhealthy))

    def health(self) -> FabricHealth:
        """A snapshot of the scheduler's recovery counters."""
        return self._health.snapshot()

    def current_lease(self, lease: ClusterLease) -> Optional[ClusterLease]:
        """The scheduler's current grant for ``lease``'s id (the lease
        object a failover or resize replaced it with), or ``None`` when
        the lease is gone — holders refresh stale references through
        this instead of keying scheduler calls on a dead object."""
        return self._leases.get(lease.lease_id)

    def tenant(self, name: str) -> Optional[Tenant]:
        return self._tenants.get(name)

    @property
    def device(self) -> Optional[torch.device]:
        """The device the fabric lives on (``None`` when model-only)."""
        return self._device

    def devices_for(self, clusters: Sequence[int]) -> torch.device:
        """What a session needs to run on ``clusters``: the device whose
        logical clusters they are (the runtime is built as
        ``OffloadRuntime(device, cluster_ids=clusters)``)."""
        if self._device is None:
            raise LeaseError(
                "model-only scheduler (constructed with num_clusters, no "
                "device) cannot back executable leases")
        bad = [c for c in clusters if not 0 <= c < self.num_clusters]
        if bad:
            raise LeaseError(
                f"clusters {bad} outside the {self.num_clusters}-cluster "
                "fabric")
        return self._device

    def _current(self, lease: ClusterLease) -> Optional[ClusterLease]:
        return self._leases.get(lease.lease_id)

    # -- placement ----------------------------------------------------------

    def _free_runs(self) -> List[Tuple[int, int]]:
        """Contiguous free runs as (start, length), ascending."""
        runs: List[Tuple[int, int]] = []
        start = None
        for c in range(self.num_clusters + 1):
            free = (c < self.num_clusters and c not in self._owner
                    and c not in self._unhealthy)
            if free and start is None:
                start = c
            elif not free and start is not None:
                runs.append((start, c - start))
                start = None
        return runs

    def _windows(self, n: int) -> List[Tuple[int, ...]]:
        """Feasible contiguous windows of size ``n``, aligned-first."""
        all_starts = [s + k for s, length in self._free_runs()
                      for k in range(length - n + 1)]
        if not all_starts:
            return []
        starts = all_starts
        if self.policy.align:
            align = 1 << (n.bit_length() - 1)     # largest pow2 <= n
            aligned = [s for s in all_starts if s % align == 0]
            starts = aligned or all_starts
        return [tuple(range(s, s + n)) for s in starts]

    def placement_cost(self, clusters: Sequence[int],
                       stage_bytes: int = NOMINAL_STAGE_BYTES) -> float:
        """Predicted staging cycles of one replicated operand on this
        window — the placement-sensitive model term (quadrant-aware tree
        legs; windows inside one quadrant beat straddling ones)."""
        return simulator.simulate_staging(
            max(1, stage_bytes), list(clusters), "tree", self.params)

    def _stage_bytes(self, job: Any) -> int:
        if job is None:
            return NOMINAL_STAGE_BYTES
        from repro_torch.core.session import Planner
        return max(1, Planner(self.params).replicated_bytes(job))

    def predict_makespan(self, job: Any, clusters: Sequence[int],
                         batch: int = 1) -> float:
        """§6 model of a batch of ``job`` on this window: first launch
        end-to-end plus the amortized per-job pipeline period for the
        rest (dispatch + staging + compute, placement-aware)."""
        from repro_torch.core.session import estimate
        est = estimate(job, clusters=list(clusters), batch=batch,
                       params=self.params)
        stage = est.staging_cycles.get("direct", 0.0)
        return est.job_cycles + stage + max(0, batch - 1) * est.per_job_cycles

    def _place(self, n: int, job: Any = None, batch: int = 1
               ) -> Optional[Tuple[int, ...]]:
        windows = self._windows(n)
        if not windows:
            return None
        if self.policy.placement == "first_fit":
            return min(windows, key=lambda w: w[0])
        nbytes = self._stage_bytes(job)
        return min(windows,
                   key=lambda w: (self.placement_cost(w, nbytes), w[0]))

    def _pick_slice(self, job: Any, batch: int) -> Optional[Tuple[int, ...]]:
        """Model-driven slice sizing: among power-of-two sizes that fit
        the free fabric, place each candidate and keep the smallest one
        whose predicted makespan is within ``1 + share_slack`` of the
        best — small enough to share, big enough to be near-optimal."""
        largest = max((length for _, length in self._free_runs()),
                      default=0)
        if largest < 1:
            return None
        sizes = [1 << k for k in range(largest.bit_length())
                 if (1 << k) <= largest]
        scored: List[Tuple[float, int, Tuple[int, ...]]] = []
        for n in sizes:
            window = self._place(n, job=job, batch=batch)
            if window is not None:
                scored.append(
                    (self.predict_makespan(job, window, batch), n, window))
        if not scored:
            return None
        best = min(s[0] for s in scored)
        eligible = [s for s in scored
                    if s[0] <= best * (1.0 + self.policy.share_slack)]
        return min(eligible, key=lambda s: (s[1], s[0]))[2]

    # -- the lease lifecycle ------------------------------------------------

    def request(self, tenant: Union[str, Tenant],
                n: Optional[int] = None, *,
                clusters: Optional[Sequence[int]] = None,
                job: Any = None,
                batch: int = 1,
                queue: bool = False
                ) -> Union[ClusterLease, PendingLease]:
        """Admit a lease request and place it.

        Exactly one sizing input: ``n`` (place a window of that size),
        ``clusters`` (an explicit global window — rejected when it
        overlaps a live lease), or ``job`` alone (the model picks the
        slice size for ``batch`` instances).  When no placement fits
        and ``policy.preemption`` is armed, the overload ladder runs
        (compact → shrink elastic floors → degrade to a smaller pow2 at
        model-equal makespan → revoke lower-priority leases) before the
        request queues or sheds.  With no placement, raises
        :class:`LeaseUnavailable` — or, with ``queue=True``, returns a
        :class:`PendingLease` granted in weighted-aging priority order
        as capacity frees, unless admission control sheds the request
        with a typed :class:`Overloaded` (queue at ``max_queue_depth``,
        or the contention model predicts the tenant's ``slo`` would be
        violated).
        """
        tenant = (tenant if isinstance(tenant, Tenant)
                  else self._tenants.get(tenant, Tenant(tenant)))
        self._tenants[tenant.name] = tenant
        if clusters is not None and n is not None:
            raise ValueError("give n or clusters, not both")
        if clusters is not None:
            window = tuple(sorted(int(c) for c in clusters))
            if not window:
                raise ValueError("empty cluster selection")
            if window != tuple(range(window[0], window[0] + len(window))):
                raise ValueError(
                    f"lease windows are contiguous; {window} is not")
            if window[-1] >= self.num_clusters or window[0] < 0:
                raise ValueError(
                    f"clusters {window} outside the "
                    f"{self.num_clusters}-cluster fabric")
            sick = [c for c in window if c in self._unhealthy]
            if sick:
                raise LeaseUnavailable(
                    f"clusters {sick} are marked unhealthy "
                    f"(fail_clusters); request a different window")
            taken = [c for c in window if c in self._owner]
            if taken:
                holders = sorted({self._leases[self._owner[c]].tenant
                                  for c in taken})
                if queue:
                    return self._enqueue(tenant, None, window, job,
                                         batch)
                raise LeaseUnavailable(
                    f"clusters {taken} already leased (by "
                    f"{', '.join(holders)})")
            return self._grant(tenant.name, window, job=job, batch=batch)
        if n is not None:
            if n < 1:
                raise ValueError(f"lease size must be >= 1, got {n}")
            if n > self.num_clusters:
                raise ValueError(
                    f"lease of {n} clusters exceeds the "
                    f"{self.num_clusters}-cluster fabric")
            window = self._place(n, job=job, batch=batch)
        elif job is not None:
            window = self._pick_slice(job, batch)
        else:
            raise ValueError("give one of n / clusters / job")
        if window is None and self.policy.preemption != "off":
            window = self._pressure_place(tenant, n, job, batch)
            if window is not None:
                lease = self._grant(tenant.name, window, job=job,
                                    batch=batch)
                # preempted victims / queued entries take what's left
                self._admit_pending()
                return lease
        if window is None:
            if queue:
                return self._enqueue(tenant, n, None, job, batch)
            raise LeaseUnavailable(
                f"no contiguous window of "
                f"{n if n is not None else 'model-sized'} free clusters "
                f"(free: {self.free_clusters()})")
        return self._grant(tenant.name, window, job=job, batch=batch)

    # -- admission control ---------------------------------------------------

    def predict_retry_after(self, job: Any = None, batch: int = 1) -> float:
        """Model-predicted virtual cycles until fabric capacity next
        frees: the smallest grant-time predicted makespan among live
        leases (the first lease the §6 model expects to complete).
        Carried on :class:`Overloaded` so shed tenants know the
        earliest re-submit worth making."""
        etas = [self._eta[i] for i in self._leases if i in self._eta]
        return min(etas, default=0.0)

    def _admission_gate(self, tenant: Tenant, n: Optional[int],
                        job: Any, batch: int) -> None:
        """Shed (typed ``Overloaded``) instead of queueing when the
        queue is at depth or the contention model predicts the
        tenant's SLO cannot be met: predicted queue wait (smallest
        live-lease ETA) plus the request's own predicted makespan on a
        hypothetical freed window must fit inside ``tenant.slo``."""
        pol = self.policy
        if (pol.max_queue_depth is not None
                and len(self._pending) >= pol.max_queue_depth):
            self._health.overloaded += 1
            raise Overloaded(
                f"pending queue at max_queue_depth={pol.max_queue_depth}; "
                f"request shed",
                retry_after_cycles=self.predict_retry_after(job, batch))
        if tenant.slo is None:
            return
        wait = self.predict_retry_after(job, batch)
        own = 0.0
        if job is not None:
            size = n if n is not None else 1
            hypothetical = tuple(range(min(size, self.num_clusters)))
            own = self.predict_makespan(job, hypothetical, batch)
        if wait + own > tenant.slo:
            self._health.overloaded += 1
            raise Overloaded(
                f"tenant {tenant.name!r} slo={tenant.slo:.0f} cycles < "
                f"predicted wait {wait:.0f} + makespan {own:.0f}; "
                f"request shed",
                retry_after_cycles=wait)

    def _enqueue(self, tenant: Tenant, n: Optional[int],
                 clusters: Optional[Tuple[int, ...]], job: Any,
                 batch: int) -> PendingLease:
        self._admission_gate(tenant, n if n is not None else
                             (len(clusters) if clusters else None),
                             job, batch)
        pend = PendingLease(tenant.name, n, clusters, job, batch)
        pend.seq = next(self._next_seq)
        self._pending.append(pend)
        return pend

    def cancel(self, pending: PendingLease) -> None:
        """Withdraw a queued request.  Without this a dead tenant's
        entry pins the queue (and, once aged, reserves the fabric)
        forever.  Raises :class:`LeaseError` if the request was already
        granted (release the lease instead), already cancelled, or was
        never queued here."""
        if pending.ready:
            raise LeaseError(
                f"pending request for tenant {pending.tenant!r} was "
                "already granted; release the lease instead")
        if pending.cancelled or pending not in self._pending:
            raise LeaseError(
                f"pending request for tenant {pending.tenant!r} is not "
                "queued on this scheduler")
        self._pending.remove(pending)
        pending.cancelled = True
        # a cancelled aged head may have been reserving the fabric
        self._admit_pending()

    def _grant(self, tenant: str, window: Tuple[int, ...], *,
               job: Any = None, batch: int = 1,
               lease_id: Optional[int] = None) -> ClusterLease:
        lease = ClusterLease(
            lease_id if lease_id is not None else next(self._next_id),
            tenant, window, scheduler=self)
        s = _san.active()
        if s is not None:
            s.lease_grant(lease.lease_id, tuple(window), self._owner)
        for c in window:
            self._owner[c] = lease.lease_id
        self._leases[lease.lease_id] = lease
        self._grant_info[lease.lease_id] = (job, batch)
        if job is not None:
            self._eta[lease.lease_id] = self.predict_makespan(
                job, window, batch)
        else:
            self._eta[lease.lease_id] = self.placement_cost(window)
        return lease

    def _forget(self, lease_id: int) -> None:
        self._leases.pop(lease_id, None)
        self._grant_info.pop(lease_id, None)
        self._eta.pop(lease_id, None)
        self._elastic.pop(lease_id, None)

    def release(self, lease: ClusterLease) -> None:
        """Return the lease's clusters and grant queued requests."""
        current = self._current(lease)
        if current is None:
            raise LeaseError(f"lease {lease.lease_id} is not active")
        if current is not lease and current != lease:
            raise LeaseError(
                f"stale lease object for id {lease.lease_id} (it was "
                "resized; release the current one)")
        for c in current.clusters:
            self._owner.pop(c, None)
        self._forget(lease.lease_id)
        self._admit_pending()

    def _rank(self, pend: PendingLease) -> Tuple[int, float, int]:
        """Grant order: priority class desc, aged fair-share weight
        desc (``weight × (1 + skipped)`` — every bypassing backfill
        grant raises a blocked entry's effective weight), FIFO last."""
        ten = self._tenants.get(pend.tenant, Tenant(pend.tenant))
        return (-ten.priority, -ten.weight * (1.0 + pend.skipped), pend.seq)

    def _try_place(self, pend: PendingLease) -> Optional[Tuple[int, ...]]:
        if pend.clusters is not None:
            if any(c in self._owner or c in self._unhealthy
                   for c in pend.clusters):
                return None
            return pend.clusters
        if pend.n is not None:
            return self._place(pend.n, job=pend.job, batch=pend.batch)
        return self._pick_slice(pend.job, pend.batch)

    def _admit_pending(self) -> None:
        """Grant queued requests in weighted-aging priority order.

        Candidates are ranked by :meth:`_rank` and re-ranked after every
        grant (each grant changes the placement state).  A grant that
        lands *behind* a blocked higher-ranked entry is backfill: it
        ages the blocked entry (``skipped += 1``).  Once the top blocked
        entry has been bypassed ``policy.aging_grants`` times it
        reserves the fabric — no further backfill is granted past it,
        so freed capacity accrues until the starved request fits.  This
        bounds head-of-line starvation at ``aging_grants`` bypasses
        (regression-tested in ``tests/test_torch_fabric.py``).
        """
        if self._hold_admit:
            return
        while True:
            for p in list(self._pending):
                if p.ready:
                    self._pending.remove(p)
            queue = sorted(self._pending, key=self._rank)
            if not queue:
                return
            blocked: List[PendingLease] = []
            granted = None
            for pend in queue:
                if (blocked
                        and blocked[0].skipped >= self.policy.aging_grants):
                    break           # head reservation: stop backfilling
                window = self._try_place(pend)
                if window is None:
                    blocked.append(pend)
                    continue
                granted = pend
                lease = self._grant(pend.tenant, window, job=pend.job,
                                    batch=pend.batch,
                                    lease_id=pend.resume_id)
                self._pending.remove(pend)
                for b in blocked:
                    b.skipped += 1
                if pend.resume_id is not None:
                    sess = self._bound_session(lease.lease_id)
                    if sess is not None:
                        self._health.restaged_operands += sess._resume(lease)
                pend.lease = lease
                break
            if granted is None:
                return

    def resize(self, lease: ClusterLease, n: int) -> ClusterLease:
        """Elastic grow/shrink — the serve tenant's burst mechanism.

        Shrinking keeps the window's start (trailing clusters return to
        the pool and queued requests are granted).  Growing extends the
        window in place when adjacent clusters are free (right first,
        then left), relocating to a fresh window only when it cannot —
        callers keying state by ``lease.clusters`` (e.g. a serve tenant's
        per-window engines) keep their warm state across a burst cycle.
        """
        current = self._current(lease)
        if current is None or (current is not lease and current != lease):
            raise LeaseError(
                f"lease {lease.lease_id} is not the scheduler's current "
                "grant (released or resized)")
        if n < 1:
            raise ValueError(f"lease size must be >= 1, got {n}")
        if n > self.num_clusters:
            raise ValueError(
                f"lease of {n} clusters exceeds the "
                f"{self.num_clusters}-cluster fabric")
        old = current.clusters
        if n == len(old):
            return current
        if n < len(old):
            window = old[:n]
            dropped = old[n:]
            replaced = dataclasses.replace(current, clusters=window)
            self._leases[current.lease_id] = replaced
            for c in dropped:
                self._owner.pop(c, None)
            self._admit_pending()
            return replaced
        grow = n - len(old)
        right = tuple(range(old[-1] + 1, old[-1] + 1 + grow))
        left = tuple(range(old[0] - grow, old[0]))
        if all(0 <= c < self.num_clusters and c not in self._owner
               and c not in self._unhealthy for c in right):
            window = old + right
        elif all(0 <= c < self.num_clusters and c not in self._owner
                 and c not in self._unhealthy for c in left):
            window = left + old
        else:
            # cannot extend in place: relocate (a fresh window scored by
            # the placement model, ignoring our own current holding)
            for c in old:
                self._owner.pop(c, None)
            window_opt = self._place(n)
            if window_opt is None and self.policy.preemption != "off":
                # the overload ladder may free room for the grown window
                # (a serve burst outranking offload churn); our own
                # holding stays out of the pool and off the victim list
                ten = self._tenants.get(current.tenant,
                                        Tenant(current.tenant))
                job, batch = self._grant_info.get(current.lease_id,
                                                  (None, 1))
                window_opt = self._pressure_place(
                    ten, n, job, batch, exclude={current.lease_id},
                    degrade=False)
            if window_opt is None:
                for c in old:           # roll back
                    self._owner[c] = current.lease_id
                raise LeaseUnavailable(
                    f"cannot grow lease {current.lease_id} to {n} "
                    f"clusters (free: {self.free_clusters()})")
            window = window_opt
        for c in old:
            self._owner.pop(c, None)
        replaced = dataclasses.replace(current, clusters=tuple(window))
        for c in replaced.clusters:
            self._owner[c] = replaced.lease_id
        self._leases[replaced.lease_id] = replaced
        # a relocation freed the old window: queued requests may fit now
        self._admit_pending()
        return replaced

    # -- preemption & the overload ladder -----------------------------------

    def drain_deadline(self, lease: ClusterLease) -> float:
        """§6-model drain deadline for revoking ``lease``: the predicted
        makespan of the work granted on it (job + staging + batch
        pipeline; nominal staging footprint when the grant named no
        job), times the retry-ladder deadline factor —
        ``deadline_factor × predict_makespan(job, window, batch)``.
        The victim's in-flight window must drain within this budget;
        jobs that miss it are the fault ladder's problem
        (:class:`repro_torch.core.faults.CompletionTimeout`), not the
        preemption path's."""
        from repro_torch.core.faults import deadline_cycles
        from repro_torch.core.policy import RetryPolicy
        job, batch = self._grant_info.get(lease.lease_id, (None, 1))
        if job is not None:
            base = self.predict_makespan(job, lease.clusters, batch)
        else:
            base = self.placement_cost(lease.clusters)
        return deadline_cycles(base, RetryPolicy())

    def preempt(self, lease: ClusterLease, *,
                queue: bool = True) -> Optional[PendingLease]:
        """Revoke ``lease``'s window now; with ``queue=True`` re-queue
        it for re-placement under the same lease id.

        The bound session is *suspended*: its in-flight window drains
        under the model-predicted :meth:`drain_deadline`, resident
        operands are snapshotted on the host via the failover snapshot
        path, and its runtimes are dropped.  The window returns to the
        pool.  When the queued entry re-places, the snapshots are
        restaged through the lease's broadcast tree and the session
        resumes — outputs are bit-identical across the preemption
        (``tests/test_torch_fabric.py`` asserts it).  With ``queue=False`` the lease
        ends permanently and the bound session is closed (see
        :meth:`revoke`).  Returns the re-placement :class:`PendingLease`
        (possibly already ``ready`` — re-placed immediately elsewhere,
        which is exactly a compaction migration), or ``None`` with
        ``queue=False``.
        """
        current = self._current(lease)
        if current is None:
            raise LeaseError(f"lease {lease.lease_id} is not active")
        deadline = self.drain_deadline(current)
        sess = self._bound_session(current.lease_id)
        if sess is not None:
            sess._suspend(deadline)
        for c in current.clusters:
            self._owner.pop(c, None)
        job, batch = self._grant_info.get(current.lease_id, (None, 1))
        n = current.n
        self._forget(current.lease_id)
        self._health.preemptions += 1
        if not queue:
            self._sessions.pop(current.lease_id, None)
            if sess is not None:
                sess._close_revoked()
            self._admit_pending()
            return None
        pend = PendingLease(current.tenant, n, None, job, batch)
        pend.seq = next(self._next_seq)
        pend.resume_id = current.lease_id
        self._pending.append(pend)
        self._admit_pending()
        return pend

    def revoke(self, lease: ClusterLease) -> None:
        """Permanently revoke ``lease``: drain the victim's in-flight
        window under the model deadline, then end the lease without
        re-queueing (the bound session is closed and the window goes to
        the pool / pending queue)."""
        self.preempt(lease, queue=False)

    def compact(self, max_moves: Optional[int] = None) -> int:
        """Defragmenting compaction: migrate leases to the lowest free
        start (revoke→re-place through the bit-exact snapshot/restage
        path) until no lease can move left, so free capacity coalesces
        into large aligned windows instead of unusable gaps.  Returns
        the number of migrations."""
        moves = 0
        while max_moves is None or moves < max_moves:
            moved = False
            for lease in sorted(self.leases, key=lambda l: l.start):
                for c in lease.clusters:
                    self._owner.pop(c, None)
                windows = self._windows(lease.n)
                target = min((w for w in windows if w[0] < lease.start),
                             key=lambda w: w[0], default=None)
                if target is None:
                    for c in lease.clusters:
                        self._owner[c] = lease.lease_id
                    continue
                self._migrate(lease, target)
                moved = True
                moves += 1
                break
            if not moved:
                break
        return moves

    def _migrate(self, lease: ClusterLease,
                 window: Tuple[int, ...]) -> ClusterLease:
        """Move ``lease`` (owners already freed by the caller) onto
        ``window``, rebinding and restaging its session in place."""
        replaced = dataclasses.replace(lease, clusters=window)
        for c in window:
            self._owner[c] = replaced.lease_id
        self._leases[replaced.lease_id] = replaced
        self._health.migrations += 1
        sess = self._bound_session(replaced.lease_id)
        if sess is not None:
            self._health.restaged_operands += sess._rebind(replaced)
        return replaced

    def register_elastic(self, lease: ClusterLease, floor: int) -> None:
        """Mark ``lease`` as an elastic serve lease with a shrinkable
        ``floor`` — the overload ladder shrinks it back to (and under
        pressure, below) the floor before revoking anything."""
        if self._current(lease) is None:
            raise LeaseError(f"lease {lease.lease_id} is not active")
        self._elastic[lease.lease_id] = max(1, int(floor))

    def unregister_elastic(self, lease: ClusterLease) -> None:
        self._elastic.pop(lease.lease_id, None)

    def elastic_floor(self, lease: ClusterLease) -> Optional[int]:
        """The scheduler's current floor for an elastic lease (pressure
        may have shrunk it below what the tenant registered)."""
        return self._elastic.get(lease.lease_id)

    def _shrink_elastic(self, exclude: frozenset = frozenset()) -> bool:
        """Pressure rung 2: shrink elastic (serve) leases back to their
        floors; if every lease already sits at its floor, halve the
        floors themselves (never below 1) — graceful degradation of
        serving capacity before anything is revoked."""
        changed = False
        for lid, floor in sorted(self._elastic.items()):
            if lid in exclude:
                continue
            lease = self._leases.get(lid)
            if lease is None:
                self._elastic.pop(lid, None)
                continue
            if lease.n > floor:
                self.resize(lease, floor)
                changed = True
        if changed:
            return True
        for lid, floor in sorted(self._elastic.items()):
            if lid in exclude or floor <= 1:
                continue
            lease = self._leases.get(lid)
            if lease is None:
                continue
            self._elastic[lid] = floor // 2
            self._health.floor_shrinks += 1
            if lease.n > floor // 2:
                self.resize(lease, floor // 2)
            changed = True
        return changed

    def _preempt_for(self, tenant: Tenant, place: Any,
                     exclude: frozenset = frozenset()
                     ) -> Optional[Tuple[int, ...]]:
        """Pressure rung 4: revoke (drain + re-queue) leases whose
        tenants sit in a strictly lower priority class — lowest
        priority, lowest weight, youngest first — one at a time, until
        ``place()`` succeeds or the victims run out.  Elastic serve
        leases are never victims (rung 2 shrinks them instead)."""
        victims = [l for l in self.leases
                   if l.lease_id not in exclude
                   and l.lease_id not in self._elastic
                   and self._tenant_of(l).priority < tenant.priority]
        victims.sort(key=lambda l: (self._tenant_of(l).priority,
                                    self._tenant_of(l).weight,
                                    -l.lease_id))
        for victim in victims:
            self.preempt(victim)
            window = place()
            if window is not None:
                return window
        return None

    def _tenant_of(self, lease: ClusterLease) -> Tenant:
        return self._tenants.get(lease.tenant, Tenant(lease.tenant))

    def _pressure_place(self, tenant: Tenant, n: Optional[int], job: Any,
                        batch: int, *, exclude: frozenset = frozenset(),
                        degrade: bool = True
                        ) -> Optional[Tuple[int, ...]]:
        """The overload ladder, run when a request cannot place under a
        ``preemption`` policy.  Rungs, least disruptive first; each is
        followed by a placement retry:

        1. **compact** — defragment so existing free capacity coalesces;
        2. **shrink elastic floors** — serve tenants give back burst
           room, then halve their floors;
        3. **degrade the request** — a smaller power-of-two window whose
           predicted makespan is model-equal (within ``share_slack``) to
           the full-size ask;
        4. **revoke lower-priority leases** — drain, snapshot, re-queue.

        Grants to the pending queue are held while the ladder runs so
        freed capacity goes to the requester first; the caller admits
        the queue right after granting."""
        def place() -> Optional[Tuple[int, ...]]:
            if n is not None:
                return self._place(n, job=job, batch=batch)
            return self._pick_slice(job, batch)

        self._hold_admit = True
        try:
            if self.compact():
                window = place()
                if window is not None:
                    return window
            if self._shrink_elastic(exclude):
                window = place()
                if window is not None:
                    return window
            if degrade and n is not None and job is not None and n > 1:
                ref = self.predict_makespan(
                    job, tuple(range(min(n, self.num_clusters))), batch)
                m = 1 << (n.bit_length() - 1)
                if m == n:
                    m //= 2
                while m >= 1:
                    window = self._place(m, job=job, batch=batch)
                    if (window is not None
                            and self.predict_makespan(job, window, batch)
                            <= ref * (1.0 + self.policy.share_slack)):
                        self._health.degraded_grants += 1
                        return window
                    m //= 2
            return self._preempt_for(tenant, place, exclude)
        finally:
            self._hold_admit = False

    # -- failure handling ---------------------------------------------------

    def fail_clusters(self, clusters: Sequence[int]
                      ) -> Tuple[ClusterLease, ...]:
        """Mark clusters unhealthy and fail over every affected lease.

        Unhealthy clusters leave the placement pool (free runs, resize
        growth, explicit windows) until :meth:`restore_clusters`.  Each
        lease that intersects the newly failed set is drained and
        re-placed on a model-scored healthy window of equal size —
        bound sessions are rebound in place and their resident operands
        re-staged through the broadcast tree from the root host
        snapshots.  When no equal-size healthy window exists the lease
        *degrades*: the largest healthy power-of-two window that fits
        (counted in :meth:`health`); with no healthy window at all the
        lease is lost and its session closed.  Returns the replacement
        leases.
        """
        bad = {int(c) for c in clusters}
        out = [c for c in bad if not (0 <= c < self.num_clusters)]
        if out:
            raise ValueError(
                f"clusters {sorted(out)} outside the "
                f"{self.num_clusters}-cluster fabric")
        newly = bad - self._unhealthy
        self._unhealthy |= newly
        self._health.failed_clusters += len(newly)
        affected = [lease for lease in self.leases
                    if set(lease.clusters) & newly]
        replaced = []
        for lease in affected:
            new_lease = self._failover(lease)
            if new_lease is not None:
                replaced.append(new_lease)
        self._admit_pending()
        return tuple(replaced)

    def restore_clusters(self, clusters: Sequence[int]) -> None:
        """Return repaired clusters to the placement pool (queued
        requests may be granted immediately)."""
        self._unhealthy -= {int(c) for c in clusters}
        self._admit_pending()

    def _failover(self, lease: ClusterLease) -> Optional[ClusterLease]:
        """Re-place one lease off the unhealthy set, shrinking if needed."""
        for c in lease.clusters:
            self._owner.pop(c, None)
        n = lease.n
        window = self._place(n)
        degraded = False
        while window is None and n > 1:
            # graceful degradation: the largest pow2 healthy window left
            n //= 2
            window = self._place(n)
            degraded = window is not None
        sess = self._bound_session(lease.lease_id)
        if window is None:
            self._forget(lease.lease_id)
            self._sessions.pop(lease.lease_id, None)
            self._health.lost_leases += 1
            if sess is not None:
                sess._rebind(None)
            return None
        replaced = dataclasses.replace(lease, clusters=window)
        for c in window:
            self._owner[c] = replaced.lease_id
        self._leases[replaced.lease_id] = replaced
        self._health.failovers += 1
        if degraded:
            self._health.degradations += 1
        if sess is not None:
            self._health.restaged_operands += sess._rebind(replaced)
        return replaced

    # -- session glue -------------------------------------------------------

    def _bind_session(self, lease: ClusterLease, session: Any) -> None:
        """Register the session owning ``lease`` for failover callbacks
        (held weakly — an abandoned session never pins the fabric)."""
        self._sessions[lease.lease_id] = weakref.ref(session)

    def _unbind_session(self, lease: ClusterLease) -> None:
        self._sessions.pop(lease.lease_id, None)

    def _bound_session(self, lease_id: int) -> Any:
        ref = self._sessions.get(lease_id)
        return ref() if ref is not None else None

    def session(self, tenant: Union[str, Tenant],
                n: Optional[int] = None, *,
                clusters: Optional[Sequence[int]] = None,
                job: Any = None,
                batch: int = 1,
                **session_kwargs: Any) -> Any:
        """Lease and open a :class:`repro_torch.core.session.Session` on it —
        the one-call tenant entry point (``session.close()`` releases
        the lease)."""
        lease = self.request(tenant, n, clusters=clusters, job=job,
                             batch=batch)
        from repro_torch.core.session import Session
        return Session(lease=lease, params=self.params, **session_kwargs)

    def submit_graph(self, nodes: Sequence[Any], *,
                     policy: Any = None) -> Any:
        """Dispatch a dependency graph spanning this fabric's leases.

        Each node names the session (and thereby the lease window) it
        dispatches through via ``GraphNode.session`` — typically one
        session per lease from :meth:`session`; nodes leaving it unset
        run on the first named session.  Delegates to
        :meth:`Session.submit_graph <repro_torch.core.session.Session.submit_graph>`
        on that session, which issues independent sub-DAGs concurrently
        across the leases' in-flight windows and forwards producer
        results device-to-device between their fabric windows (the
        cross-lease reshard counted per edge in
        ``GraphHandle.forwarded``).
        """
        nodes = list(nodes)
        if not nodes:
            raise GraphError("empty graph")
        first = next((nd.session for nd in nodes
                      if getattr(nd, "session", None) is not None), None)
        if first is None:
            raise GraphError(
                "a fabric-level graph names at least one node's session= "
                "(open one per lease with FabricScheduler.session)")
        return first.submit_graph(nodes, policy=policy)
