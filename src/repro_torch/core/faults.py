"""Deterministic fault injection for the offload fabric.

The paper's §6 model predicts an offloaded job's runtime with < 15 %
error — so a job that overshoots its prediction is *detectably*
anomalous, and the completion unit's ``outstanding()`` register state
(fig. 6: offload register minus arrivals counter) says exactly how many
clusters never reported.  This module turns those two signals into a
testable fault-tolerance substrate:

* :class:`FaultPlan` / :class:`FaultSpec` — a seeded, explicit schedule
  of faults keyed by *dispatch index*, never by wallclock.  Every
  recovery path the plan provokes is bit-reproducible in CI.
* :class:`FaultInjector` — the runtime hook.  ``OffloadRuntime`` calls
  :meth:`FaultInjector.on_dispatch` from its dispatch tail;
  ``JobHandle.wait`` then consults the injector's per-job effect:
  missing arrivals surface as a typed :class:`CompletionTimeout`
  (after feeding the partial arrivals to the completion unit and
  cancelling the stuck register), straggle/stall delays surface as
  *virtual cycles* in the §6 model domain.
* :class:`SessionHealth` — the recovery counters a
  :class:`~repro_torch.core.session.Session` accumulates while walking the
  escalation ladder (resubmit → disjoint backup window → lease
  failover), plus the virtual-cycle timeline the ``faults`` bench
  suite checks against :func:`predict_recovery`.

Fault taxonomy (``FaultKind``):

``CLUSTER_DEATH``
    The named clusters stop arriving from ``at_dispatch`` onward —
    permanent until :meth:`FaultInjector.revive`.  Every dispatch whose
    selection intersects the dead set loses those clusters' arrivals.
``STRAGGLE``
    A multiplicative delay: the affected dispatch completes, but
    ``factor`` × the §6 predicted job cycles late.  With ``clusters``
    given the slowness is persistent (a straggler cluster); without,
    it is a one-shot delay at ``at_dispatch``.
``HOST_LINK_STALL``
    An additive delay of ``factor`` cycles on the host link (phase A/E
    leg) of the dispatch at ``at_dispatch`` — one-shot.
``LOST_ARRIVAL``
    ``count`` completion writes of the dispatch at ``at_dispatch``
    are dropped in flight — transient (the clusters are healthy; a
    resubmit succeeds).

All delays are *virtual*: they live in the model's cycle domain
(1 cycle = 1 ns at the paper's 1 GHz), not in host wallclock, so
deadline arithmetic (``deadline = estimate × factor × backoff^attempt``)
is exact and CI never sleeps.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import model as amodel
from repro_torch.core.params import DEFAULT_PARAMS, OccamyParams


class FaultKind(str, enum.Enum):
    """The fault taxonomy (module docstring)."""

    CLUSTER_DEATH = "cluster_death"
    STRAGGLE = "straggle"
    HOST_LINK_STALL = "host_link_stall"
    LOST_ARRIVAL = "lost_arrival"


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    ``at_dispatch`` indexes the injector's global dispatch counter
    (every ``_launch`` through a hooked runtime increments it — probes
    and retries count too, which keeps the schedule deterministic under
    recovery).  ``clusters`` are *global* fabric ids.  ``factor`` is the
    straggle multiplier (× predicted job cycles) or the stall's absolute
    cycles; ``count`` the number of arrivals a ``LOST_ARRIVAL`` drops.
    """

    kind: FaultKind
    at_dispatch: int = 0
    clusters: Tuple[int, ...] = ()
    factor: float = 0.0
    count: int = 1

    def __post_init__(self) -> None:
        object.__setattr__(self, "kind", FaultKind(self.kind))
        object.__setattr__(
            self, "clusters", tuple(int(c) for c in self.clusters))
        if self.at_dispatch < 0:
            raise ValueError(f"at_dispatch must be >= 0, got {self.at_dispatch}")
        if self.kind is FaultKind.CLUSTER_DEATH and not self.clusters:
            raise ValueError("CLUSTER_DEATH needs a non-empty cluster set")
        if self.kind is FaultKind.STRAGGLE and self.factor <= 0:
            raise ValueError("STRAGGLE needs factor > 0")
        if self.kind is FaultKind.HOST_LINK_STALL and self.factor <= 0:
            raise ValueError("HOST_LINK_STALL needs factor (cycles) > 0")
        if self.kind is FaultKind.LOST_ARRIVAL and self.count < 1:
            raise ValueError("LOST_ARRIVAL needs count >= 1")


class FaultPlan:
    """An ordered, immutable schedule of :class:`FaultSpec`\\ s."""

    def __init__(self, faults: Sequence[FaultSpec] = ()):
        self.faults: Tuple[FaultSpec, ...] = tuple(faults)
        for f in self.faults:
            if not isinstance(f, FaultSpec):
                raise TypeError(f"FaultPlan takes FaultSpecs, got {f!r}")

    def __iter__(self) -> Iterator[FaultSpec]:
        return iter(self.faults)

    def __len__(self) -> int:
        return len(self.faults)

    def __repr__(self) -> str:
        return f"FaultPlan({list(self.faults)!r})"

    def compose(self, *others: "FaultPlan") -> "FaultPlan":
        """Chaos composition: merge fault schedules into one plan,
        ordered by dispatch index (ties keep the operand order).  The
        ``preempt`` churn bench composes a random plan onto its arrival
        trace this way — overload handling and fault recovery share one
        injector."""
        merged = list(self.faults)
        for other in others:
            merged.extend(other.faults)
        merged.sort(key=lambda f: f.at_dispatch)
        return FaultPlan(merged)

    def __add__(self, other: "FaultPlan") -> "FaultPlan":
        if not isinstance(other, FaultPlan):
            return NotImplemented
        return self.compose(other)

    @staticmethod
    def random(seed: int, *, n_faults: int = 2, num_clusters: int = 8,
               max_dispatch: int = 4,
               kinds: Sequence[FaultKind] = tuple(FaultKind),
               max_factor: float = 8.0) -> "FaultPlan":
        """A seeded random plan — same seed, same plan, bit-for-bit."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n_faults):
            kind = FaultKind(kinds[int(rng.integers(len(kinds)))])
            at = int(rng.integers(max_dispatch))
            if kind is FaultKind.CLUSTER_DEATH:
                k = int(rng.integers(1, max(2, num_clusters // 4 + 1)))
                clusters = tuple(sorted(
                    int(c) for c in rng.choice(num_clusters, size=k,
                                               replace=False)))
                faults.append(FaultSpec(kind, at, clusters=clusters))
            elif kind is FaultKind.STRAGGLE:
                faults.append(FaultSpec(
                    kind, at, factor=float(1.0 + rng.random() * max_factor)))
            elif kind is FaultKind.HOST_LINK_STALL:
                faults.append(FaultSpec(
                    kind, at, factor=float(rng.integers(1_000, 100_000))))
            else:
                faults.append(FaultSpec(
                    kind, at, count=int(rng.integers(1, 3))))
        return FaultPlan(faults)


class CompletionTimeout(RuntimeError):
    """A dispatch's completion never fully arrived (deadline trip).

    Carries the actionable signal the escalation ladder needs: which
    job, how many arrivals are missing (the ``outstanding()`` register
    delta), and the global cluster ids of the failed selection.
    """

    def __init__(self, job_id: int, missing: int,
                 clusters: Tuple[int, ...]):
        self.job_id = job_id
        self.missing = missing
        self.clusters = tuple(clusters)
        super().__init__(
            f"job {job_id}: {missing}/{len(self.clusters)} arrivals missing "
            f"on clusters {list(self.clusters)}")


class FaultError(RuntimeError):
    """Recovery exhausted: retries, backup windows, and failover all
    failed (or were disabled by the :class:`~repro_torch.core.policy.
    RetryPolicy`)."""


@dataclasses.dataclass
class _JobEffect:
    """The injector's resolved effect on one dispatched job."""

    lost: int = 0                 # arrivals dropped
    delay_cycles: float = 0.0     # virtual lateness (model domain)


class FaultInjector:
    """Applies a :class:`FaultPlan` to a hooked runtime, deterministically.

    One injector may be shared by several runtimes (a session keys one
    runtime per config): effects are keyed by (runtime, job id) and the
    dispatch counter is global, so the schedule is a pure function of
    dispatch order — which the recovery machinery itself keeps
    deterministic (virtual-cycle deadlines, no wallclock).
    """

    def __init__(self, plan: FaultPlan,
                 params: OccamyParams = DEFAULT_PARAMS):
        if not isinstance(plan, FaultPlan):
            plan = FaultPlan(plan)
        self.plan = plan
        self.params = params
        self._dispatch = 0
        self._dead: set = set()
        self._effects: Dict[Tuple[int, int], _JobEffect] = {}
        self.injected: Dict[str, int] = {k.value: 0 for k in FaultKind}

    # -- introspection ------------------------------------------------------

    @property
    def dispatch_index(self) -> int:
        return self._dispatch

    @property
    def dead_clusters(self) -> frozenset:
        """Global ids of clusters currently dead (armed CLUSTER_DEATHs)."""
        return frozenset(self._dead)

    def revive(self, clusters: Sequence[int]) -> None:
        """Bring clusters back (the test hook for repair scenarios)."""
        self._dead -= set(int(c) for c in clusters)

    # -- the runtime hooks --------------------------------------------------

    def on_dispatch(self, runtime: Any, job_id: int,
                    cluster_ids: Sequence[int], spec: Any) -> None:
        """Called from the dispatch tail; resolves this job's effect."""
        d = self._dispatch
        self._dispatch += 1
        ids = tuple(int(c) for c in cluster_ids)
        eff = _JobEffect()
        for f in self.plan:
            if f.kind is FaultKind.CLUSTER_DEATH and f.at_dispatch == d:
                newly = set(f.clusters) - self._dead
                self._dead |= newly
                self.injected[FaultKind.CLUSTER_DEATH.value] += len(newly)
        dead_hit = [c for c in ids if c in self._dead]
        if dead_hit:
            eff.lost += len(dead_hit)
        for f in self.plan:
            if f.kind is FaultKind.STRAGGLE:
                hit = ((f.at_dispatch <= d and set(f.clusters) & set(ids))
                       if f.clusters else f.at_dispatch == d)
                if hit:
                    eff.delay_cycles += f.factor * amodel.predict_total_v2(
                        spec, len(ids), self.params)
                    self.injected[FaultKind.STRAGGLE.value] += 1
            elif (f.kind is FaultKind.HOST_LINK_STALL
                  and f.at_dispatch == d):
                eff.delay_cycles += f.factor
                self.injected[FaultKind.HOST_LINK_STALL.value] += 1
            elif f.kind is FaultKind.LOST_ARRIVAL and f.at_dispatch == d:
                eff.lost += f.count
                self.injected[FaultKind.LOST_ARRIVAL.value] += 1
        eff.lost = min(eff.lost, len(ids))
        if eff.lost or eff.delay_cycles:
            self._effects[(id(runtime), job_id)] = eff

    def lost_arrivals(self, runtime: Any, job_id: int) -> int:
        eff = self._effects.get((id(runtime), job_id))
        return eff.lost if eff is not None else 0

    def delay_cycles(self, runtime: Any, job_id: int) -> float:
        eff = self._effects.get((id(runtime), job_id))
        return eff.delay_cycles if eff is not None else 0.0


# ---------------------------------------------------------------------------
# Model-driven deadlines and the recovery-overhead closed form.
# ---------------------------------------------------------------------------


def deadline_cycles(base_cycles: float, retry: Any, attempt: int = 0
                    ) -> float:
    """The model-driven deadline of attempt ``attempt``:
    §6 predicted job cycles × ``deadline_factor`` × ``backoff^attempt``.
    This replaces ``StepWatchdog``'s cold-start heuristic — a fresh
    session knows its deadline before the first job ever runs."""
    return retry.deadline_factor * base_cycles * (retry.backoff ** attempt)


@dataclasses.dataclass
class SessionHealth:
    """Recovery counters + the virtual-cycle timeline of a session.

    ``virtual_cycles`` accumulates the modeled completion time of every
    reliable job (including trips, probes, backups) — the deterministic
    "measured" side the ``faults`` bench compares against
    :func:`predict_recovery`.
    """

    deadline_trips: int = 0
    retries: int = 0
    probes: int = 0
    backups: int = 0
    failovers: int = 0
    restages: int = 0
    degraded: int = 0
    jobs_ok: int = 0
    jobs_failed: int = 0
    virtual_cycles: float = 0.0

    def snapshot(self) -> "SessionHealth":
        return dataclasses.replace(self)


def probe_bound(n_sel: int, n_dead: int) -> int:
    """Upper bound on bisection probes to localize ``n_dead`` dead
    clusters inside a selection of ``n_sel`` (the closed form's
    approximation of the session's actual probe walk): one whole-set
    probe plus two probes per bisection level per dead cluster."""
    if n_dead <= 0:
        return 1                         # one clean probe confirms transient
    levels = max(1, math.ceil(math.log2(max(2, n_sel))))
    return 1 + 2 * levels * n_dead


def predict_recovery(job: Any, n: int, plan: FaultPlan, retry: Any,
                     params: OccamyParams = DEFAULT_PARAMS,
                     probe_n: Optional[int] = None) -> float:
    """Closed-form predicted recovery overhead (extra virtual cycles over
    the fault-free run) of ONE job on ``n`` clusters under ``plan``.

    Deliberately coarser than the session's walk — probe counts use the
    :func:`probe_bound` bisection bound and every probe is costed at the
    mean of its success/timeout cost — so the ``faults`` bench's
    model-error rows measure a real prediction, not an identity.  The
    bench gates the error < 15 %, the same bar as the paper's §6 model.
    """
    est = amodel.predict_total_v2(job.spec, n, params)
    # the probe job is tiny; its predicted cycles on the probed subsets
    # are approximated by the full-selection estimate of the probe job
    from repro_torch.core import jobs as _jobs
    probe_est = amodel.predict_total_v2(
        _jobs.make_axpy(PROBE_N).spec, max(1, (probe_n or n) // 2), params)
    overhead = 0.0
    for f in plan:
        d0 = deadline_cycles(est, retry, attempt=0)
        if f.kind is FaultKind.STRAGGLE:
            finish = est * (1.0 + f.factor)
            if finish <= d0:
                overhead += finish - est
            elif retry.backup:
                overhead += min(d0 + est, finish) - est
            else:
                overhead += finish - est
        elif f.kind is FaultKind.HOST_LINK_STALL:
            finish = est + f.factor
            if finish <= d0:
                overhead += f.factor
            elif retry.backup:
                overhead += min(d0 + est, finish) - est
            else:
                overhead += f.factor
        elif f.kind is FaultKind.LOST_ARRIVAL:
            # transient: trip (wait out the deadline), one clean probe of
            # the whole selection at its success cost (bisection never
            # starts), resubmit on the same selection
            clean_probe = amodel.predict_total_v2(
                _jobs.make_axpy(PROBE_N).spec, max(1, probe_n or n), params)
            overhead += d0 + clean_probe
        elif f.kind is FaultKind.CLUSTER_DEATH:
            n_dead = len(f.clusters)
            probes = probe_bound(n, n_dead)
            probe_cost = probes * probe_est * (1 + retry.deadline_factor) / 2
            overhead += d0 + probe_cost
    return overhead


#: probe payload size — divisible by every cluster count up to 8, so the
#: bisection probes can shard it on any subset of the test substrate
PROBE_N = 840


def probe_size(k: int) -> int:
    """The bisection probe's axpy length for a group of ``k`` clusters:
    ``PROBE_N`` wherever that divides (every k up to 8, as in the
    reference), else lcm(``PROBE_N``, k) so the group can shard it (1680
    elements at k = 16, 3360 at k = 32; the reference's probe cannot be
    planned there).  The closed-form :func:`predict_recovery` keeps
    ``PROBE_N``, as the reference's does."""
    return math.lcm(PROBE_N, k)
