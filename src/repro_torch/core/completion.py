"""Job completion unit — paper §4.3, figure 6.

Twin of ``repro.core.completion``: the host-side mirror of the unit's
register semantics, plus the two device-side completion synchronizations
of the offload runtime, over the ``(n,)`` arrival vector of one launch
(one element per logical cluster):

* ``central_counter`` (baseline): the arrivals hop toward cluster 0 one
  cluster at a time — n−1 dependent single-element device operations,
  each its own launch, the analogue of the software central-counter
  barrier whose latency grows with the number of clusters (§5.5 H).
* ``unit`` (the paper's extension): one reduction over the arrival vector
  — the analogue of the CLINT job completion unit: clusters post
  arrivals, the "unit" fires once arrivals == offload register.

Both record their steps into a launch trace (a list of ``(kind, what)``
pairs): a hop is a ``"collective-permute"``, the reduction an
``"all-reduce"``, matching the HLO collectives of the reference.

The host-side :class:`CompletionUnit` reproduces fig. 6 exactly: an offload
register programmed with the expected arrival count, an arrivals counter that
auto-increments, an interrupt that fires when they match (deferred if one is
already pending), auto-reset, and multiple instances addressable by job ID
for outstanding-job tracking (§4.3: "multiple copies of this logic can be
instantiated to support multiple outstanding jobs").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.analysis import sanitizer as _san

#: one launch-trace record: (collective kind or phase, description)
TraceEntry = Tuple[str, str]


# ---------------------------------------------------------------------------
# Device-side completion synchronization (one (n,) arrival vector).
# ---------------------------------------------------------------------------


def completion_unit_arrivals(done: torch.Tensor,
                             trace: List[TraceEntry]) -> torch.Tensor:
    """The extension: one reduction == the completion unit's arrivals count."""
    trace.append(("all-reduce", "completion unit arrivals"))
    return done.sum()


def central_counter_arrivals(done: torch.Tensor,
                             trace: List[TraceEntry]) -> torch.Tensor:
    """The baseline: serialize arrivals into cluster 0 hop by hop.

    Hop k adds cluster k's running count into cluster k−1's slot, from the
    far end of the chain down to cluster 0: n−1 dependent single-element
    launches, so cluster i's arrival reaches cluster 0 after i hops, as in
    the AMO-serialized software barrier.  The returned count is cluster
    0's (only cluster 0 reads the counter in the real system).
    """
    n = done.shape[0]
    if n == 1:
        return done[0]
    count = done.clone()
    for k in range(n - 1, 0, -1):
        count[k - 1:k].add_(count[k:k + 1])
        trace.append(("collective-permute", f"counter hop {k}->{k - 1}"))
    return count[0]


# ---------------------------------------------------------------------------
# Host-side register-level model of the unit (fig. 6).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _UnitRegs:
    offload: int = 0      # expected arrivals, programmed by the host
    arrivals: int = 0     # auto-incrementing arrivals counter


class CompletionUnit:
    """Fig. 6 logic: offload/arrivals registers + IPI fire + auto-reset.

    ``n_units`` > 1 instantiates multiple copies addressed by job ID
    (supporting multiple outstanding jobs / task overlapping, §4.3).
    """

    def __init__(self, n_units: int = 1):
        self._regs: List[_UnitRegs] = [_UnitRegs() for _ in range(n_units)]
        self._pending_irq: Optional[int] = None   # job id carried as cause
        self._deferred: List[int] = []            # fired while another pending
        self._collected: set = set()              # causes drained early

    @property
    def n_units(self) -> int:
        return len(self._regs)

    def program(self, n_clusters: int, job_id: int = 0) -> None:
        """Host programs the offload register at job dispatch."""
        regs = self._regs[job_id % len(self._regs)]
        if regs.offload != 0:
            raise RuntimeError(f"unit {job_id} already tracking an offload")
        if n_clusters <= 0:
            raise ValueError("n_clusters must be positive")
        s = _san.active()
        if s is not None:
            s.unit_program(self, job_id)
        regs.offload = n_clusters
        regs.arrivals = 0

    def arrive(self, job_id: int = 0, count: int = 1) -> None:
        """A cluster writes the arrivals register (atomic increment)."""
        regs = self._regs[job_id % len(self._regs)]
        if regs.offload == 0:
            raise RuntimeError(f"arrival for unprogrammed unit {job_id}")
        regs.arrivals += count
        if regs.arrivals == regs.offload:
            # Job complete: fire (or defer) the IPI, auto-reset the counter.
            if self._pending_irq is None:
                self._pending_irq = job_id
            else:
                self._deferred.append(job_id)
            regs.offload = 0
            regs.arrivals = 0

    def pending_cause(self) -> Optional[int]:
        """The job ID carried as the interrupt cause (None = no pending IPI)."""
        return self._pending_irq

    def clear(self) -> Optional[int]:
        """Host clears the IPI; a deferred completion fires immediately after
        (fig. 6: "otherwise this will occur as soon as the previous pending
        interrupt is cleared")."""
        cause = self._pending_irq
        self._pending_irq = self._deferred.pop(0) if self._deferred else None
        return cause

    def collect(self, job_id: int) -> None:
        """Drain fired causes until ``job_id``'s completion is observed.

        Handles out-of-order ``wait()`` across multiple outstanding jobs:
        causes belonging to *other* jobs are parked and satisfy their own
        later ``collect()`` calls instead of being treated as protocol
        errors (the host-side analogue of the deferred-interrupt replay in
        fig. 6).
        """
        s = _san.active()
        if s is not None:
            s.unit_collect(self, job_id)
        if job_id in self._collected:
            self._collected.discard(job_id)
            return
        while True:
            cause = self.clear()
            if cause is None:
                raise RuntimeError(
                    f"completion for job {job_id} never fired "
                    f"(collected={sorted(self._collected)})")
            if cause == job_id:
                return
            self._collected.add(cause)

    def cancel(self, job_id: int) -> int:
        """Abandon a stuck offload: reset the unit's registers without
        firing the IPI, returning how many arrivals were still missing.

        The fault-recovery path uses this after a deadline trip — the
        register state (``outstanding()``) has already been read as the
        failure signal, and the unit must be reusable for the resubmit.
        A unit that is not tracking an offload cancels as a no-op (0).

        A cancel also *purges* the job's already-fired interrupt state:
        if its completion raced the cancel (all arrivals landed, cause
        pending or deferred behind another job's IPI — fig. 6's replay
        path), the stale cause must not fire for, or be collected by, a
        later job sharing the unit.
        """
        s = _san.active()
        if s is not None:
            s.unit_cancel(self, job_id)
        regs = self._regs[job_id % len(self._regs)]
        missing = 0
        if regs.offload != 0:
            missing = regs.offload - regs.arrivals
            regs.offload = 0
            regs.arrivals = 0
        # purge a completion that raced the cancel (the deferred-IRQ
        # replay in clear() would otherwise resurrect it later)
        if self._pending_irq == job_id:
            self._pending_irq = (self._deferred.pop(0) if self._deferred
                                 else None)
        self._deferred = [j for j in self._deferred if j != job_id]
        self._collected.discard(job_id)
        return missing

    def outstanding(self) -> Dict[int, int]:
        """job-id -> arrivals still missing, for every in-flight unit."""
        return {
            jid: r.offload - r.arrivals
            for jid, r in enumerate(self._regs)
            if r.offload > 0
        }
