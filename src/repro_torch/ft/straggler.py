"""Straggler mitigation + step watchdog (twin of ``repro.ft.straggler``).

Two mechanisms, both built on the paper's completion machinery:

* ``StepWatchdog`` — host-side deadline on job completion.  The completion
  unit tells the host *which* job is late and how many arrivals are missing
  (``CompletionUnit.outstanding()``), turning "the step hangs" into an
  actionable signal: reissue, rescale, or abort.  Deadlines adapt to a
  rolling latency percentile, so slow-but-progressing steps are not killed.
* ``BackupOffload`` — speculative re-execution for the offload runtime: a
  job is dispatched to a primary cluster subset and, if the watchdog trips,
  re-dispatched to a disjoint backup subset (selected with the paper's
  address-mask encoding); the backup's result is the one returned.  This is
  the classical backup-worker defence, expressed in offload-runtime terms.

Failure injection is deterministic: a ``delay_hook`` delays the host's
observation of completion, simulating a straggling cluster without real
nondeterminism.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.jobs import PaperJob
from repro_torch.core.offload import JobHandle, OffloadRuntime


@dataclasses.dataclass
class WatchdogConfig:
    deadline_factor: float = 3.0      # × rolling p50 latency
    min_deadline_s: float = 0.05
    history: int = 32


class StepWatchdog:
    """Rolling-latency deadline tracker for dispatched jobs/steps.

    ``estimate`` seeds the cold-start deadline from a model prediction
    (e.g. a §6 ``Session.estimate`` converted to this watchdog's time
    unit): before any latency history exists the deadline is
    ``deadline_factor × estimate``.  Without a seed the cold deadline is
    unbounded — lateness is undecidable with neither a model nor a
    history, so nothing trips.
    """

    def __init__(self, cfg: Optional[WatchdogConfig] = None,
                 estimate: Optional[float] = None):
        # a fresh config per instance: a shared default instance would
        # alias cfg mutations across every watchdog in the process
        self.cfg = cfg if cfg is not None else WatchdogConfig()
        self.estimate = estimate
        self._lat: List[float] = []

    def deadline(self) -> float:
        if not self._lat:
            if self.estimate is not None:
                return max(self.cfg.min_deadline_s,
                           self.cfg.deadline_factor * self.estimate)
            return float("inf")
        p50 = float(np.median(self._lat))
        return max(self.cfg.min_deadline_s, self.cfg.deadline_factor * p50)

    def observe(self, latency_s: float) -> None:
        self._lat.append(latency_s)
        if len(self._lat) > self.cfg.history:
            self._lat.pop(0)

    def is_late(self, started_at: float, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        return (now - started_at) > self.deadline()


class BackupOffload:
    """Speculative backup execution over disjoint cluster subsets.

    The primary and backup sets are disjoint windows of the runtime's
    logical clusters.  On one device they do not race on separate
    hardware: both dispatches queue on the same card, so a reissue adds
    the backup's work behind the primary's rather than overtaking it.
    The sequence is the reference's all the same — dispatch the primary;
    on a late observation dispatch the backup and wait on it; then wait
    on the primary, so its arrivals never corrupt the completion unit.
    """

    def __init__(self, runtime: OffloadRuntime,
                 watchdog: Optional[StepWatchdog] = None,
                 delay_hook: Optional[Callable[[JobHandle], float]] = None):
        self.rt = runtime
        self.watchdog = watchdog or StepWatchdog()
        self.delay_hook = delay_hook or (lambda h: 0.0)
        self.reissues = 0

    def run(self, job: PaperJob, seed: int, primary: Sequence[int],
            backup: Sequence[int]):
        """Offload to `primary`; if the observation is late, reissue to
        `backup`.  -> (result, expected)."""
        if set(primary) & set(backup):
            raise ValueError(
                "primary and backup cluster sets must be disjoint")
        operands, expected = job.make_instance(seed)
        t0 = time.monotonic()
        h1 = self.rt.offload(job, operands, clusters=list(primary))
        # Deterministic straggler simulation: the hook returns an artificial
        # extra latency for this handle (0 = healthy).
        simulated = self.delay_hook(h1)
        late = self.watchdog.is_late(t0 - simulated, now=time.monotonic())
        if late:
            self.reissues += 1
            h2 = self.rt.offload(job, operands, clusters=list(backup))
            result = h2.wait()
            # The primary's eventual arrivals must not corrupt the unit: the
            # runtime tracked it under its own job id.
            h1.wait()
        else:
            result = h1.wait()
        self.watchdog.observe(time.monotonic() - t0 - simulated)
        return result, expected
