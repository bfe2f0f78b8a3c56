"""Pipelined multi-job offload stream — overlap staging with execution.

Twin of ``repro.core.stream``.  The paper's companion work ("Optimizing
Offload Performance in Heterogeneous MPSoCs", arXiv:2404.01908) shows
that once the per-job offload overhead has been shrunk (multicast,
resident operands), the remaining floor is hidden by *overlapping* offload
phases of job k+1 with the execution of job k.  :class:`OffloadStream` is
that overlap for this framework's own host critical path:

* **double-buffered phase-E staging** — each ``submit()`` uploads its
  operands into the next of ``depth`` staging slots of the shared
  :class:`~repro_torch.core.offload.DispatchPlan` (``plan.stage(ops,
  slot=k)``).  On a card the upload is issued on a copy stream of the
  stream's own, from page-locked memory, and the launch stream waits on
  it only before phase F: job k+1's upload runs while job k's kernel
  occupies the device — the E(k+1) ∥ F(k) overlap of the paper's phase
  diagram (fig. 3).  (The reference gets this from JAX's asynchronous
  ``device_put``; a plain ``copy_`` from pageable memory on the launch
  stream would queue behind job k's kernel instead.)  Every staged
  buffer is handed to the launch stream (``Tensor.record_stream``), so
  the caching allocator cannot give job k's operand memory to a later
  upload while job k's kernel still reads it.  On the CPU the streams
  do not exist and the same code runs in order.
* **bounded in-flight window** — at most ``window`` jobs are outstanding,
  defaulting to the runtime's ``n_units`` completion-unit copies (fig. 6:
  one unit instance per outstanding job).  A ``submit()`` into a full
  window first drains the oldest handle (a *window stall*, counted in
  ``stats``).
* **out-of-order completion drain** — handles may be waited in any order;
  :meth:`~repro_torch.core.completion.CompletionUnit.collect` parks other
  jobs' causes, exactly as for plain asynchronous ``offload()``.

Typical use (through the session, which owns the streams)::

    sess = Session()
    handles = [sess.submit(job, ops) for ops in instances]   # pipelined
    results = [h.wait() for h in handles]                    # any order
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import multicast as mc
from repro_torch.core.jobs import PaperJob
from repro_torch.core.offload import (
    DispatchPlan, JobHandle, OffloadRuntime, _is_resident,
)
from repro_torch.core.policy import Staging, coerce_enum, warn_legacy
from repro_torch.core.scoreboard import InflightWindow


class OffloadStream:
    """An async job queue over :class:`OffloadRuntime` with pipelined
    staging.  One stream drives one (job, cluster selection) pair — the
    regime where a dispatch plan is warm and the only per-job costs left
    are staging and launch.

    Direct construction is deprecated: the session API
    (``repro_torch.api.Session``) pipelines every submit through this
    machinery with the window/depth/staging knobs carried by the typed
    ``OffloadPolicy`` (and picked by the planner under ``AUTO``).
    """

    def __init__(self, runtime: OffloadRuntime, job: PaperJob, *,
                 n: Optional[int] = None,
                 request: Optional[mc.MulticastRequest] = None,
                 clusters: Optional[Sequence[int]] = None,
                 depth: int = 2,
                 window: Optional[int] = None,
                 staging: Optional[Staging] = None,
                 _warn: bool = True):
        if _warn:
            warn_legacy("direct OffloadStream construction",
                        "Session.submit(job, operands, policy=...)")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if staging is not None:
            # enum members pass silently; raw strings warn (legacy surface)
            staging = coerce_enum(Staging, staging, "staging",
                                  warn_legacy=True)
        self.runtime = runtime
        self.job = job
        self._sel = dict(n=n, request=request, clusters=clusters)
        self.depth = depth
        #: staging strategy for slot uploads (None = the runtime default)
        self.staging = staging
        # the window is capped by the completion-unit copies: job k and job
        # k + n_units share a unit, so k must have completed first — the
        # same InflightWindow bound the graph dispatcher uses (fig. 6)
        self.window = min(window or runtime.unit.n_units,
                          runtime.unit.n_units)
        self.plan: Optional[DispatchPlan] = None
        self._inflight = InflightWindow(self.window)
        self._seq = 0
        self._stats: Dict[str, int] = {"submitted": 0, "drained": 0}
        self._copy_stream: Optional[torch.cuda.Stream] = None

    @property
    def stats(self) -> Dict[str, int]:
        return dict(self._stats, window_stalls=self._inflight.stalls)

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    def _stage_slot(self, operands: Dict[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
        """Phase E of one submit into the next slot — on the copy stream
        when the runtime is on a card, handed to the launch stream."""
        slot = self._seq % self.depth
        device = self.runtime.device
        if device.type != "cuda":
            return self.plan.stage(operands, slot=slot, via=self.staging)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device)
        launch = torch.cuda.current_stream(device)
        with torch.cuda.stream(self._copy_stream):
            staged = self.plan.stage(operands, slot=slot, via=self.staging)
        for buf in staged.values():
            buf.record_stream(launch)
        launch.wait_stream(self._copy_stream)
        return staged

    def submit(self, operands, job_args: Optional[np.ndarray] = None
               ) -> JobHandle:
        """Stage into the next buffer slot and launch; returns the handle.

        ``operands`` is a host operand dict (phase-E staged into the next
        of ``depth`` slots — the upload overlaps with the in-flight jobs'
        compute) or ``Residency.RESIDENT`` to redispatch the plan's
        resident buffers with zero staging.  The launch itself is
        asynchronous, so a caller looping ``submit()`` keeps up to
        ``window`` jobs in flight with zero blocking until the window
        fills.
        """
        if job_args is None:
            job_args = np.ones((8,), dtype=np.float64)
        job_args = np.asarray(job_args, dtype=np.float64)
        resident = _is_resident(operands, "submit")
        if self.plan is None:
            self.plan = self.runtime.plan(
                self.job, None if resident else operands,
                args_shape=job_args.shape, **self._sel)
        if resident:
            staged = self.plan.resident_operands()
        else:
            staged = self._stage_slot(operands)
        # all completion-unit copies busy: block on the oldest job
        self._inflight.make_room(lambda h: h.wait())
        args_dev = self.plan.stage_args(job_args, via=self.staging)
        handle = self.runtime._launch(self.plan, args_dev, staged,
                                      consumed_resident=resident,
                                      resident=resident)
        self._inflight.push(handle)
        self._seq += 1
        self._stats["submitted"] += 1
        return handle

    def drain(self) -> List[Any]:
        """Wait for every in-flight job, in submit order; returns results."""
        out = self._inflight.drain_all(lambda h: h.wait())
        self._stats["drained"] += len(out)
        return out

    def map(self, instances: Sequence[Dict[str, np.ndarray]],
            job_args: Optional[Sequence[np.ndarray]] = None) -> List[Any]:
        """Submit every instance through the pipelined window, then wait.

        Results come back in submit order regardless of completion order
        (``JobHandle.wait()`` is idempotent, so handles already drained by
        window stalls just return their cached data).
        """
        if job_args is None:
            handles = [self.submit(ops) for ops in instances]
        else:
            handles = [self.submit(ops, a)
                       for ops, a in zip(instances, job_args)]
        return [h.wait() for h in handles]
