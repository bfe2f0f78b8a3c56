"""The offload runtime — the paper's host-centric execution model on the
logical clusters of one device.

Twin of ``repro.core.offload``.  ``OffloadRuntime`` carries one of the
paper's six jobs onto n accelerator "clusters" and reproduces the paper's
two implementations:

* ``baseline``  — job information is materialized on cluster 0 only and
  distributed hop by hop: n−1 dependent device copies, row k → row k+1,
  each its own launch (the sequential P2P writes of §4.1, phases C/D).
  Completion goes through the central-counter chain (§5.5 H), n−1 more
  dependent hops.  The launch trace holds 2(n−1) ``collective-permute``
  records — the paper's O(n) offload critical path.
* ``multicast`` — job information is replicated when it is staged (one
  write reaches every cluster's row), phases C/D vanish, and completion
  is one reduction over the arrival vector (the job completion unit).

How clusters map onto one device
--------------------------------

A runtime owns ``num_clusters`` logical clusters (Occamy's 32 by
default).  A cluster is a row of cluster-major tensors: a sharded operand
of a plan on n clusters is an ``(n, *shard)`` tensor split exactly as the
reference's ``PartitionSpec`` splits it, and a replicated operand is
``(n, *shape)``, one copy per cluster — so replication costs n× memory,
as on n devices, and every :class:`PlanStats` byte counter means what it
means in the reference.  Phase F is one launch of the job's kernel with
the clusters (and the fused jobs) as its batch axis; ``reduce="sum"`` and
``"mean"`` add one cross-cluster reduction, and replicated results are
computed on every cluster and cluster 0's copy is returned.

Entry points run on the card: ``OffloadRuntime(device=None)`` means
``torch.device("cuda")`` and raises when no CUDA device is present.  The
CPU tests pass ``device="cpu"``, where phase F runs the kernels' plain
versions.

Dispatch fast path
------------------

As in the reference: a :class:`DispatchPlan` is cached per (job, cluster
selection, operand shapes/dtypes, fuse) with the placements, the built
launch closure (the program), resident operand buffers, the job-args cache
and numbered staging slots.  Donation (``OffloadConfig.donate_operands``)
has no torch counterpart, so a donating dispatch frees its operand
buffers itself (their storage is released to the allocator) and marks
them; reusing one raises :class:`DonatedOperandError`, and the plan
re-stages resident operands from its host references, as the reference
does.  ``JobHandle.wait()`` fetches result and arrivals with one blocking
synchronization.

The launch trace replaces the reference's HLO checks: every built program
records the steps of its last run (:meth:`OffloadRuntime.launch_trace`),
and :func:`count_collectives` counts them under the reference's HLO
collective names.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis import sanitizer as _san
from repro_torch.core import broadcast as bc
from repro_torch.core import multicast as mc
from repro_torch.core.completion import (
    CompletionUnit,
    TraceEntry,
    central_counter_arrivals,
    completion_unit_arrivals,
)
from repro_torch.core.faults import CompletionTimeout, FaultInjector
from repro_torch.core.jobs import PaperJob, stack_instances
from repro_torch.core.params import DEFAULT_PARAMS
from repro_torch.core.policy import (
    Completion, InfoDist, Residency, Staging, coerce_enum, warn_legacy,
)

#: legacy sentinel accepted by ``offload(job, "resident", ...)`` — the
#: typed spelling is ``repro_torch.core.policy.Residency.RESIDENT``
RESIDENT = "resident"


def _is_resident(operands: Any, legacy_surface: str) -> bool:
    """True when ``operands`` selects resident redispatch.

    Accepts the typed :class:`Residency` enum silently and the legacy
    ``"resident"`` string with a :class:`DeprecationWarning`; any other
    string (or ``Residency.FRESH``, which names no buffers) is an error.
    """
    if isinstance(operands, Residency):
        if operands is not Residency.RESIDENT:
            raise ValueError(
                f"{operands!r} is not a dispatchable operand mode; pass "
                "an operand dict or Residency.RESIDENT")
        return True
    if isinstance(operands, str):
        if operands != RESIDENT:
            raise ValueError(f"unknown operands mode {operands!r}")
        warn_legacy(f"{legacy_surface}(job, 'resident')",
                    f"{legacy_surface}(job, Residency.RESIDENT)")
        return True
    return False


#: valid phase-E staging strategies for replicated operands (see
#: ``DispatchPlan._put``):
#:   "direct"       n host->device copies, one per cluster row, issued
#:                  back to back (n·size bytes over the host link)
#:   "host_fanout"  the same n copies, each synchronized before the
#:                  next — the O(n) baseline
#:   "tree"         ONE upload into the root cluster's row, then one
#:                  batched device-to-device copy per level of the
#:                  quadrant-aware tree (``repro_torch.core.broadcast``)
#:   "tree_reshard" root upload, then one batched copy to every other row
STAGING_MODES = bc.STAGING_MODES


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """The runtime's device: the card unless the caller asks for the CPU.

    Raises when CUDA is asked for (explicitly or by default) and absent —
    the runtime never quietly carries on on the CPU.
    """
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the offload runtime runs on a CUDA device and none is present; "
            "pass device='cpu' to run the plain versions on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class OffloadConfig:
    """First-class framework feature: how jobs are dispatched (§4.2/§4.3).

    Every mode field is validated on construction (a typo like
    ``info_dist="mulicast"`` raises instead of silently misconfiguring
    the run) and coerced to its :mod:`repro_torch.core.policy` enum; raw
    strings still work but raise :class:`DeprecationWarning`.
    """

    info_dist: InfoDist = InfoDist.MULTICAST
    completion: Completion = Completion.UNIT
    donate_operands: bool = False
    staging: Staging = Staging.DIRECT  # default phase-E mode, see STAGING_MODES

    def __post_init__(self):
        coerce = object.__setattr__
        coerce(self, "info_dist",
               coerce_enum(InfoDist, self.info_dist, "info_dist",
                           warn_legacy=True))
        coerce(self, "completion",
               coerce_enum(Completion, self.completion, "completion",
                           warn_legacy=True))
        coerce(self, "staging",
               coerce_enum(Staging, self.staging, "staging",
                           warn_legacy=True))

    @staticmethod
    def baseline() -> "OffloadConfig":
        return OffloadConfig(info_dist=InfoDist.P2P_CHAIN,
                             completion=Completion.CENTRAL_COUNTER)

    @staticmethod
    def extended() -> "OffloadConfig":
        return OffloadConfig(info_dist=InfoDist.MULTICAST,
                             completion=Completion.UNIT)


@dataclasses.dataclass
class PlanStats:
    """Host-side dispatch-overhead counters (per plan / per runtime)."""

    device_puts: int = 0          # operand/arg buffers uploaded
    resident_hits: int = 0        # operands reused without any upload
    args_hits: int = 0            # job-args upload skipped (unchanged value)
    dispatches: int = 0           # program launches through this plan
    donation_restages: int = 0    # re-uploads forced by a donated dispatch
    fused_jobs: int = 0           # logical jobs carried by fused dispatches
    h2d_bytes: int = 0            # logical host-link bytes (see broadcast.py)
    d2d_bytes: int = 0            # logical device-to-device fan-out bytes
    tree_stages: int = 0          # operand/arg stagings routed via the tree
    d2h_bytes: int = 0            # result payload fetched to host by wait()
    forwards: int = 0             # operands forwarded from producer results
    forward_bytes: int = 0        # logical d2d bytes of those forwards
    renames: int = 0              # rename copies breaking WAR/WAW hazards

    def accumulate(self, other: "PlanStats") -> "PlanStats":
        """Add ``other``'s counters into this instance (returns self) —
        the one aggregation used by every stats rollup surface."""
        for f in dataclasses.fields(PlanStats):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))
        return self


class DonatedOperandError(RuntimeError):
    """A device buffer was reused after a donating dispatch consumed it.

    A donating dispatch (``OffloadConfig.donate_operands``) frees its
    operand buffers.  Reusing one — re-staging it or fetching a result
    whose buffer was freed — raises this typed error naming the operand
    and the remedy instead of a storage error deep inside torch.
    """

    #: stable diagnostic code (``repro_torch.analysis.diagnostics.CODES``)
    code = "OFL003"

    def __init__(self, what: str):
        from repro_torch.analysis.diagnostics import use_after_donate
        self.diagnostic = use_after_donate(what)
        super().__init__(
            f"{what} was deleted by a donating dispatch; restage it from "
            "the host copy (plan.resident_operands restores resident "
            "buffers automatically) or disable donate_operands for "
            "buffers that must stay readable")


def _is_deleted(value: Any) -> bool:
    """True for a tensor whose storage a donating dispatch released."""
    return (isinstance(value, torch.Tensor) and value.numel() > 0
            and value.untyped_storage().nbytes() == 0)


def _donate(buf: torch.Tensor) -> None:
    """Consume a donated operand buffer: release its device memory.

    The caching allocator hands the block out again only to work queued
    after this point on the same stream, so kernels already launched on
    the buffer still read it.
    """
    buf.untyped_storage().resize_(0)


def _check_live(value: Any, what: str) -> Any:
    """Raise the typed donation error for a released buffer."""
    if _is_deleted(value):
        raise DonatedOperandError(what)
    return value


def _fetch(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Bring ``tensors`` to the host with ONE blocking synchronization."""
    if tensors[0].device.type != "cuda":
        return [t.detach().numpy().copy() for t in tensors]
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for t in tensors]
    for h, t in zip(hosts, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in hosts]


@dataclasses.dataclass
class JobHandle:
    """An in-flight offloaded job (async dispatch = multiple outstanding)."""

    job_id: int
    result: Any                      # device tensor (async until fetched)
    arrivals: Any                    # device-side arrivals count
    n_clusters: int
    dispatched_at: float
    runtime: "OffloadRuntime"
    cluster_ids: Tuple[int, ...] = ()
    plan: Optional["DispatchPlan"] = None
    _data: Any = None
    _done: bool = False
    _retired: bool = False
    _fault: Optional[CompletionTimeout] = None

    def _complete(self, arrivals: int) -> None:
        """Feed the completion unit, resolving any injected fault."""
        inj = self.runtime.fault_injector
        lost = (inj.lost_arrivals(self.runtime, self.job_id)
                if inj is not None else 0)
        if lost:
            self.runtime.unit.arrive(self.job_id, arrivals - lost)
            missing = self.runtime.unit.cancel(self.job_id)
            self.result = self.arrivals = None
            self._fault = CompletionTimeout(self.job_id, missing,
                                            self.cluster_ids)
            raise self._fault
        self.runtime.unit.arrive(self.job_id, arrivals)
        self.runtime.unit.collect(self.job_id)
        self._retired = True

    def retire(self) -> None:
        """Collect *completion only*, leaving the result on the device.

        Fetches the arrivals scalar (a host-side doorbell read, not the
        result payload), feeds the completion unit, and frees this job's
        unit copy — ``stats.d2h_bytes`` does not grow.  Idempotent;
        ``wait()`` after ``retire()`` fetches only the data.
        """
        if self._fault is not None:
            raise self._fault
        if self._retired or self._done:
            return
        (arrivals,) = _fetch(self.arrivals)
        self._complete(int(arrivals))
        self.arrivals = None

    def wait(self) -> Any:
        """Block until complete; feeds the completion unit and returns data.

        One blocking fetch brings result and arrivals together, and
        completion causes are drained out of order through
        :meth:`CompletionUnit.collect` — handles may be waited on in any
        order relative to dispatch.  Idempotent: a second call returns
        the cached result.  The result payload's bytes are counted in the
        plan's ``stats.d2h_bytes``.

        Under fault injection, a dispatch whose arrivals were dropped
        raises :class:`~repro_torch.core.faults.CompletionTimeout`
        instead, after feeding the partial arrivals to the unit and
        cancelling the stuck register.
        """
        if self._fault is not None:
            raise self._fault
        if self._done:
            return self._data
        _check_live(self.result, f"job {self.job_id}'s result buffer")
        s = _san.active()
        if s is not None:
            s.read(self.result, f"wait() on job {self.job_id}")
        if self._retired:
            (data,) = _fetch(self.result)
        else:
            data, arrivals = _fetch(self.result, self.arrivals)
            self._complete(int(arrivals))
        if self.plan is not None:
            self.plan.stats.d2h_bytes += int(data.nbytes)
        self._data, self._done = data, True
        self.result = self.arrivals = None   # drop device refs
        return data


@dataclasses.dataclass
class FusedHandle(JobHandle):
    """Handle for B jobs fused into one launch; ``wait()`` returns the
    stacked (B, ...) output, ``wait_each()`` the per-job results."""

    batch: int = 1

    def wait_each(self) -> list:
        data = self.wait()
        return [np.asarray(data[i]) for i in range(self.batch)]


class DispatchPlan:
    """Cached dispatch state for one (job, cluster selection, operand shapes).

    Holds everything ``offload()`` would otherwise recompute per job: the
    operand placements, the built program, the last staged job-args value,
    and (optionally) *resident* operand buffers that repeated dispatch
    reuses without any host->device transfer.

    ``fuse=B`` makes this a *fused* plan: operand shapes in ``op_meta``
    carry a leading batch axis of length B, shard axes shift right by one,
    and the program runs the kernel over clusters × B — one launch for B
    jobs.
    """

    def __init__(self, runtime: "OffloadRuntime", job: PaperJob,
                 cluster_ids: Sequence[int],
                 op_meta: Tuple[Tuple[str, Tuple[int, ...], str], ...],
                 args_shape: Tuple[int, ...],
                 fuse: Optional[int] = None):
        self.runtime = runtime
        self.job = job
        self.device = runtime.device
        self.cluster_ids = tuple(cluster_ids)
        self.n_clusters = len(cluster_ids)
        self.op_meta = op_meta
        self.args_shape = tuple(args_shape)
        self.fuse = fuse
        self.stats = PlanStats()

        n = self.n_clusters
        if runtime.config.info_dist == "multicast":
            self.args_placement = bc.Placement(n)
        else:
            self.args_placement = bc.Placement(n, 0)
        lead = 0 if fuse is None else 1   # fused shapes: (B,) + per-job shape
        self.placements: Dict[str, bc.Placement] = {}
        for name, shape, _ in op_meta:
            axis = job.shard_axes[name]
            if axis is not None and shape[axis + lead] % n:
                raise ValueError(
                    f"operand {name} axis {axis} ({shape[axis + lead]}) "
                    f"not divisible by {n} clusters"
                )
            self.placements[name] = bc.Placement(
                n, None if axis is None else axis + lead)

        self.fn = runtime._build(
            job, self.cluster_ids, n,
            tuple(name for name, _, _ in op_meta), self.args_shape,
            fuse=fuse)

        self._resident: Dict[str, torch.Tensor] = {}   # name -> device buffer
        self._resident_src: Dict[str, np.ndarray] = {}  # name -> host array
        self._slots: Dict[int, Dict[str, torch.Tensor]] = {}  # staging slots
        self._args_val: Optional[np.ndarray] = None
        self._args_dev: Optional[torch.Tensor] = None
        self._stager: Optional[bc.TreeStager] = None   # built lazily
        self._staged_via: str = runtime.config.staging  # residency's mode

    # -- staging ---------------------------------------------------------------

    @property
    def has_resident(self) -> bool:
        return len(self._resident) == len(self.op_meta) > 0 or not self.op_meta

    def _resolve_via(self, via: Optional[Union[str, Staging]]) -> Staging:
        if via is None:
            return self.runtime.config.staging
        if isinstance(via, Staging):
            return via
        return coerce_enum(Staging, via, "via", warn_legacy=True)

    def _tree_stager(self) -> bc.TreeStager:
        if self._stager is None:
            # one tree per plan, shared by every staging (and every job of
            # a fused batch — the stacked operands ride one tree)
            self._stager = bc.TreeStager(self.device, self.cluster_ids)
        return self._stager

    def _put(self, arr: np.ndarray, placement: bc.Placement,
             via: str) -> torch.Tensor:
        """One operand/args upload under a staging strategy, bytes counted.

        Sharded arrays cross the host link once regardless of mode (each
        cluster receives only its shard); the strategies differ only for
        replicated arrays — the O(n) host-link offenders.
        """
        n = self.n_clusters
        if not bc.is_replicated(placement):
            self.stats.h2d_bytes += arr.nbytes
            return bc.upload(placement.to_clusters(arr), self.device)
        if via in bc.TREE_MODES:
            self.stats.tree_stages += 1
            return self._tree_stager().put_replicated(
                arr, reshard=(via == "tree_reshard"), stats=self.stats)
        # "direct" and "host_fanout": one host->device transfer per cluster
        # row.  "direct" issues them back to back, as one replicated
        # device_put does; "host_fanout" is the measurable O(n) baseline,
        # one outstanding at a time (the serialized host-link writes of
        # §4.1 — CVA6's outstanding-transaction budget)
        src = bc.host_tensor(arr)
        buf = torch.empty((n,) + tuple(src.shape), dtype=src.dtype,
                          device=self.device)
        for row in buf:
            row.copy_(src, non_blocking=(via == "direct"))
            if via == "host_fanout":
                bc.synchronize(self.device)
        self.stats.h2d_bytes += arr.nbytes * n
        return buf

    def stage(self, operands: Dict[str, np.ndarray], *,
              _caller_owned: bool = True,
              slot: Optional[int] = None,
              via: Optional[Union[str, Staging]] = None
              ) -> Dict[str, torch.Tensor]:
        """Phase-E upload of ``operands``.

        With ``slot=None`` (default) the buffers become *resident* — the
        warm ``offload(job, Residency.RESIDENT)`` path reuses them.  With a
        slot number they land in that numbered staging slot instead,
        leaving residency untouched.

        ``via`` picks the staging strategy for replicated operands (see
        ``STAGING_MODES``), defaulting to ``OffloadConfig.staging``.  With
        ``"tree"``, each replicated operand crosses the host link exactly
        once (into the tree root's row) and reaches the remaining clusters
        through device-to-device copies — ``stats.h2d_bytes`` grows by
        size, not n·size.
        """
        via = self._resolve_via(via)
        names = tuple(sorted(operands))
        if names != tuple(name for name, _, _ in self.op_meta):
            raise ValueError(
                f"operand names {names} do not match plan {self.op_meta}")
        staged = {}
        donating = self.runtime.config.donate_operands
        for name, shape, dtype in self.op_meta:
            arr = np.asarray(_check_live(operands[name],
                                         f"staged operand {name!r}"))
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"operand {name} shape {arr.shape} != planned {shape}")
            if str(arr.dtype) != dtype:
                raise ValueError(
                    f"operand {name} dtype {arr.dtype} != planned {dtype} "
                    "(a dtype change needs a new plan)")
            staged[name] = self._put(arr, self.placements[name], via)
            self.stats.device_puts += 1
            if slot is None:
                # donation restages from these refs later — snapshot caller
                # arrays so in-place mutation cannot skew the redo
                self._resident_src[name] = (
                    arr.copy() if donating and _caller_owned else arr)
        if slot is None:
            self._resident = staged
            self._staged_via = via
        else:
            self._slots[slot] = staged
        s = _san.active()
        if s is not None:
            for name, buf in staged.items():
                s.track(buf, f"staged operand {name!r}")
        return staged

    def invalidate(self, names: Optional[Sequence[str]] = None) -> None:
        """Drop resident operand buffers (all, or a named subset)."""
        s = _san.active()
        if s is not None:
            dropped = (self._resident.items() if names is None else
                       ((n, self._resident[n]) for n in names
                        if n in self._resident))
            for name, buf in dropped:
                s.revoke(buf, f"resident operand {name!r}")
        if names is None:
            self._resident.clear()
            self._resident_src.clear()
            self._slots.clear()
        else:
            for name in names:
                self._resident.pop(name, None)
                self._resident_src.pop(name, None)

    def resident_operands(self) -> Dict[str, torch.Tensor]:
        """The resident device buffers, re-staging any consumed by donation."""
        if not self._resident and self._resident_src:
            # a donated dispatch consumed the buffers; restore from host
            # refs through the same staging strategy they arrived by
            self.stage(dict(self._resident_src), _caller_owned=False,
                       via=self._staged_via)
            self.stats.donation_restages += len(self.op_meta)
        if len(self._resident) != len(self.op_meta):
            raise RuntimeError(
                "no resident operands staged for this plan — dispatch once "
                "with real operands (or call plan.stage) before "
                "offload(job, Residency.RESIDENT, ...)")
        self.stats.resident_hits += len(self.op_meta)
        s = _san.active()
        if s is not None:
            for name, buf in self._resident.items():
                s.read(buf, f"resident operand {name!r}")
        return dict(self._resident)

    def stage_args(self, job_args: np.ndarray, *,
                   via: Optional[Union[str, Staging]] = None) -> torch.Tensor:
        """Upload job args, skipping the transfer when the value is unchanged.

        Returns the ``(n, *args_shape)`` per-cluster args.  Replicated job
        args (multicast mode) honour the ``via`` staging strategy — they
        are the paper's multicast payload (the phase-A job information).
        Baseline (p2p_chain) args are materialized in cluster 0's row
        only (the other rows are zero until the chain runs), an O(n)-byte
        host transfer by construction.
        """
        if (self._args_dev is not None and self._args_val is not None
                and np.array_equal(self._args_val, job_args)):
            self.stats.args_hits += 1
            return self._args_dev
        if self.runtime.config.info_dist == "multicast":
            host = job_args
        else:
            tiled = np.zeros((self.n_clusters,) + job_args.shape,
                             job_args.dtype)
            tiled[0] = job_args
            host = tiled
        dev = self._put(np.asarray(host), self.args_placement,
                        self._resolve_via(via))
        # a sharded (n, ...) array is (n, 1, ...) cluster-major
        self._args_dev = dev.reshape((self.n_clusters,) + job_args.shape)
        self.stats.device_puts += 1
        self._args_val = job_args.copy()
        return self._args_dev

    def _after_dispatch(self, consumed_resident: bool = True) -> None:
        self.stats.dispatches += 1
        self.stats.fused_jobs += self.fuse if self.fuse else 1
        if self.runtime.config.donate_operands and consumed_resident:
            # donated buffers are dead; keep host refs so reuse self-heals
            self._resident.clear()


def _chain_distribute(args: torch.Tensor, n: int,
                      trace: List[TraceEntry]) -> torch.Tensor:
    """Baseline phases C/D: args hop cluster 0 -> 1 -> ... -> n-1.

    ``args`` holds the job info in row 0 only.  n−1 dependent row copies,
    each its own launch (the O(n) critical path); the staged buffer is
    left as it was, so a cached args upload still rides the chain.
    """
    if n == 1:
        return args
    have = args.clone()
    for k in range(n - 1):
        have[k + 1].copy_(have[k])
        trace.append(("collective-permute", f"job info {k}->{k + 1}"))
    return have


class _Program:
    """The launch closure of one plan key: phases B–H of one dispatch.

    Called with the per-cluster args and the cluster-major operands; runs
    the job-info distribution, phase F (one kernel launch over clusters ×
    fused jobs), the cross-cluster combination and the completion
    synchronization, and returns ``(result, arrivals)`` without
    synchronizing.  ``trace`` holds the steps of the last call.
    """

    def __init__(self, job: PaperJob, config: OffloadConfig, n: int,
                 fuse: Optional[int], device: torch.device):
        self.job = job
        self.config = config
        self.n = n
        self.lead = 0 if fuse is None else 1
        self.done = torch.ones(n, dtype=torch.float32, device=device)
        self.trace: List[TraceEntry] = []

    def __call__(self, args: torch.Tensor, *ops: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        job, n, trace = self.job, self.n, []
        # Phases B/C/D: job-information distribution.
        if self.config.info_dist == "p2p_chain":
            local_args = _chain_distribute(args, n, trace)
        else:
            local_args = args
        # Phase F: the kernel, every cluster's shard in one launch.  The
        # job-info scale rides through the result, so a broken
        # distribution corrupts it (tested).
        trace.append(("compute", job.spec.name))
        out = job.compute(*ops)
        scale = local_args[..., 0].to(out.dtype)
        out = out * scale.reshape(scale.shape + (1,) * (out.ndim - scale.ndim))
        if job.out_axis is not None:
            out = bc.Placement(n, job.out_axis + self.lead).from_clusters(out)
        elif job.reduce == "sum":
            out = out.sum(dim=0)
            trace.append(("all-reduce", "sum of cluster partials"))
        elif job.reduce == "mean":
            out = out.mean(dim=0)
            trace.append(("all-reduce", "mean of cluster estimates"))
        else:
            out = out[0]   # replicated: every cluster computed it
        # Phase H: completion notification (one per launch, fused or not).
        if self.config.completion == "unit":
            arrivals = completion_unit_arrivals(self.done, trace)
        else:
            arrivals = central_counter_arrivals(self.done, trace)
        self.trace = trace
        return out, arrivals


class OffloadRuntime:
    """Host-centric offload of jobs onto the logical clusters of a device."""

    def __init__(
        self,
        device: Union[None, str, torch.device] = None,
        config: OffloadConfig = OffloadConfig.extended(),
        n_units: int = 4,
        cluster_ids: Optional[Sequence[int]] = None,
        fault_injector: Optional[FaultInjector] = None,
        num_clusters: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        # the fabric window this runtime owns: global cluster ids, one per
        # logical cluster.  A whole-fabric runtime is the identity window.
        if cluster_ids is None:
            ids = range(num_clusters if num_clusters is not None
                        else DEFAULT_PARAMS.num_clusters)
        else:
            ids = cluster_ids
            if num_clusters is not None and num_clusters != len(ids):
                raise ValueError(
                    f"{len(ids)} cluster ids for {num_clusters} clusters")
        self.cluster_ids = tuple(int(c) for c in ids)
        if not self.cluster_ids:
            raise ValueError("a runtime needs at least one cluster")
        if len(set(self.cluster_ids)) != len(self.cluster_ids):
            raise ValueError(f"duplicate cluster ids in {self.cluster_ids}")
        self.num_clusters = len(self.cluster_ids)
        self.config = config
        self.fault_injector = fault_injector
        self.unit = CompletionUnit(n_units=n_units)
        self._job_counter = 0
        self._compiled: Dict[Tuple, _Program] = {}
        self._traces: Dict[Tuple, List[TraceEntry]] = {}  # launch_trace cache
        self._plans: Dict[Tuple, DispatchPlan] = {}
        self._retired_stats = PlanStats()   # counts from replaced plans
        self.plan_hits = 0
        self.plan_misses = 0

    @property
    def stats(self) -> PlanStats:
        """Running dispatch-overhead totals across all plans (monotonic —
        replaced plans' counts are retained)."""
        agg = dataclasses.replace(self._retired_stats)
        for p in self._plans.values():
            agg.accumulate(p.stats)
        return agg

    # -- cluster selection (paper §4.2 semantics) ---------------------------------

    def select_clusters(
        self,
        n: Optional[int] = None,
        request: Optional[mc.MulticastRequest] = None,
        clusters: Optional[Sequence[int]] = None,
    ) -> Tuple[List[int], List[int]]:
        """Resolve a cluster selection to ``(window positions, cluster ids)``.

        Exactly one of ``n`` (first n clusters), ``request`` (an
        address-mask multicast request, fig. 5) or ``clusters`` (an
        explicit set, greedily covered by subcube requests) must be given.
        All three select within the runtime's window (``cluster_ids``);
        the returned ids are the selected clusters' global fabric ids.
        """
        if sum(x is not None for x in (n, request, clusters)) != 1:
            raise ValueError("give exactly one of n / request / clusters")
        if request is not None:
            pos = mc.decode_cluster_selection(request, self.num_clusters)
        elif clusters is not None:
            reqs = mc.encode_cluster_selection_multi(clusters,
                                                     self.num_clusters)
            pos = sorted(
                {c for r in reqs
                 for c in mc.decode_cluster_selection(r, self.num_clusters)})
            if set(pos) != set(clusters):
                raise ValueError(
                    f"selection {sorted(clusters)} decoded to {pos}")
        else:
            if not (1 <= n <= self.num_clusters):
                raise ValueError(f"n={n} outside [1, {self.num_clusters}]")
            pos = list(range(n))
        return list(pos), [self.cluster_ids[i] for i in pos]

    # -- planning -------------------------------------------------------------------

    def plan(
        self,
        job: PaperJob,
        operands: Optional[Dict[str, np.ndarray]] = None,
        n: Optional[int] = None,
        request: Optional[mc.MulticastRequest] = None,
        clusters: Optional[Sequence[int]] = None,
        args_shape: Tuple[int, ...] = (8,),
        fuse: Optional[int] = None,
    ) -> DispatchPlan:
        """Resolve (and cache) the dispatch plan for a job/selection pair.

        With ``operands`` given, their shapes/dtypes seed (or validate) the
        plan; staging is separate (``plan.stage`` / a dict ``offload``).
        Without operands, the plan must already exist and is returned
        as-is.  ``fuse=B`` resolves the fused-batch plan.
        """
        _, ids = self.select_clusters(
            n=n if (request is None and clusters is None) else None,
            request=request, clusters=clusters,
        )
        key = (job.spec.name, tuple(ids), tuple(args_shape), fuse)
        if operands is None:
            plan = self._plans.get(key)
            if plan is None:
                raise KeyError(
                    f"no dispatch plan for {key}; pass operands once first")
            self.plan_hits += 1
            return plan

        op_meta = tuple(
            (name, tuple(np.asarray(operands[name]).shape),
             str(np.asarray(operands[name]).dtype))
            for name in sorted(operands)
        )
        plan = self._plans.get(key)
        if plan is not None and plan.op_meta == op_meta:
            self.plan_hits += 1
            return plan
        self.plan_misses += 1
        new_plan = DispatchPlan(self, job, ids, op_meta, tuple(args_shape),
                                fuse=fuse)
        if plan is not None:   # replaced: keep its counts
            self._retired_stats.accumulate(plan.stats)
        self._plans[key] = new_plan
        return new_plan

    # -- dispatch -------------------------------------------------------------------

    def offload(
        self,
        job: PaperJob,
        operands: Union[Dict[str, np.ndarray], str, Residency],
        job_args: Optional[np.ndarray] = None,
        n: Optional[int] = None,
        request: Optional[mc.MulticastRequest] = None,
        clusters: Optional[Sequence[int]] = None,
    ) -> JobHandle:
        """Phases A..I of one job on the selected clusters.

        ``operands`` is either the host operand dict (phase-E staged on
        this call, and left resident on the plan) or
        ``Residency.RESIDENT`` to reuse the buffers staged by the previous
        dispatch of the same plan — the zero-upload warm path.
        """
        if job_args is None:
            job_args = np.ones((8,), dtype=np.float64)
        job_args = np.asarray(job_args, dtype=np.float64)

        resident = _is_resident(operands, "offload")
        plan = self.plan(
            job, operands=None if resident else operands,
            n=n, request=request, clusters=clusters,
            args_shape=job_args.shape,
        )
        # Phase A / job-info placement (multicast replicates, baseline
        # materializes on cluster 0) — skipped when the value is unchanged.
        args_dev = plan.stage_args(job_args)
        # Phase E staging: resident mode reuses the prior buffers outright.
        if resident:
            op_dev = plan.resident_operands()
        else:
            op_dev = plan.stage(operands)
        return self._launch(plan, args_dev, op_dev)

    def offload_fused(
        self,
        job: PaperJob,
        instances: Union[Sequence[Dict[str, np.ndarray]], str, Residency],
        job_args: Optional[np.ndarray] = None,
        n: Optional[int] = None,
        request: Optional[mc.MulticastRequest] = None,
        clusters: Optional[Sequence[int]] = None,
        batch: Optional[int] = None,
    ) -> FusedHandle:
        """Fuse B instances of ``job`` into one launch (see
        :meth:`_offload_fused`).  The reference deprecates this entry
        point in favour of its session API, which the port does not have
        yet, so here it does not warn."""
        return self._offload_fused(job, instances, job_args=job_args, n=n,
                                   request=request, clusters=clusters,
                                   batch=batch)

    def _offload_fused(
        self,
        job: PaperJob,
        instances: Union[Sequence[Dict[str, np.ndarray]], str, Residency],
        job_args: Optional[np.ndarray] = None,
        n: Optional[int] = None,
        request: Optional[mc.MulticastRequest] = None,
        clusters: Optional[Sequence[int]] = None,
        batch: Optional[int] = None,
        staging: Optional[Staging] = None,
    ) -> FusedHandle:
        """Fuse B instances of ``job`` into one launch.

        ``instances`` is a sequence of B operand dicts (stacked host-side
        along a new leading batch axis and phase-E staged as one transfer
        per operand) or ``Residency.RESIDENT`` to redispatch the
        previously staged batch (``batch=B`` then selects the fused plan).
        ``job_args`` may be one (A,) vector shared by all jobs or a (B, A)
        array of per-job args.  Returns a :class:`FusedHandle` whose
        ``wait()`` yields the stacked (B, ...) results.  The launch trace's
        collective count is independent of B.
        """
        resident = _is_resident(instances, "offload_fused")
        if resident:
            if batch is None:
                raise ValueError("resident fused dispatch needs batch=B")
            B = batch
        else:
            B = len(instances)
            if B < 1:
                raise ValueError("offload_fused needs at least one instance")
            if batch is not None and batch != B:
                raise ValueError(f"batch={batch} != len(instances)={B}")

        if job_args is None:
            job_args = np.ones((8,), dtype=np.float64)
        job_args = np.asarray(job_args, dtype=np.float64)
        if job_args.ndim == 1:
            job_args = np.broadcast_to(job_args, (B,) + job_args.shape).copy()
        if job_args.shape[0] != B:
            raise ValueError(
                f"job_args leading axis {job_args.shape[0]} != batch {B}")

        stacked = None if resident else stack_instances(instances)
        plan = self.plan(
            job, operands=stacked,
            n=n, request=request, clusters=clusters,
            args_shape=job_args.shape, fuse=B,
        )
        args_dev = plan.stage_args(job_args, via=staging)
        # the stacked dict is ours (fresh arrays from stack_instances), so
        # donation needs no defensive snapshot of it
        op_dev = (plan.resident_operands() if resident
                  else plan.stage(stacked, _caller_owned=False, via=staging))
        handle = self._launch(plan, args_dev, op_dev)
        return FusedHandle(handle.job_id, handle.result, handle.arrivals,
                           plan.n_clusters, handle.dispatched_at, self,
                           plan.cluster_ids, plan, batch=B)

    def _launch(self, plan: DispatchPlan, args_dev: torch.Tensor,
                op_dev: Dict[str, torch.Tensor],
                consumed_resident: bool = True) -> JobHandle:
        """The dispatch tail shared by offload/offload_fused: program a
        completion unit, launch the program (async), return the in-flight
        handle."""
        job_id = self._job_counter
        self._job_counter += 1
        self.unit.program(plan.n_clusters, job_id)
        if self.fault_injector is not None:
            # fault-injection hook: resolves this dispatch's scheduled
            # effect (dropped arrivals / virtual delay) deterministically
            self.fault_injector.on_dispatch(self, job_id, plan.cluster_ids,
                                            plan.job.spec)
        # op_dev may alias plan._resident, which a donating _after_dispatch
        # clears — snapshot the buffers first
        op_bufs = [(name, op_dev[name]) for name, _, _ in plan.op_meta]
        s = _san.active()
        if s is not None:
            for name, buf in op_bufs:
                s.read(buf, f"launch {job_id} operand {name!r}")
        result, arrivals = plan.fn(args_dev, *(buf for _, buf in op_bufs))
        plan._after_dispatch(consumed_resident=consumed_resident)
        if self.config.donate_operands:
            for name, buf in op_bufs:
                _donate(buf)
                if s is not None:
                    s.donate(buf, f"operand {name!r}")
        if s is not None:
            s.track(result, f"job {job_id}'s result buffer")
        return JobHandle(job_id, result, arrivals, plan.n_clusters,
                         time.monotonic(), self, plan.cluster_ids, plan)

    def run(self, job: PaperJob, seed: int = 0, **sel) -> Tuple[Any, Any]:
        """Convenience: build an instance, offload it, return (got, expected)."""
        operands, expected = job.make_instance(seed)
        handle = self.offload(job, operands, **sel)
        return handle.wait(), expected

    # -- program construction ---------------------------------------------------------

    def _build(self, job: PaperJob, cluster_ids: Tuple[int, ...], n: int,
               op_names: Tuple[str, ...], args_shape: Tuple[int, ...],
               fuse: Optional[int] = None) -> _Program:
        key = (job.spec.name, self.config, n, op_names, args_shape,
               tuple(cluster_ids), fuse)
        prog = self._compiled.get(key)
        if prog is None:
            prog = _Program(job, self.config, n, fuse, self.device)
            self._compiled[key] = prog
        return prog

    # -- introspection -------------------------------------------------------------

    def launch_trace(self, job: PaperJob, n: int, seed: int = 0,
                     fuse: Optional[int] = None) -> List[TraceEntry]:
        """The launch trace of the offloaded program on ``n`` clusters —
        the port's stand-in for the reference's ``lowered_text``, used by
        tests and ``chip_smoke.py`` to assert the collective structure
        (chain depth vs one reduction).

        Runs the program once on an instance (``fuse=B`` stacks B of
        them) without touching any plan or counter; cached per (job, n,
        config, fuse).
        """
        _, ids = self.select_clusters(n=n)
        key = (job.spec.name, self.config, n, fuse, tuple(ids))
        cached = self._traces.get(key)
        if cached is not None:
            return list(cached)
        from repro_torch.convert import operands_to_clusters
        if fuse is None:
            operands, _ = job.make_instance(seed)
            lead, args_shape = 0, (8,)
        else:
            operands = stack_instances(
                [job.make_instance(seed + i)[0] for i in range(fuse)])
            lead, args_shape = 1, (fuse, 8)
        prog = self._build(job, tuple(ids), n, tuple(sorted(operands)),
                           args_shape, fuse=fuse)
        ops = operands_to_clusters(operands, job, ids, self.device, lead=lead)
        args = torch.zeros((n,) + args_shape, dtype=torch.float64,
                           device=self.device)
        args[0 if self.config.info_dist == "p2p_chain" else slice(None)] = 1.0
        prog(args, *(ops[name] for name in sorted(operands)))
        self._traces[key] = list(prog.trace)
        return list(prog.trace)


#: the collective kinds the reference's ``count_collectives`` reads from HLO
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def count_collectives(trace: Sequence[TraceEntry]) -> Dict[str, int]:
    """Occurrences of each collective kind in a launch trace (the same keys
    as the reference's HLO count)."""
    return {k: sum(1 for kind, _ in trace if kind == k)
            for k in COLLECTIVE_KINDS}
