"""``repro_torch.api`` — the one import for the predictive offload session.

Twin of ``repro.api``: typed policies, the unified :class:`Session`
submit path, the model-driven ``AUTO`` planner, the prediction contract
(:func:`estimate` / :func:`predict_staging`, paper §6, error < 15 %),
dependent job graphs (:meth:`Session.submit_graph` over
:class:`GraphNode` / :class:`Ref`, with device-to-device forwarding),
the multi-tenant fabric scheduler (:class:`FabricScheduler` /
:class:`ClusterLease`), the fault-tolerance substrate
(:class:`FaultPlan` / :class:`FaultInjector` / :class:`RetryPolicy`),
the static verifier (:func:`verify` / :func:`verify_graph` /
:func:`verify_policy`), the model-driven perf linter
(``Session(lint=True)`` / :func:`lint` / :func:`lint_graph` emitting
``OFLP1##`` :class:`PerfFinding` records with machine-applicable
:class:`Fix` rewrites, and the ``python -m repro_torch.lint`` CLI), the
wall-clock fault tolerance
(:class:`StepWatchdog` / :class:`BackupOffload`), the serving engine and
its lease-holding fabric tenant (:class:`ServeTenant`).

Quickstart::

    from repro_torch.api import Session
    from repro_torch.core import jobs

    sess = Session()                      # the card, 32 logical clusters
    job = jobs.make_covariance(512, 256)
    instances, _ = jobs.make_instances(job, 16)

    print(sess.estimate(job, batch=16))   # predicted phase breakdown
    handle = sess.submit(job, instances)  # AUTO: fused, pipelined window
    results = handle.wait()
    print(handle.explain())               # predicted vs measured

``Session(device="cpu", num_clusters=8)`` runs the same path on the
kernels' plain versions.  The one name of the reference's surface whose
module is not ported yet is listed in :data:`NOT_YET_PORTED`.
"""

from repro_torch.analysis import (
    Diagnostic,
    DiagnosticsLog,
    Fix,
    PerfFinding,
    SanitizerError,
    Severity,
    UnknownDiagnosticCode,
    VerificationError,
    explain,
    lint,
    lint_graph,
    verify,
    verify_graph,
    verify_policy,
)
from repro_torch.core.fabric import (
    ClusterLease,
    FabricHealth,
    FabricScheduler,
    LeaseError,
    LeaseUnavailable,
    Overloaded,
    PendingLease,
    SchedulerPolicy,
    Tenant,
)
from repro_torch.core.faults import (
    CompletionTimeout,
    FaultError,
    FaultInjector,
    FaultKind,
    FaultPlan,
    FaultSpec,
    SessionHealth,
    deadline_cycles,
    predict_recovery,
)
from repro_torch.core.jobs import PAPER_JOBS, PaperJob, make_instances
from repro_torch.core.multicast import MulticastRequest
from repro_torch.core.offload import (
    DonatedOperandError,
    JobHandle,
    OffloadConfig,
    OffloadRuntime,
    PlanStats,
)
from repro_torch.core.policy import (
    AUTO,
    Completion,
    InfoDist,
    OffloadPolicy,
    Residency,
    RetryPolicy,
    Staging,
    TenantKind,
)
from repro_torch.core.scoreboard import (
    GraphError,
    GraphNode,
    Ref,
    Scoreboard,
)
from repro_torch.core.session import (
    Estimate,
    Explain,
    GraphHandle,
    PlanDecision,
    Planner,
    ReliableHandle,
    Session,
    SessionHandle,
    estimate,
    predict_staging,
)
from repro_torch.ft import BackupOffload, StepWatchdog, WatchdogConfig
from repro_torch.serve import ServeConfig, ServeEngine, ServeTenant

#: names of ``repro.api.__all__`` whose modules the port does not have yet:
#: ``elastic_restore`` (``ft/elastic.py``) restores a checkpoint onto a new
#: mesh and comes with the training substrate.
NOT_YET_PORTED = ("elastic_restore",)

__all__ = [
    "AUTO",
    "BackupOffload",
    "ClusterLease",
    "Completion",
    "CompletionTimeout",
    "Diagnostic",
    "DiagnosticsLog",
    "DonatedOperandError",
    "Estimate",
    "Explain",
    "FabricHealth",
    "FabricScheduler",
    "FaultError",
    "FaultInjector",
    "FaultKind",
    "FaultPlan",
    "FaultSpec",
    "Fix",
    "GraphError",
    "GraphHandle",
    "GraphNode",
    "InfoDist",
    "JobHandle",
    "LeaseError",
    "LeaseUnavailable",
    "MulticastRequest",
    "OffloadConfig",
    "OffloadPolicy",
    "OffloadRuntime",
    "Overloaded",
    "PAPER_JOBS",
    "PaperJob",
    "PendingLease",
    "PerfFinding",
    "PlanDecision",
    "PlanStats",
    "Planner",
    "Ref",
    "ReliableHandle",
    "Residency",
    "RetryPolicy",
    "SanitizerError",
    "SchedulerPolicy",
    "Scoreboard",
    "ServeConfig",
    "ServeEngine",
    "ServeTenant",
    "Session",
    "SessionHandle",
    "SessionHealth",
    "Severity",
    "Staging",
    "StepWatchdog",
    "Tenant",
    "TenantKind",
    "UnknownDiagnosticCode",
    "VerificationError",
    "WatchdogConfig",
    "deadline_cycles",
    "estimate",
    "explain",
    "lint",
    "lint_graph",
    "make_instances",
    "predict_recovery",
    "predict_staging",
    "verify",
    "verify_graph",
    "verify_policy",
]
