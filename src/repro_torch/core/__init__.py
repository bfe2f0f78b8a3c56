"""The paper's contribution on one GPU: the multicast offload runtime, the
job completion unit, the cycle-accurate phase simulator and the analytical
offload-runtime model (twin of ``repro.core``; this slice ends at
:class:`OffloadRuntime` — the session, stream, scoreboard and fabric come
later)."""

from repro_torch.core.broadcast import (
    BroadcastTree,
    Placement,
    TreeStager,
    build_tree,
    depth_bound,
    place_pytree,
    tree_from_request,
)
from repro_torch.core.completion import CompletionUnit
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
from repro_torch.core.jobs import (
    PAPER_JOBS, PaperJob, make_instances, stack_instances,
)
from repro_torch.core.model import (
    axpy_closed_form,
    atax_closed_form_paper,
    optimal_clusters,
    predict,
    predict_total,
    predict_total_v2,
    should_offload,
    validate,
)
from repro_torch.core.multicast import (
    AddressMap,
    MulticastRequest,
    decode_cluster_selection,
    decode_match,
    encode_cluster_selection,
    encode_cluster_selection_multi,
)
from repro_torch.core.offload import (
    DispatchPlan,
    DonatedOperandError,
    FusedHandle,
    JobHandle,
    OffloadConfig,
    OffloadRuntime,
    PlanStats,
    count_collectives,
)
from repro_torch.core.params import DEFAULT_PARAMS, OccamyParams
from repro_torch.core.phases import Phase, PhaseStats
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
from repro_torch.core.simulator import (
    FabricSimResult,
    JobSpec,
    SimResult,
    StagingCostModel,
    TenantWorkload,
    fabric_makespan_model,
    forward_model,
    model_error,
    offload_overhead,
    simulate,
    simulate_fabric,
    simulate_forward,
    simulate_staging,
    speedups,
    staging_model,
    staging_model_error,
)

__all__ = [
    "AUTO", "AddressMap", "BroadcastTree", "Completion",
    "CompletionTimeout", "CompletionUnit", "DEFAULT_PARAMS",
    "DispatchPlan", "DonatedOperandError", "FabricSimResult",
    "FaultError", "FaultInjector", "FaultKind", "FaultPlan", "FaultSpec",
    "FusedHandle", "InfoDist", "JobHandle", "JobSpec",
    "MulticastRequest", "OccamyParams", "OffloadConfig", "OffloadPolicy",
    "OffloadRuntime", "PAPER_JOBS", "PaperJob", "Phase", "PhaseStats",
    "Placement", "PlanStats", "Residency", "RetryPolicy", "SessionHealth",
    "SimResult", "Staging", "StagingCostModel", "TenantKind",
    "TenantWorkload", "TreeStager",
    "atax_closed_form_paper", "axpy_closed_form", "build_tree",
    "count_collectives", "deadline_cycles", "decode_cluster_selection",
    "decode_match", "depth_bound", "encode_cluster_selection",
    "encode_cluster_selection_multi", "fabric_makespan_model",
    "forward_model", "make_instances", "model_error", "offload_overhead",
    "optimal_clusters", "place_pytree", "predict", "predict_recovery",
    "predict_total", "predict_total_v2", "should_offload", "simulate", "simulate_fabric",
    "simulate_forward", "simulate_staging", "speedups", "stack_instances",
    "staging_model", "staging_model_error", "tree_from_request", "validate",
]
