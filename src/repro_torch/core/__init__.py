"""The paper's contribution on one GPU: the multicast offload runtime, the
job completion unit, the cycle-accurate phase simulator, the analytical
offload-runtime model, and the session layer over them — the predictive
:class:`Session` with its pipelined :class:`OffloadStream`, the
dependent-graph scoreboard and the multi-tenant :class:`FabricScheduler`
(twin of ``repro.core``, with every name it exports)."""

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
from repro_torch.core.fabric import (
    ClusterLease,
    FabricHealth,
    FabricScheduler,
    LeaseError,
    LeaseUnavailable,
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
from repro_torch.core.scoreboard import (
    GraphError,
    GraphNode,
    InflightWindow,
    Ref,
    Scoreboard,
    resolve_graph,
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
from repro_torch.core.simulator import (
    FabricSimResult,
    GraphJob,
    GraphSimResult,
    JobSpec,
    SimResult,
    StagingCostModel,
    TenantWorkload,
    fabric_makespan_model,
    forward_model,
    graph_critical_path,
    isolated_graph_cycles,
    model_error,
    offload_overhead,
    simulate,
    simulate_fabric,
    simulate_forward,
    simulate_graph,
    simulate_staging,
    speedups,
    staging_model,
    staging_model_error,
)
from repro_torch.core.stream import OffloadStream

__all__ = [
    "AUTO", "AddressMap", "BroadcastTree", "ClusterLease", "Completion",
    "CompletionTimeout", "CompletionUnit", "DEFAULT_PARAMS",
    "DispatchPlan", "DonatedOperandError", "Estimate", "Explain",
    "FabricHealth", "FabricScheduler", "FabricSimResult",
    "FaultError", "FaultInjector", "FaultKind", "FaultPlan", "FaultSpec",
    "FusedHandle", "GraphError", "GraphHandle", "GraphJob", "GraphNode",
    "GraphSimResult", "InflightWindow", "InfoDist", "JobHandle", "JobSpec",
    "LeaseError", "LeaseUnavailable", "MulticastRequest", "OccamyParams",
    "OffloadConfig", "OffloadPolicy", "OffloadRuntime", "OffloadStream",
    "PAPER_JOBS", "PaperJob", "Phase", "PhaseStats", "Placement",
    "PlanDecision", "PlanStats", "Planner", "Ref", "ReliableHandle",
    "Residency", "RetryPolicy", "SchedulerPolicy", "Scoreboard", "Session",
    "SessionHandle", "SessionHealth", "SimResult", "Staging",
    "StagingCostModel", "Tenant", "TenantKind", "TenantWorkload",
    "TreeStager",
    "atax_closed_form_paper", "axpy_closed_form", "build_tree",
    "count_collectives", "deadline_cycles", "decode_cluster_selection",
    "decode_match", "depth_bound", "encode_cluster_selection",
    "encode_cluster_selection_multi", "estimate", "fabric_makespan_model",
    "forward_model", "graph_critical_path", "isolated_graph_cycles",
    "make_instances", "model_error", "offload_overhead",
    "optimal_clusters", "place_pytree", "predict", "predict_recovery",
    "predict_staging", "predict_total", "predict_total_v2",
    "resolve_graph", "should_offload", "simulate", "simulate_fabric",
    "simulate_forward", "simulate_graph", "simulate_staging", "speedups",
    "stack_instances", "staging_model", "staging_model_error",
    "tree_from_request", "validate",
]
