"""The port's public surface, ``repro_torch.api``, pinned.

Its names are the reference's (``repro.api.__all__``) minus the one
named list of names whose modules are not ported yet
(``NOT_YET_PORTED``); its enums and the parameter lists of its public
callables are pinned here as ``tests/test_api_surface.py`` pins the
reference's, and held to the reference's signatures.  The deliberate
differences: a session or scheduler takes ``device``/``num_clusters``
(the logical clusters of one device) where the reference takes
``devices`` (one device per cluster), and ``elastic_restore`` takes the
keyword ``device`` (where the restored state lands) after the
reference's parameters.  ``repro_torch.core`` exports every name
``repro.core`` does.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import enum
import inspect
import subprocess
import sys

import repro.api as r_api
import repro.core as r_core
import repro_torch.api as api
import repro_torch.core as t_core

from conftest import SRC


def _params(fn):
    out = []
    for p in inspect.signature(fn).parameters.values():
        if p.name.startswith("_") or p.name == "self":
            continue
        name = p.name
        if p.kind is inspect.Parameter.VAR_POSITIONAL:
            name = "*" + name
        elif p.kind is inspect.Parameter.VAR_KEYWORD:
            name = "**" + name
        elif p.default is not inspect.Parameter.empty:
            name += "="
        out.append(name)
    return tuple(out)


NOT_YET_PORTED = ()

ENUMS = {
    "Staging": ("DIRECT", "HOST_FANOUT", "TREE", "TREE_RESHARD"),
    "Residency": ("FRESH", "RESIDENT"),
    "InfoDist": ("MULTICAST", "P2P_CHAIN"),
    "Completion": ("UNIT", "CENTRAL_COUNTER"),
    "Severity": ("ERROR", "WARNING", "PERF"),
    "TenantKind": ("OFFLOAD", "SERVE"),
    "FaultKind": ("CLUSTER_DEATH", "STRAGGLE", "HOST_LINK_STALL",
                  "LOST_ARRIVAL"),
}

#: the deliberate differences from the reference's signatures
DIFFERENT = {
    "Session": ("device=", "num_clusters=", "lease=", "policy=", "n_units=",
                "params=", "planner=", "runtime=", "faults=", "verify=",
                "lint=", "diag_limit="),
    "FabricScheduler": ("device=", "num_clusters=", "params=", "policy="),
}

#: public callables held to the reference's parameter lists
SAME = (
    "OffloadPolicy", "OffloadPolicy.pinned", "RetryPolicy", "OffloadConfig",
    "Planner", "Planner.decide", "Session.submit", "Session.submit_graph",
    "GraphNode", "Ref", "GraphHandle.wait", "GraphHandle.result",
    "FabricScheduler.submit_graph", "Session.estimate", "Session.stage",
    "Session.drain", "Session.close", "Session.health", "Session.runtime",
    "FabricScheduler.fail_clusters", "FabricScheduler.restore_clusters",
    "FabricScheduler.health", "FabricScheduler.current_lease",
    "FabricScheduler.request", "FabricScheduler.release",
    "FabricScheduler.resize", "FabricScheduler.session",
    "FabricScheduler.preempt", "FabricScheduler.revoke",
    "FabricScheduler.cancel", "FabricScheduler.compact",
    "FabricScheduler.drain_deadline", "FabricScheduler.predict_retry_after",
    "ClusterLease", "ClusterLease.requests", "Tenant", "SchedulerPolicy",
    "Overloaded", "SessionHandle.wait", "SessionHandle.explain",
    "ReliableHandle.wait", "ReliableHandle.explain", "FaultSpec",
    "FaultPlan", "FaultPlan.random", "FaultInjector", "deadline_cycles",
    "predict_recovery", "estimate", "predict_staging", "Diagnostic",
    "Diagnostic.to_json", "Diagnostic.from_json", "Diagnostic.as_error",
    "explain", "verify", "verify_graph", "verify_policy",
    "lint", "lint_graph", "Fix", "PerfFinding", "PerfFinding.key",
    "PerfFinding.to_payload", "PerfFinding.from_payload", "StepWatchdog",
    "StepWatchdog.deadline", "StepWatchdog.observe", "StepWatchdog.is_late",
    "WatchdogConfig", "BackupOffload", "BackupOffload.run", "ServeTenant",
    "ServeTenant.generate", "ServeTenant.generate_many", "ServeTenant.close",
    "ServeEngine.generate",
)


def _get(mod, path):
    obj = mod
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def test_exported_names_are_the_references_minus_the_unported():
    assert tuple(api.NOT_YET_PORTED) == NOT_YET_PORTED
    assert sorted(api.__all__) == sorted(set(r_api.__all__)
                                         - set(NOT_YET_PORTED))
    assert set(NOT_YET_PORTED) <= set(r_api.__all__)
    for name in api.__all__:
        assert hasattr(api, name), name
    for name in NOT_YET_PORTED:
        assert not hasattr(api, name), name


def test_core_exports_every_reference_name():
    assert set(r_core.__all__) <= set(t_core.__all__)
    for name in t_core.__all__:
        assert hasattr(t_core, name), name


def test_enum_members_pinned():
    for name, members in ENUMS.items():
        cls = getattr(api, name)
        assert issubclass(cls, enum.Enum)
        assert tuple(m.name for m in cls) == members, name
        assert members == tuple(m.name for m in getattr(r_api, name))


def test_auto_policy_shape():
    assert isinstance(api.AUTO, api.OffloadPolicy)
    assert (api.AUTO.staging, api.AUTO.fuse, api.AUTO.window) == (
        None, None, None)


def test_signatures_equal_the_references():
    drift = {p: (_params(_get(api, p)), _params(_get(r_api, p)))
             for p in SAME
             if _params(_get(api, p)) != _params(_get(r_api, p))}
    assert not drift, drift


def test_device_signatures_pinned():
    for path, expected in DIFFERENT.items():
        assert _params(_get(api, path)) == expected, path
        ref = _params(_get(r_api, path))
        assert ref[0] == "devices=" and expected[0] == "device="
        rest = [tuple(p for p in sig[1:] if p != "num_clusters=")
                for sig in (ref, expected)]
        assert rest[0] == rest[1], path


def test_elastic_restore_signature():
    assert _params(api.elastic_restore) == _params(r_api.elastic_restore) \
        + ("device=",)


def test_api_import_leaves_jax_out():
    code = ("import sys, repro_torch.api, repro_torch.core; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": SRC}, check=True)
    assert out.stdout.strip() == "[]", out.stdout
