"""The stable diagnostic vocabulary of the static offload verifier.

Eight PRs of runtime invariants — donation rules, WAR/WAW renaming,
lease residency, policy contradictions, in-flight window bounds — were
each enforced by a scattered ad-hoc exception that fired *after*
dispatch.  This module is the compiler-front-end answer: one table of
stable ``OFL###`` codes, each with a severity, a one-line title, and a
long-form ``explain()`` text, plus the typed :class:`Diagnostic` record
every verifier pass and every legacy-exception shim reports through.

The module is deliberately dependency-free (no jax, no other ``repro_torch``
imports): :mod:`repro_torch.core.policy` raises through it from failure
branches, so it must sit below every core module in the import graph.
"""

from __future__ import annotations

import collections
import dataclasses
import difflib
import enum
import json
from typing import (
    Any, Deque, Dict, Iterable, Iterator, List, Mapping, Optional, Tuple,
    Type,
)

__all__ = [
    "CODES", "Diagnostic", "DiagnosticsLog", "Severity",
    "UnknownDiagnosticCode", "contradiction", "explain", "invalid_field",
    "invalid_mode", "use_after_donate",
]


class Severity(str, enum.Enum):
    """How a diagnostic gates a submit: ``ERROR`` raises before any
    staging, ``WARNING`` is advisory (the runtime handles the hazard —
    e.g. by renaming — but the descriptor could be cheaper without it),
    and ``PERF`` never gates — the descriptor is *correct* but the §6
    cost model predicts a cheaper configuration (``OFLP1##`` codes from
    :mod:`repro_torch.analysis.perflint`, each carrying a predicted cycle
    delta and a machine-applicable fix).
    """

    ERROR = "error"
    WARNING = "warning"
    PERF = "perf"


@dataclasses.dataclass(frozen=True)
class _CodeInfo:
    title: str
    severity: Severity
    explain: str


#: The stable code table.  Codes are append-only: a released code keeps
#: its number and meaning forever (tests snapshot this table the way
#: ``tests/test_api_surface.py`` snapshots the API).
CODES: Dict[str, _CodeInfo] = {
    "OFL001": _CodeInfo(
        "dependency cycle", Severity.ERROR,
        "The graph's dataflow (Ref operands) and ordering (after=) edges "
        "form a cycle, so no issue order exists: the scoreboard could "
        "never find a ready node.  A node depending on itself is the "
        "degenerate one-node cycle.  Break the cycle by removing an edge "
        "or splitting the graph into two submits."),
    "OFL002": _CodeInfo(
        "dangling or malformed node reference", Severity.ERROR,
        "A Ref or after= entry names a node that does not exist (unknown "
        "name, index outside the node list), two nodes share a name, an "
        "entry is not a GraphNode, a node's operands are not a mapping "
        "or Residency.RESIDENT, or the graph is empty.  The reference "
        "can never resolve to a producer result."),
    "OFL003": _CodeInfo(
        "use-after-donate", Severity.ERROR,
        "An operand (or forwarded producer result) is a device buffer "
        "that a donating dispatch already consumed — XLA deleted it on "
        "launch.  Restage the value from its host copy "
        "(plan.resident_operands restores resident buffers "
        "automatically) or disable donate_operands for buffers that "
        "must stay readable."),
    "OFL004": _CodeInfo(
        "WAR/WAW rename required", Severity.WARNING,
        "Under donate_operands a consumer launch would consume a "
        "forwarded producer buffer that other readers (or a later "
        "fetch) still need.  The graph dispatcher renames — copies — "
        "the buffer before the donating consumer, so the run is "
        "correct, but each such edge pays one device-side copy "
        "(PlanStats.renames).  Disable donation for the graph policy "
        "to forward by aliasing instead."),
    "OFL005": _CodeInfo(
        "cross-lease circular wait", Severity.WARNING,
        "The graph's dependency edges cross session leases in a cycle "
        "(lease A waits on lease B which waits on lease A).  The "
        "single-host scoreboard still finds an issue order, but the "
        "leases cannot drain independently — a distributed dispatcher "
        "would deadlock.  Restructure so cross-lease edges flow one "
        "way, or keep the cyclic portion inside one lease."),
    "OFL006": _CodeInfo(
        "sharding mismatch", Severity.ERROR,
        "An operand's shard axis is not divisible by the node's cluster "
        "selection, or a forwarded producer result's shape cannot "
        "satisfy the consumer kernel — the dispatch plan could never "
        "build.  Resize the operand, change the selection width, or fix "
        "the forward edge."),
    "OFL007": _CodeInfo(
        "graph width exceeds the in-flight window", Severity.WARNING,
        "More nodes become ready at once than the in-flight window "
        "(policy.window, capped by the runtime's completion-unit "
        "copies) can hold, so issue will stall draining the oldest "
        "in-flight job (InflightWindow.stalls counts these).  Raise "
        "policy.window / n_units, or narrow the graph."),
    "OFL008": _CodeInfo(
        "invalid mode value", Severity.ERROR,
        "A mode field (staging, residency, info_dist, completion, via) "
        "is not a member of its enum — a typo like "
        "info_dist='mulitcast' would otherwise silently misconfigure "
        "the run.  Use the typed enums from repro_torch.core.policy."),
    "OFL009": _CodeInfo(
        "invalid policy field", Severity.ERROR,
        "A numeric or typed policy field is out of range: fuse/window/"
        "depth below 1, RetryPolicy bounds (max_attempts >= 1, "
        "deadline_factor > 1, backoff >= 1), or a field of the wrong "
        "type."),
    "OFL010": _CodeInfo(
        "policy contradiction", Severity.ERROR,
        "Two policy fields cannot hold at once: residency=RESIDENT "
        "stages no operands so a pinned non-DIRECT staging could never "
        "run, and graph submits do not ride the retry/deadline ladder "
        "(policy.retry must be None for submit_graph)."),
    "OFL011": _CodeInfo(
        "inactive lease", Severity.ERROR,
        "The submit targets a lease that is no longer active — it was "
        "released, revoked, or superseded by a resize.  Request a new "
        "lease from the scheduler (or use the current lease object) "
        "before submitting."),
    # -- OFLP1##: performance findings (repro_torch.analysis.perflint) ---------
    "OFLP101": _CodeInfo(
        "suboptimal staging mode", Severity.PERF,
        "The pinned policy.staging moves the replicated operand "
        "footprint over a slower leg than the §6 staging model's best "
        "mode for this byte count and cluster selection (host fan-out "
        "vs. the quadrant fan-out tree).  The finding carries the "
        "predicted cycle delta; apply the suggested staging= pin or "
        "leave the field open so the planner decides.  Note the cycle "
        "model favors the tree from ~4 clusters at any size; on a "
        "cache-dominated host substrate the wallclock crossover sits "
        "near Planner.tree_min_bytes (see the staging_wall bench)."),
    "OFLP102": _CodeInfo(
        "missed fusion opportunity", Severity.PERF,
        "A batched submit pins policy.fuse below the model-optimal "
        "factor: the dispatch-constant phases (A-D, H, I) are paid per "
        "launch and amortize with B, and for this job the host-side "
        "constant dominates the device phases, so a larger fuse "
        "strictly reduces predicted per-job cycles.  Apply the "
        "suggested fuse= or leave it open for the planner."),
    "OFLP103": _CodeInfo(
        "in-flight window below model-optimal", Severity.PERF,
        "policy.window pins the pipeline depth to 1 (or below the "
        "planner's pick) where the amortization model shows an open "
        "window overlapping the next launch's host-side constant with "
        "the current launch's device phases: t_job drops from "
        "t_const/B + t_E + t_F + t_G to max(t_const/B + t_E, t_F + "
        "t_G).  Apply the suggested window= or leave it open."),
    "OFLP104": _CodeInfo(
        "reshard/forward on the critical path", Severity.PERF,
        "A dataflow edge crosses cluster selections, so the consumer "
        "pays a device-to-device forward (DMA setup + transfer + "
        "cross-quadrant hops) on the graph's critical path; aligning "
        "the consumer's selection with its producer forwards by "
        "aliasing at zero modeled cost and lowers the predicted "
        "makespan.  The fix rewrites the consumer node's clusters=."),
    "OFLP105": _CodeInfo(
        "selection breaks single-request multicast", Severity.PERF,
        "The cluster selection is not one aligned power-of-two subcube, "
        "so the one-write wakeup (paper §5) decomposes into multiple "
        "multicast requests — each extra request replays the "
        "dispatch-constant phases.  An aligned window of the same (or "
        "nearest) width dispatches in a single request; the fix "
        "rewrites clusters= to the cheapest single-request window by "
        "predicted total cycles."),
    "OFLP106": _CodeInfo(
        "resident operand never reused", Severity.PERF,
        "Session.stage() paid the staging leg to pin operands resident, "
        "but no later submit redispatched them "
        "(residency=Residency.RESIDENT): the staging cycles and the "
        "device memory are pure waste.  Drop the stage() call, or "
        "redispatch against the warm buffers."),
    "OFLP107": _CodeInfo(
        "donation disabled on a dead buffer", Severity.PERF,
        "A fused batch launch stages fresh host operands whose stacked "
        "device buffers die at launch, and an operand matches the "
        "output shape — with donate_operands=False XLA must allocate "
        "and fill a fresh output buffer per launch instead of aliasing "
        "the dead operand in place.  Pin donate_operands=True (safe: "
        "fresh-staged buffers have no other readers) to save one "
        "buffer copy per launch and halve peak device memory."),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One typed finding of the static verifier (or a runtime shim).

    ``code`` indexes :data:`CODES`; ``node``/``name`` locate the
    offending graph node (index and, when it has one, its
    ``GraphNode.name`` — or the offending policy/operand field);
    ``suggestion`` is the actionable fix (defaulted from the code
    table's explain text when left empty).
    """

    code: str
    message: str
    severity: Severity = Severity.ERROR
    node: Optional[int] = None
    name: Optional[str] = None
    suggestion: str = ""

    def __post_init__(self) -> None:
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r} "
                             f"(known: {sorted(CODES)})")
        info = CODES[self.code]
        object.__setattr__(self, "severity", Severity(self.severity))
        if not self.suggestion:
            object.__setattr__(self, "suggestion", info.explain)

    @property
    def title(self) -> str:
        return CODES[self.code].title

    def __str__(self) -> str:
        where = ""
        if self.node is not None:
            where = f" [node {self.node}" + (
                f" ({self.name})]" if self.name else "]")
        elif self.name is not None:
            where = f" [{self.name}]"
        return f"{self.code}: {self.message}{where}"

    def to_json(self) -> str:
        """Stable JSON serialization (round-trips via :meth:`from_json`)."""
        return json.dumps({
            "code": self.code,
            "title": self.title,
            "severity": self.severity.value,
            "message": self.message,
            "node": self.node,
            "name": self.name,
            "suggestion": self.suggestion,
        }, sort_keys=True)

    @classmethod
    def from_json(cls, payload: str) -> "Diagnostic":
        d: Mapping[str, Any] = json.loads(payload)
        return cls(code=d["code"], message=d["message"],
                   severity=Severity(d["severity"]), node=d.get("node"),
                   name=d.get("name"), suggestion=d.get("suggestion", ""))

    def as_error(self, cls: Type[Exception] = ValueError) -> Exception:
        """This diagnostic as a raisable exception of type ``cls``.

        The legacy-exception shims use this: the raised error keeps its
        historical type (so existing ``except`` clauses keep working)
        while carrying ``.code`` and ``.diagnostic`` for new callers.
        """
        err = cls(str(self))
        err.code = self.code                 # type: ignore[attr-defined]
        err.diagnostic = self                # type: ignore[attr-defined]
        return err


class UnknownDiagnosticCode(KeyError):
    """``explain()`` was asked about a code the table does not know.

    Subclasses :class:`KeyError` (the historical behavior) but carries
    the offending ``.code`` and a nearest-known-code ``.suggestion``
    so CLIs and error surfaces can answer "did you mean OFLP101?"
    instead of a bare traceback.
    """

    def __init__(self, code: str):
        self.code = code
        matches = difflib.get_close_matches(
            str(code).upper(), sorted(CODES), n=1, cutoff=0.4)
        self.suggestion: Optional[str] = matches[0] if matches else None
        hint = f" — did you mean {self.suggestion!r}?" if self.suggestion \
            else ""
        super().__init__(f"unknown diagnostic code {code!r}{hint} "
                         f"(known: {sorted(CODES)})")

    def __str__(self) -> str:
        # KeyError.__str__ repr()s its single arg; keep the message flat.
        return str(self.args[0])


def explain(code: str) -> str:
    """Long-form explanation of a diagnostic code (``OFL001``...).

    Raises :class:`UnknownDiagnosticCode` (a :class:`KeyError`) with a
    nearest-code suggestion when the code is not in the table.
    """
    info = CODES.get(code)
    if info is None:
        raise UnknownDiagnosticCode(code)
    return f"{code} [{info.severity.value}] {info.title}: {info.explain}"


class DiagnosticsLog:
    """Bounded in-memory diagnostics table for long-lived sessions.

    The verifier and the perf linter report findings on *every* submit;
    a serve loop that runs for days would grow an append-only list
    without bound.  This is the fix: a ring buffer of the most recent
    ``limit`` diagnostics plus counters that never lose information —
    ``total`` counts every record ever made and ``dropped`` how many
    fell off the front (``total - len(log)``).

    ``limit <= 0`` disables retention entirely (counters still tick).
    """

    def __init__(self, limit: int = 256):
        self.limit = int(limit)
        self._buf: Deque[Diagnostic] = collections.deque(
            maxlen=max(0, self.limit))
        self.total = 0

    @property
    def dropped(self) -> int:
        """Diagnostics that fell off the front of the ring."""
        return self.total - len(self._buf)

    def record(self, diags: Iterable[Diagnostic]) -> None:
        for d in diags:
            self.total += 1
            if self.limit > 0:
                self._buf.append(d)

    def snapshot(self) -> List[Diagnostic]:
        """The retained diagnostics, oldest first (a copy)."""
        return list(self._buf)

    def counts(self) -> Dict[str, int]:
        """Retained diagnostics histogrammed by code."""
        out: Dict[str, int] = {}
        for d in self._buf:
            out[d.code] = out.get(d.code, 0) + 1
        return out

    def clear(self) -> None:
        self._buf.clear()
        self.total = 0

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self) -> Iterator[Diagnostic]:
        return iter(self._buf)

    def __repr__(self) -> str:
        return (f"DiagnosticsLog(limit={self.limit}, retained={len(self)}, "
                f"total={self.total}, dropped={self.dropped})")


# -- shim constructors (the core modules raise through these) ----------------


def invalid_mode(field: str, value: Any,
                 valid: Tuple[str, ...]) -> Diagnostic:
    """OFL008: an enum-valued mode field rejected a value."""
    return Diagnostic("OFL008", f"{field} {value!r} not in {valid}",
                      name=field)


def invalid_field(field: str, message: str) -> Diagnostic:
    """OFL009: a policy field failed its range/type validation."""
    return Diagnostic("OFL009", message, name=field)


def contradiction(message: str, name: Optional[str] = None) -> Diagnostic:
    """OFL010: two policy fields cannot hold at once."""
    return Diagnostic("OFL010", message, name=name)


def use_after_donate(what: str, node: Optional[int] = None,
                     name: Optional[str] = None) -> Diagnostic:
    """OFL003: a donated (deleted) device buffer would be read."""
    return Diagnostic(
        "OFL003", f"{what} was deleted by a donating dispatch",
        node=node, name=name,
        suggestion=(
            "restage it from the host copy (plan.resident_operands "
            "restores resident buffers automatically) or disable "
            "donate_operands for buffers that must stay readable"))
