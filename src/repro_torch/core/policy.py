"""Typed offload policies — the session API's vocabulary.

The runtime grew four stringly-typed mode knobs across PRs 1–3: the
``"resident"`` operand sentinel, ``OffloadConfig.info_dist`` /
``.completion`` raw strings, and the ``staging`` / ``via=`` strategy
strings threaded through ``DispatchPlan.stage``, ``OffloadStream`` and
``ServeConfig``.  A typo in any of them (``info_dist="mulicast"``) used to
silently misconfigure the run.  This module replaces them with enums —
string-valued, so they compare and hash like their legacy spellings and
flow through every existing code path — and bundles them, together with
the fusion/pipelining knobs that used to be separate *methods*
(``offload_fused``, ``OffloadStream``), into one immutable
:class:`OffloadPolicy`.

``AUTO`` is the headline policy: every decidable field is left ``None``
and the session planner (:mod:`repro_torch.core.session`) fills it in from the
simulator's dispatch and staging cost models — mode selection driven by
the paper's quantitative runtime model (§6; Colagrande & Benini,
arXiv:2404.01908) instead of per-call hardcoding.

Legacy raw strings are still accepted everywhere (coerced, validated)
but raise :class:`DeprecationWarning` — the validated deprecation shims
of the migration path documented in the README's "Session API" section.
"""

from __future__ import annotations

import dataclasses
import enum
import warnings
from typing import Any, Dict, Optional, Tuple, Type, TypeVar, Union


class Staging(str, enum.Enum):
    """Phase-E placement strategy for replicated operands.

    Mirrors ``repro_torch.core.broadcast.STAGING_MODES`` (the legacy string
    surface) member for member; see ``DispatchPlan.stage`` for the data
    paths.
    """

    DIRECT = "direct"            # one replicated device_put (O(n) host link)
    HOST_FANOUT = "host_fanout"  # explicit sequential O(n) baseline
    TREE = "tree"                # hierarchical broadcast: O(1) host link
    TREE_RESHARD = "tree_reshard"  # tree root upload + resharding fast path


class Residency(str, enum.Enum):
    """Whether a submit stages fresh operands or reuses resident buffers."""

    FRESH = "fresh"              # phase-E stage the passed operands
    RESIDENT = "resident"        # reuse the plan's resident device buffers


class InfoDist(str, enum.Enum):
    """Job-information distribution (paper §4.2)."""

    MULTICAST = "multicast"      # replicated job info, O(log n) broadcast
    P2P_CHAIN = "p2p_chain"      # the baseline's O(n) collective-permute chain


class Completion(str, enum.Enum):
    """Job-completion synchronization (paper §4.3)."""

    UNIT = "unit"                # the job completion unit (fused psum)
    CENTRAL_COUNTER = "central_counter"  # software central-counter chain


class TenantKind(str, enum.Enum):
    """What a fabric tenant is, to the scheduler's admission model.

    A ``SERVE`` tenant is resident — it holds a floor lease indefinitely
    and bursts above it between decode batches; an ``OFFLOAD`` tenant is
    bursty — it leases for a bounded job stream and releases.  The
    :class:`repro_torch.core.fabric.FabricScheduler` favors leaving head-room
    for the resident class when slicing the fabric.
    """

    OFFLOAD = "offload"
    SERVE = "serve"


_E = TypeVar("_E", bound=enum.Enum)


def coerce_enum(enum_cls: Type[_E], value: Union[str, _E], field: str,
                *, warn_legacy: bool = False) -> _E:
    """Validate ``value`` as a member of ``enum_cls`` (coercing strings).

    With ``warn_legacy=True`` a raw string (the pre-session spelling)
    additionally raises a :class:`DeprecationWarning` pointing at the
    typed replacement — enum members always pass silently.  An unknown
    value raises :class:`ValueError` naming the valid set, so a typo like
    ``info_dist="mulicast"`` fails loudly instead of misconfiguring the
    run.
    """
    if isinstance(value, enum_cls):
        return value
    try:
        member = enum_cls(value)
    except ValueError:
        from repro_torch.analysis.diagnostics import invalid_mode
        valid = tuple(m.value for m in enum_cls)
        raise invalid_mode(field, value, valid).as_error(ValueError) from None
    if warn_legacy:
        warnings.warn(
            f"passing {field} as a raw string ({value!r}) is deprecated; "
            f"use {enum_cls.__name__}.{member.name} (repro_torch.core.policy)",
            DeprecationWarning, stacklevel=3)
    return member


def warn_legacy(old: str, new: str) -> None:
    """One legacy-surface deprecation warning, uniformly worded."""
    warnings.warn(f"{old} is deprecated; use {new} (repro_torch.core.policy)",
                  DeprecationWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Model-driven deadlines and the recovery escalation ladder.

    The deadline of attempt ``a`` is the §6 ``Session.estimate`` job
    total × ``deadline_factor`` × ``backoff^a`` — *virtual cycles*, not
    wallclock, so recovery is deterministic (this replaces
    ``StepWatchdog``'s latency-history cold-start heuristic for the
    offload path).  On a trip the session escalates:

      1. resubmit in the lease (transient faults — lost arrivals,
         stalls — succeed here),
      2. a disjoint backup window inside the lease, address-mask
         encoded (``backup=True``; also the speculative race partner
         for stragglers that complete but blow the deadline),
      3. full lease failover through ``FabricScheduler.fail_clusters``
         (``failover=True``), shrinking gracefully when no equal-size
         healthy window exists.

    ``max_attempts`` bounds the trips before :class:`~repro_torch.core.
    faults.FaultError`.
    """

    max_attempts: int = 3
    deadline_factor: float = 3.0
    backoff: float = 2.0
    backup: bool = True
    failover: bool = True

    def __post_init__(self) -> None:
        from repro_torch.analysis.diagnostics import invalid_field
        if self.max_attempts < 1:
            raise invalid_field(
                "max_attempts",
                f"max_attempts must be >= 1, got {self.max_attempts}"
            ).as_error(ValueError)
        if self.deadline_factor <= 1.0:
            raise invalid_field(
                "deadline_factor",
                f"deadline_factor must be > 1 (a deadline at or below the "
                f"prediction trips every job), got {self.deadline_factor}"
            ).as_error(ValueError)
        if self.backoff < 1.0:
            raise invalid_field(
                "backoff", f"backoff must be >= 1, got {self.backoff}"
            ).as_error(ValueError)


@dataclasses.dataclass(frozen=True)
class OffloadPolicy:
    """How a session submit is dispatched — every mode knob in one place.

    ``None`` in a decidable field (``staging``, ``fuse``, ``window``)
    means *let the planner decide from the cost models*; the module-level
    :data:`AUTO` policy leaves all three open.  Explicit values pin the
    decision (the typed spelling of every legacy hand-picked mode):

    * ``staging`` — phase-E strategy for replicated operands.
    * ``residency`` — ``FRESH`` stages the passed operands; ``RESIDENT``
      redispatches the plan's resident buffers (zero ``device_put``).
    * ``info_dist`` / ``completion`` — the paper's two implementations
      (§4.2/§4.3); defaults are the extended (multicast + unit) system.
    * ``fuse`` — dispatch batching factor B: B job instances stacked into
      one XLA launch (1 = no fusion).  Replaces ``offload_fused``.
    * ``window`` — in-flight pipeline window (1 = synchronous).  Replaces
      the ``OffloadStream`` constructor knob; capped by the runtime's
      completion-unit copies at submit time.
    * ``depth`` — staging buffer slots for the pipelined upload overlap.
    * ``donate_operands`` — XLA buffer donation, as in ``OffloadConfig``.
    * ``retry`` — a :class:`RetryPolicy` routes submits through the
      fault-tolerant path (model-driven deadlines + the escalation
      ladder); ``None`` (default) keeps the fast path with no deadline
      checks.
    """

    staging: Optional[Staging] = None
    residency: Residency = Residency.FRESH
    info_dist: InfoDist = InfoDist.MULTICAST
    completion: Completion = Completion.UNIT
    fuse: Optional[int] = None
    window: Optional[int] = None
    depth: int = 2
    donate_operands: bool = False
    retry: Optional[RetryPolicy] = None

    def __post_init__(self):
        coerce = object.__setattr__
        if self.staging is not None:
            coerce(self, "staging",
                   coerce_enum(Staging, self.staging, "staging"))
        coerce(self, "residency",
               coerce_enum(Residency, self.residency, "residency"))
        coerce(self, "info_dist",
               coerce_enum(InfoDist, self.info_dist, "info_dist"))
        coerce(self, "completion",
               coerce_enum(Completion, self.completion, "completion"))
        if self.retry is not None and not isinstance(self.retry, RetryPolicy):
            from repro_torch.analysis.diagnostics import invalid_field
            raise invalid_field(
                "retry", f"retry must be a RetryPolicy, got "
                         f"{type(self.retry).__name__}"
            ).as_error(TypeError)
        for field, lo in (("fuse", 1), ("window", 1), ("depth", 1)):
            v = getattr(self, field)
            if v is not None and (not isinstance(v, int) or v < lo):
                from repro_torch.analysis.diagnostics import invalid_field
                raise invalid_field(
                    field, f"{field} must be an int >= {lo}, got {v!r}"
                ).as_error(ValueError)
        # cross-field contradictions fail at construction, not mid-dispatch:
        # a RESIDENT submit stages nothing, so a pinned non-DIRECT staging
        # strategy could never run — silently ignoring it would misreport
        # every estimate/explain derived from the policy
        if (self.residency is Residency.RESIDENT
                and self.staging is not None
                and self.staging is not Staging.DIRECT):
            from repro_torch.analysis.diagnostics import contradiction
            raise contradiction(
                f"residency=RESIDENT stages no operands; pinning "
                f"staging={self.staging.value!r} is contradictory (leave "
                "staging unset or DIRECT)", name="staging"
            ).as_error(ValueError)

    @property
    def decided(self) -> bool:
        """True when no field is left for the planner."""
        return None not in (self.staging, self.fuse, self.window)

    def pinned(self, **fields) -> "OffloadPolicy":
        """A copy with ``fields`` replaced (typed ``dataclasses.replace``)."""
        return dataclasses.replace(self, **fields)

    def diff(self, other: "OffloadPolicy") -> Dict[str, Tuple[Any, Any]]:
        """Field-by-field delta to ``other``: ``{field: (mine, theirs)}``.

        The perf linter renders its ``suggested_policy`` through this
        (only the changed knobs, not the full record), and it is handy
        for explaining what a planner decision actually pinned.
        """
        out: Dict[str, Tuple[Any, Any]] = {}
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if a != b:
                out[f.name] = (a, b)
        return out


#: The model-driven policy: the planner picks staging mode, fusion factor
#: B, and in-flight window from the simulator's cost models, per
#: job-shape and cluster count.
AUTO = OffloadPolicy()
