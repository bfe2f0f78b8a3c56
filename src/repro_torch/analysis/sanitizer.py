"""Virtual-cycle hazard sanitizer — ``REPRO_SANITIZE=1``.

Vector-clock happens-before instrumentation for the offload runtime's
host-side protocol.  The core modules call the hooks below at every
buffer staging/forward/donation, scoreboard issue/retire, completion
collect/cancel, and lease grant; when the sanitizer is off
(:func:`active` returns ``None`` — the default) each hook site costs
one function call and a ``None`` check, so the instrumented runtime is
the shipped runtime.

What it asserts (each violation raises :class:`SanitizerError` with
both events' vector clocks in the message):

* **no read-after-donate / read-after-revoke** — every staged, forwarded
  or result buffer is tracked; a donating launch marks its operands
  donated, ``DispatchPlan.invalidate`` marks residents revoked, and any
  later read of such a buffer (forward, resident redispatch, result
  fetch) fails.
* **issue order consistent with declared deps** — a scoreboard node's
  issue event must happen-after every producer's issue event: each
  node's clock is the merge of its producers' clocks plus its own tick,
  so a consumer issued before a producer has no clock to merge and
  fails.  Retire requires issued-exactly-once.
* **completion protocol** — ``collect`` must follow ``program`` for the
  same job on the same unit and never repeats; ``cancel`` withdraws the
  job so a later collect of it fails.
* **no lease-window overlap** — a fabric grant must not hand a cluster
  that another live lease still owns.

The module is dependency-free (no jax, no other ``repro_torch`` imports) so
every core module can import it at module level without cycles.
"""

from __future__ import annotations

import os
import weakref
from typing import Any, Dict, List, Mapping, Optional, Tuple

__all__ = [
    "SanitizerError", "Sanitizer", "VClock", "active", "disable", "enable",
]

ENV_VAR = "REPRO_SANITIZE"


class SanitizerError(RuntimeError):
    """A virtual-cycle hazard the sanitizer caught (see module docs)."""


class VClock:
    """A tiny vector clock: one component per event actor."""

    __slots__ = ("_c",)

    def __init__(self, components: Optional[Mapping[str, int]] = None):
        self._c: Dict[str, int] = dict(components or {})

    def tick(self, actor: str) -> "VClock":
        self._c[actor] = self._c.get(actor, 0) + 1
        return self

    def merge(self, other: "VClock") -> "VClock":
        for k, v in other._c.items():
            if v > self._c.get(k, 0):
                self._c[k] = v
        return self

    def dominates(self, other: "VClock") -> bool:
        """True when every component of ``other`` is <= ours (other
        happened-before-or-equal this clock)."""
        return all(self._c.get(k, 0) >= v for k, v in other._c.items())

    def copy(self) -> "VClock":
        return VClock(self._c)

    def __repr__(self) -> str:
        inner = ",".join(f"{k}:{v}" for k, v in sorted(self._c.items()))
        return "{" + inner + "}"


#: tracked-buffer lifecycle states
_LIVE, _DONATED, _REVOKED = "live", "donated", "revoked"


class Sanitizer:
    """The event recorder + hazard checks.  One instance per process
    (see :func:`active`); tests may construct their own via
    :func:`enable`."""

    def __init__(self) -> None:
        self.events = 0
        self.violations = 0
        self._now = VClock()
        # id(buffer) -> [state, description, strong ref, state's clock].
        # The strong ref pins the id; donation deletes the device memory
        # regardless, so the tombstone costs only the host object.
        self._buffers: Dict[int, List[Any]] = {}
        # scoreboard id -> [weakref|None, node->issue clock, node->state].
        # The weakref guards against id() reuse: a fresh scoreboard at a
        # recycled address must not inherit a dead one's state.
        self._sb: Dict[int, List[Any]] = {}
        # completion-unit id -> [weakref|None, programmed, collected]
        self._units: Dict[int, List[Any]] = {}

    # -- plumbing -----------------------------------------------------------

    def _fail(self, message: str) -> None:
        self.violations += 1
        raise SanitizerError(f"{ENV_VAR}: {message}")

    def _tick(self, actor: str = "host") -> VClock:
        self.events += 1
        return self._now.tick(actor).copy()

    @staticmethod
    def _slot(table: Dict[int, List[Any]], obj: Any,
              fresh: Tuple[Any, ...]) -> List[Any]:
        """Per-object state, keyed by id but pinned by weakref so a new
        object at a recycled address starts clean.  Ints (tests driving
        the hooks directly) key by value and persist."""
        key = obj if isinstance(obj, int) else id(obj)
        rec = table.get(key)
        if rec is not None and (rec[0] is None or rec[0]() is obj):
            return rec
        ref = None
        if not isinstance(obj, int):
            try:
                ref = weakref.ref(obj)
            except TypeError:
                ref = None
        rec = [ref] + [f() for f in fresh]
        table[key] = rec
        return rec

    # -- buffer lifecycle ---------------------------------------------------

    def track(self, buf: Any, what: str) -> None:
        """A buffer came alive (staged, forwarded copy, launch result)."""
        if buf is None:
            return
        self._buffers[id(buf)] = [_LIVE, what, buf, self._tick()]

    def read(self, buf: Any, what: str) -> None:
        """``what`` reads ``buf`` — fails if donated/revoked."""
        if buf is None:
            return
        vc = self._tick()
        rec = self._buffers.get(id(buf))
        if rec is not None and rec[0] != _LIVE:
            self._fail(
                f"read-after-{rec[0]}: {what} reads {rec[1]}, "
                f"{rec[0]} at {rec[3]!r} (read at {vc!r})")

    def _mark(self, buf: Any, state: str, what: Optional[str]) -> None:
        if buf is None:
            return
        vc = self._tick()
        rec = self._buffers.get(id(buf))
        if rec is None:
            self._buffers[id(buf)] = [state, what or "buffer", buf, vc]
        else:
            rec[0], rec[3] = state, vc

    def donate(self, buf: Any, what: Optional[str] = None) -> None:
        """A donating launch consumed ``buf`` (XLA deleted it)."""
        self._mark(buf, _DONATED, what)

    def revoke(self, buf: Any, what: Optional[str] = None) -> None:
        """``buf`` was invalidated (plan.invalidate / lease revocation)."""
        self._mark(buf, _REVOKED, what)

    def revive(self, buf: Any, what: str) -> None:
        """A restage replaced ``buf``'s role with a fresh live buffer."""
        self.track(buf, what)

    # -- scoreboard issue/retire --------------------------------------------

    def sb_issue(self, sb: Any, node: int, deps: Tuple[int, ...]) -> None:
        rec = self._slot(self._sb, sb, (dict, dict))
        clocks, states = rec[1], rec[2]
        if node in states:
            self._fail(f"scoreboard node {node} issued twice "
                       f"(state {states[node]!r})")
        vc = VClock()
        for d in deps:
            dvc = clocks.get(d)
            if dvc is None:
                self._fail(
                    f"issue order violates declared deps: node {node} "
                    f"issued before its producer {d} (issued so far: "
                    f"{sorted(clocks)})")
            else:
                vc.merge(dvc)
        sid = sb if isinstance(sb, int) else id(sb)
        vc.tick(f"sb{sid % 9973}.n{node}")
        self.events += 1
        clocks[node] = vc
        states[node] = "issued"
        # sanity: by construction our clock dominates every producer's
        for d in deps:
            if not vc.dominates(clocks[d]):
                self._fail(
                    f"node {node}'s issue clock {vc!r} does not dominate "
                    f"producer {d}'s {clocks[d]!r}")

    def sb_retire(self, sb: Any, node: int) -> None:
        states = self._slot(self._sb, sb, (dict, dict))[2]
        if states.get(node) != "issued":
            self._fail(f"retire of scoreboard node {node} in state "
                       f"{states.get(node)!r} (want 'issued')")
        states[node] = "retired"
        self.events += 1

    # -- completion unit ----------------------------------------------------

    def unit_program(self, unit: Any, job_id: int) -> None:
        rec = self._slot(self._units, unit, (set, set))
        rec[1].add(job_id)
        rec[2].discard(job_id)
        self.events += 1

    def unit_collect(self, unit: Any, job_id: int) -> None:
        rec = self._slot(self._units, unit, (set, set))
        programmed, collected = rec[1], rec[2]
        if job_id in collected:
            self._fail(f"job {job_id} collected twice from completion "
                       "unit (double retire/wait would steal another "
                       "job's parked cause)")
        if job_id not in programmed:
            self._fail(f"collect for job {job_id} that was never "
                       "programmed on this unit (or was cancelled)")
        collected.add(job_id)
        self.events += 1

    def unit_cancel(self, unit: Any, job_id: int) -> None:
        # cancel withdraws the job: a later collect of it is a hazard
        rec = self._slot(self._units, unit, (set, set))
        rec[1].discard(job_id)
        rec[2].discard(job_id)
        self.events += 1

    # -- fabric leases ------------------------------------------------------

    def lease_grant(self, lease_id: int, clusters: Tuple[int, ...],
                    owner: Mapping[int, int]) -> None:
        """Check a grant's window against the scheduler's live owner map
        (a resize re-granting the same lease id is not an overlap)."""
        self.events += 1
        clash = {c: owner[c] for c in clusters
                 if c in owner and owner[c] != lease_id}
        if clash:
            self._fail(
                f"lease-window overlap: lease {lease_id} granted "
                f"clusters {sorted(clash)} still owned by leases "
                f"{sorted(set(clash.values()))}")

    # -- reporting ----------------------------------------------------------

    def report(self) -> Dict[str, int]:
        return {"events": self.events, "violations": self.violations,
                "tracked_buffers": len(self._buffers)}


_instance: Optional[Sanitizer] = None
_resolved = False


def active() -> Optional[Sanitizer]:
    """The process sanitizer, or ``None`` when off (the hook fast path).

    Resolved once from ``REPRO_SANITIZE`` (any value but ``""``/``0``
    enables); :func:`enable`/:func:`disable` override programmatically.
    """
    global _instance, _resolved
    if not _resolved:
        _resolved = True
        if os.environ.get(ENV_VAR, "0") not in ("", "0"):
            _instance = Sanitizer()
    return _instance


def enable() -> Sanitizer:
    """Turn the sanitizer on for this process (fresh instance)."""
    global _instance, _resolved
    _resolved = True
    _instance = Sanitizer()
    return _instance


def disable() -> None:
    """Turn the sanitizer off for this process."""
    global _instance, _resolved
    _resolved = True
    _instance = None
