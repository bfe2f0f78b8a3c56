"""Offload diagnostics, the static verifier, the hazard sanitizer and the
performance linter (twin of ``repro.analysis``).

* :mod:`~repro_torch.analysis.diagnostics` — the stable ``OFL###`` code
  table and the typed :class:`Diagnostic` record (dependency-free leaf).
* :mod:`~repro_torch.analysis.verifier` — :func:`verify_graph` /
  :func:`verify` / :func:`verify_policy`, run automatically by
  :class:`repro_torch.core.session.Session` before any staging.
* :mod:`~repro_torch.analysis.sanitizer` — ``REPRO_SANITIZE=1``
  vector-clock happens-before instrumentation of the live runtime
  protocol (dependency-free leaf).
* :mod:`~repro_torch.analysis.perflint` — the performance twin of the
  verifier: :func:`lint` / :func:`lint_graph` / :func:`lint_session`
  run the §6 cost models over a submission and emit ``OFLP1##``
  findings (severity ``PERF``) with machine-applicable fixes
  (:func:`perflint.apply`); surfaced by ``Session.submit(lint=True)``
  and the ``python -m repro_torch.lint`` CLI.

The leaves import eagerly; :mod:`~repro_torch.analysis.verifier` and
:mod:`~repro_torch.analysis.perflint` pull in the core modules, so their
names resolve lazily (PEP 562) — core modules may ``from
repro_torch.analysis import diagnostics, sanitizer`` at module level
without a cycle.
"""

from __future__ import annotations

from typing import Any

from . import diagnostics, sanitizer
from .diagnostics import (
    CODES, Diagnostic, DiagnosticsLog, Severity, UnknownDiagnosticCode,
    contradiction, explain, invalid_field, invalid_mode, use_after_donate,
)
from .sanitizer import Sanitizer, SanitizerError

__all__ = [
    "CODES", "Diagnostic", "DiagnosticsLog", "Fix", "PerfFinding",
    "Sanitizer", "SanitizerError", "Severity", "UnknownDiagnosticCode",
    "VerificationError", "contradiction", "diagnostics", "explain",
    "invalid_field", "invalid_mode", "lint", "lint_graph", "lint_session",
    "perflint", "sanitizer", "use_after_donate", "verifier", "verify",
    "verify_graph", "verify_policy",
]

_VERIFIER_NAMES = ("VerificationError", "verify", "verify_graph",
                   "verify_policy", "raise_errors")

_PERFLINT_NAMES = ("Applied", "Fix", "PerfFinding", "lint", "lint_graph",
                   "lint_session", "suggested_policy")


def __getattr__(name: str) -> Any:
    import importlib
    for mod_name, names in (("verifier", _VERIFIER_NAMES),
                            ("perflint", _PERFLINT_NAMES)):
        if name == mod_name or name in names:
            mod = importlib.import_module(f".{mod_name}", __name__)
            return mod if name == mod_name else getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
