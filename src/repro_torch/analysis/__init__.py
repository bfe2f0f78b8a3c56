"""Offload diagnostics, the static verifier and the hazard sanitizer (twin
of ``repro.analysis``).

* :mod:`~repro_torch.analysis.diagnostics` — the stable ``OFL###`` code
  table and the typed :class:`Diagnostic` record (dependency-free leaf).
* :mod:`~repro_torch.analysis.verifier` — :func:`verify_graph` /
  :func:`verify` / :func:`verify_policy`, run automatically by
  :class:`repro_torch.core.session.Session` before any staging.
* :mod:`~repro_torch.analysis.sanitizer` — ``REPRO_SANITIZE=1``
  vector-clock happens-before instrumentation of the live runtime
  protocol (dependency-free leaf).

The reference's fourth module, the performance linter ``perflint``, is
not ported yet.  The leaves import eagerly; the verifier pulls in the
core modules, so its names resolve lazily (PEP 562) — core modules may
``from repro_torch.analysis import diagnostics, sanitizer`` at module
level without a cycle.
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
    "CODES", "Diagnostic", "DiagnosticsLog", "Sanitizer", "SanitizerError",
    "Severity", "UnknownDiagnosticCode", "VerificationError",
    "contradiction", "diagnostics", "explain", "invalid_field",
    "invalid_mode", "sanitizer", "use_after_donate", "verifier", "verify",
    "verify_graph", "verify_policy",
]

_VERIFIER_NAMES = ("VerificationError", "verify", "verify_graph",
                   "verify_policy", "raise_errors")


def __getattr__(name: str) -> Any:
    if name == "verifier" or name in _VERIFIER_NAMES:
        import importlib
        mod = importlib.import_module(".verifier", __name__)
        if name == "verifier":
            return mod
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
