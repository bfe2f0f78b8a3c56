"""Offload diagnostics and the hazard sanitizer (twin of ``repro.analysis``).

This slice carries the two dependency-free leaves the runtime uses:
:mod:`~repro_torch.analysis.diagnostics` (the ``OFL###`` code table and
:class:`Diagnostic`) and :mod:`~repro_torch.analysis.sanitizer`
(``REPRO_SANITIZE=1`` vector-clock instrumentation).
"""

from __future__ import annotations

from . import diagnostics, sanitizer
from .diagnostics import (
    CODES, Diagnostic, DiagnosticsLog, Severity, UnknownDiagnosticCode,
    contradiction, explain, invalid_field, invalid_mode, use_after_donate,
)
from .sanitizer import Sanitizer, SanitizerError

__all__ = [
    "CODES", "Diagnostic", "DiagnosticsLog", "Sanitizer", "SanitizerError",
    "Severity", "UnknownDiagnosticCode", "contradiction", "diagnostics",
    "explain", "invalid_field", "invalid_mode", "sanitizer",
    "use_after_donate",
]
