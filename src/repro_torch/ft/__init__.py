"""Fault tolerance: the step watchdog, speculative backup offload and
elastic restore (twin of ``repro.ft``).

The deterministic fault-injection substrate and the session-level
escalation ladder live in :mod:`repro_torch.core.faults` (re-exported from
``repro_torch.api``); this package carries their wall-clock companions —
the step watchdog, speculative backup offload, and elastic restore.
"""

from repro_torch.ft.elastic import elastic_restore
from repro_torch.ft.straggler import (
    BackupOffload, StepWatchdog, WatchdogConfig,
)

__all__ = ["BackupOffload", "StepWatchdog", "WatchdogConfig",
           "elastic_restore"]
