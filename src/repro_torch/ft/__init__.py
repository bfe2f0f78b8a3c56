"""Fault tolerance: the step watchdog and speculative backup offload (twin
of ``repro.ft``).

The deterministic fault-injection substrate and the session-level
escalation ladder live in :mod:`repro_torch.core.faults` (re-exported from
``repro_torch.api``); this package carries their wall-clock companions.
The reference's third name, ``elastic_restore``, restores a checkpoint
onto a new mesh and comes with the training substrate.
"""

from repro_torch.ft.straggler import (
    BackupOffload, StepWatchdog, WatchdogConfig,
)

__all__ = ["BackupOffload", "StepWatchdog", "WatchdogConfig"]
