"""Offload phase taxonomy — paper §3.2 / §4.1, figure 3.

Every offloaded job decomposes into nine phases.  Phases C and D only exist in
the *baseline* implementation (the multicast extension eliminates them), and
phase H has two implementations (software central-counter barrier vs the job
completion unit).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List


class Phase(enum.Enum):
    A = "send_job_information"
    B = "wakeup"
    C = "retrieve_job_pointer"
    D = "retrieve_job_arguments"
    E = "retrieve_job_operands"
    F = "job_execution"
    G = "writeback_job_outputs"
    H = "notify_job_completion"
    I = "resume_operation_on_host"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.name} ({self.value})"


#: Phases belonging to each fundamental offload task (paper fig. 3 brackets).
FUNDAMENTAL_TASKS: Dict[str, List[Phase]] = {
    "communicate_job_information": [Phase.A, Phase.C, Phase.D],
    "wakeup": [Phase.B],
    "communicate_job_operands": [Phase.E],
    "job_execution": [Phase.F],
    "communicate_job_results": [Phase.G],
    "notify_job_completion": [Phase.H, Phase.I],
}

#: Phases whose runtime is (nearly) independent of the offloaded job (§5.6).
JOB_INDEPENDENT_PHASES = (Phase.A, Phase.B, Phase.C, Phase.D, Phase.H, Phase.I)


@dataclasses.dataclass
class PhaseSpan:
    """One cluster's (or the host's) occupancy of a phase, in cycles."""

    phase: Phase
    cluster: int  # -1 for host-side phases (A, I)
    start: float
    end: float

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class PhaseStats:
    """Aggregate of a phase across clusters — fig. 11's min/avg/max bands."""

    phase: Phase
    min: float
    avg: float
    max: float

    @staticmethod
    def of(phase: Phase, durations: List[float]) -> "PhaseStats":
        if not durations:
            return PhaseStats(phase, 0.0, 0.0, 0.0)
        return PhaseStats(
            phase,
            min(durations),
            sum(durations) / len(durations),
            max(durations),
        )
