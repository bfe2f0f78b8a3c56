"""Production mesh builders — twin of ``repro.launch.mesh``.

The meshes are :class:`~repro_torch.dist.LogicalMesh` es: axis names and
sizes, no devices.  One card holds every array of the port, so a mesh is
what the sharding rules (``dist.param_specs``, ``batch_specs``,
``cache_specs``) read and what the dry-run divides its counts by; building
one touches no device, so the dry-run needs none of the reference's 512
placeholder devices.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.dist.sharding import LogicalMesh


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The target deployment mesh: one pod of 16 x 16 = 256 ways over
    ``("data", "model")``, or two pods (2 x 16 x 16 = 512) with a leading
    ``pod`` axis that composes into data parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(axes, shape)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[torch.device]] = None
              ) -> LogicalMesh:
    """A mesh of any shape (tests, the train CLI, elastic restore).  With
    ``devices`` (one per way), raises as the reference does when there
    are fewer than the mesh has ways."""
    n = math.prod(shape)
    if devices is not None and len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return LogicalMesh(tuple(axes), tuple(int(s) for s in shape))
