"""Elastic rescale: resume a run on another data-parallel width — twin of
``repro.ft.elastic``.

The checkpoint stores logical specs, and the data pipeline is a pure
function of (seed, index), so rescaling is:

  1. build a new logical data mesh over the surviving ranks,
  2. re-derive the specs for that mesh (divisibility fallbacks re-apply),
  3. restore the checkpoint with those specs,
  4. continue from the recorded step/data index.

The reference's mesh holds devices; one card holds every array of the
port, so its mesh is logical (:class:`~repro_torch.dist.LogicalMesh`, one
``data`` axis as wide as the ranks given) and the state lands on
``device``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.checkpoint import store
from repro_torch.dist.sharding import LogicalMesh, param_specs

Pytree = Any


def make_data_mesh(devices: Optional[Sequence[Any]] = None) -> LogicalMesh:
    """A logical ``("data",)`` mesh with one way per entry of ``devices``
    (the data-parallel ranks: any sequence); one way when None (the one
    card)."""
    n = 1 if devices is None else len(devices)
    return LogicalMesh(("data",), (n,))


def elastic_restore(
    directory: str,
    devices: Sequence[Any],
    param_shapes: Pytree,
    step: Optional[int] = None,
    *,
    device=None,
) -> Tuple[int, int, Dict[str, Pytree], LogicalMesh]:
    """-> (step, data_index, state on ``device``, the new mesh).

    ``param_shapes`` is the reference's stacked tree (anything with
    ``.shape``: ``convert.reference_shapes(cfg)``, or the numpy tree a
    checkpoint was written from); ``device`` None means the card."""
    mesh = make_data_mesh(devices)
    pspecs = param_specs(param_shapes, mesh)
    specs = {"params": pspecs,
             "opt": {"mu": pspecs, "nu": pspecs, "count": ()}}
    step, data_index, state = store.restore(directory, mesh, specs, step,
                                            device=device)
    return step, data_index, state, mesh
