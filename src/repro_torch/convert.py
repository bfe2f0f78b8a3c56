"""Carrying state across from the reference package.

This system has no trained weights: what ``repro`` and ``repro_torch``
share is the job instances and the machine constants.  Both helpers take
plain data (numpy arrays, dicts), so nothing here imports the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import broadcast as bc
from repro_torch.core.jobs import PaperJob
from repro_torch.core.params import OccamyParams


def operands_to_clusters(ops: Mapping[str, np.ndarray], job: PaperJob,
                         cluster_ids: Sequence[int],
                         device: Any, *, lead: int = 0
                         ) -> Dict[str, torch.Tensor]:
    """``repro``'s numpy operand dict as the port's cluster-major tensors.

    Each operand is split along ``job.shard_axes[name]`` (shifted right by
    ``lead`` leading batch axes, 1 for a fused stack) into one contiguous
    block per cluster, or replicated when the job does not shard it —
    exactly the placement a ``DispatchPlan`` on ``cluster_ids`` stages.
    """
    n = len(cluster_ids)
    out = {}
    for name in sorted(ops):
        axis = job.shard_axes[name]
        placement = bc.Placement(n, None if axis is None else axis + lead)
        out[name] = bc.upload(placement.to_clusters(np.asarray(ops[name])),
                              torch.device(device))
    return out


def occamy_params_from_dict(d: Mapping[str, Any]) -> OccamyParams:
    """The port's :class:`OccamyParams` from ``dataclasses.asdict`` of the
    reference's.  Unknown or missing fields raise: the two must agree."""
    names = {f.name for f in dataclasses.fields(OccamyParams)}
    if set(d) != names:
        raise ValueError(
            f"OccamyParams fields differ: unknown {sorted(set(d) - names)}, "
            f"missing {sorted(names - set(d))}")
    return OccamyParams(**dict(d))
