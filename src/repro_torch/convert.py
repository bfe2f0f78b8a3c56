"""Carrying state across from the reference package.

This system has no trained weights: what ``repro`` and ``repro_torch``
share is the job instances, the machine constants and the models' random
weights.  Every helper takes plain data (numpy arrays, dicts), so nothing
here imports the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import broadcast as bc
from repro_torch.core.jobs import PaperJob
from repro_torch.core.params import OccamyParams
from repro_torch.models.config import ModelConfig


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


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Dict[Tuple[str, ...], np.ndarray]:
    out: Dict[Tuple[str, ...], np.ndarray] = {}
    for key, node in tree.items():
        path = prefix + (str(key),)
        if isinstance(node, Mapping):
            out.update(_leaves(node, path))
        else:
            out[path] = np.asarray(node)
    return out


def model_params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig
                            ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` from the reference's ``init_params`` tree
    as numpy arrays (``jax.device_get``), so both packages compute with the
    same weights.

    The reference stacks every layer leaf over a leading L axis
    (``layers/attn/wq`` is (L, d, q)); the port has one module per layer
    (``layers.<i>.attn.wq``).  Unknown or missing leaves, and leaves of
    another shape, raise.  Load the result with
    ``model.load_state_dict(sd, assign=True)``.
    """
    from repro_torch.models.model import Transformer   # avoid cycle
    want = Transformer(cfg, device="meta").state_dict()
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, arr: np.ndarray) -> None:
        if name not in want:
            raise ValueError(f"unknown parameter {name!r} for {cfg.name}")
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: shape {arr.shape}, the port's is "
                             f"{tuple(want[name].shape)}")
        out[name] = torch.from_numpy(np.array(arr, order="C")).to(
            want[name].dtype)

    for path, arr in _leaves(tree).items():
        if path[0] == "layers":
            if arr.ndim < 1 or arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape} is "
                                 f"not stacked over {cfg.n_layers} layers")
            for i in range(cfg.n_layers):
                put(".".join(("layers", str(i)) + path[1:]), arr[i])
        else:
            put(".".join(path), arr)
    missing = sorted(set(want) - set(out))
    if missing:
        raise ValueError(f"missing parameters for {cfg.name}: {missing}")
    return out
