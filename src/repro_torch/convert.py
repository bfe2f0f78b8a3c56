"""Carrying state across from the reference package.

This system has no trained weights: what ``repro`` and ``repro_torch``
share is the job instances, the machine constants, the models' random
weights and a training run's state (parameters, AdamW moments,
checkpoints).  Every helper takes plain data (numpy arrays, dicts), so
nothing here imports the reference.  A model's parameters cross in the
reference's layout, every layer leaf stacked over a leading L axis, both
ways: the parity tests load the reference's weights into the port, and
``checkpoint.store`` writes the port's in that layout, so either package
reads the other's checkpoints.
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
            ) -> Dict[Tuple[str, ...], Any]:
    """The leaves of nested mappings by path; tensors stay tensors, anything
    else becomes a numpy array."""
    out: Dict[Tuple[str, ...], Any] = {}
    for key, node in tree.items():
        path = prefix + (str(key),)
        if isinstance(node, Mapping):
            out.update(_leaves(node, path))
        else:
            out[path] = (node if isinstance(node, torch.Tensor)
                         else np.asarray(node))
    return out


def _nest(flat: Mapping[Tuple[str, ...], Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return tree


def require_stacked(cfg: ModelConfig) -> None:
    """Raise for a model whose layers differ (``MoEConfig.first_dense``
    dense layers before the MoE ones): the reference's tree stacks
    identical layers over one L axis, so it has no layout for them."""
    if cfg.moe is not None and cfg.moe.first_dense:
        raise ValueError(
            f"{cfg.name}: MoEConfig.first_dense={cfg.moe.first_dense} mixes "
            "dense and MoE layers, which the stacked layer tree cannot hold")


def _port_params(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    from repro_torch.models.model import Transformer   # avoid cycle
    require_stacked(cfg)
    return Transformer(cfg, device="meta").state_dict()


def _reference_leaves(cfg: ModelConfig
                      ) -> Dict[Tuple[str, ...], Tuple[Tuple[int, ...],
                                                       torch.dtype]]:
    """The reference's tree as path -> (shape, dtype): every per-layer leaf
    of the port (``layers.<i>.attn.wq``) stacked over L (``layers/attn/wq``
    of (L, ...)), every other leaf as it is."""
    out = {}
    for name, t in _port_params(cfg).items():
        parts = tuple(name.split("."))
        if parts[0] == "layers":
            if parts[1] == "0":
                out[("layers",) + parts[2:]] = (
                    (cfg.n_layers,) + tuple(t.shape), t.dtype)
        else:
            out[parts] = (tuple(t.shape), t.dtype)
    return out


def reference_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's ``init_params`` tree for ``cfg`` as ``meta`` tensors
    (shapes and dtypes, nothing allocated; ``jax.eval_shape``'s result):
    the tree ``dist.param_specs`` and ``ft.elastic_restore`` read."""
    return _nest({path: torch.empty(shape, dtype=dt, device="meta")
                  for path, (shape, dt) in _reference_leaves(cfg).items()})


def _unstack(tree: Mapping[str, Any], cfg: ModelConfig, cast: bool
             ) -> Dict[str, torch.Tensor]:
    """The reference's stacked tree (numpy arrays or tensors) by the port's
    parameter names, checked leaf by leaf; with ``cast``, in the port's
    parameter dtypes."""
    want = _port_params(cfg)
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, arr) -> None:
        if name not in want:
            raise ValueError(f"unknown parameter {name!r} for {cfg.name}")
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, the port's "
                             f"is {tuple(want[name].shape)}")
        t = (arr if isinstance(arr, torch.Tensor)
             else torch.from_numpy(np.array(arr, order="C")))
        out[name] = t.to(want[name].dtype) if cast else t

    for path, arr in _leaves(tree).items():
        if path[0] == "layers":
            if arr.ndim < 1 or arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{'/'.join(path)}: shape "
                                 f"{tuple(arr.shape)} is not stacked over "
                                 f"{cfg.n_layers} layers")
            for i in range(cfg.n_layers):
                put(".".join(("layers", str(i)) + path[1:]), arr[i])
        else:
            put(".".join(path), arr)
    missing = sorted(set(want) - set(out))
    if missing:
        raise ValueError(f"missing parameters for {cfg.name}: {missing}")
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
    ``model.load_state_dict(sd, assign=True)``.  Leaves may also be
    tensors (a checkpoint restored onto a device): the result's tensors
    are then views of theirs, on their device, for ``load_state_dict`` to
    copy into a model.
    """
    return _unstack(tree, cfg, cast=True)


def model_params_to_numpy(params, cfg: ModelConfig) -> Dict[str, Any]:
    """The inverse of :func:`model_params_from_numpy`: a model's parameters
    (an ``nn.Module`` or a mapping of the port's names to tensors, such as
    AdamW's ``mu``) as the reference's stacked tree of numpy arrays.
    Unknown or missing names, and tensors of another shape, raise."""
    named = (dict(params.named_parameters())
             if isinstance(params, torch.nn.Module) else dict(params))
    want = _port_params(cfg)
    unknown = sorted(set(named) - set(want))
    missing = sorted(set(want) - set(named))
    if unknown or missing:
        raise ValueError(f"{cfg.name}: unknown parameters {unknown}, "
                         f"missing {missing}")
    for name, t in named.items():
        if tuple(t.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the port's "
                             f"is {tuple(want[name].shape)}")

    def host(t: torch.Tensor) -> np.ndarray:
        # a copy: on the CPU ``.cpu().numpy()`` would alias the live tensor
        return t.detach().to("cpu", copy=True).numpy()

    flat = {}
    for path in _reference_leaves(cfg):
        if path[0] == "layers":
            rest = ".".join(path[1:])
            flat[path] = host(torch.stack(
                [named[f"layers.{i}.{rest}"] for i in range(cfg.n_layers)]))
        else:
            flat[path] = host(named[".".join(path)])
    return _nest(flat)


def adamw_state_to_numpy(state: Mapping[str, Any], cfg: ModelConfig
                         ) -> Dict[str, Any]:
    """The port's AdamW state (``optim.adamw_init``'s) as the reference's
    ``{"mu", "nu", "count"}`` tree of numpy arrays: the moments stacked as
    :func:`model_params_to_numpy` stacks the parameters, ``count`` a 0-d
    int32 array."""
    return {"mu": model_params_to_numpy(state["mu"], cfg),
            "nu": model_params_to_numpy(state["nu"], cfg),
            "count": state["count"].detach().to("cpu", copy=True).numpy()}


def adamw_state_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig
                           ) -> Dict[str, Any]:
    """The reference's AdamW state (numpy arrays, or tensors restored onto
    a device) as the port's, the moments in their own dtype, on the
    leaves' device; errors as :func:`model_params_from_numpy`'s."""
    count = tree["count"]
    count = (count if isinstance(count, torch.Tensor)
             else torch.from_numpy(np.array(count)))
    if count.ndim != 0:
        raise ValueError(f"count must be a scalar, got {tuple(count.shape)}")
    return {"mu": _unstack(tree["mu"], cfg, cast=False),
            "nu": _unstack(tree["nu"], cfg, cast=False),
            "count": count.to(torch.int32)}
