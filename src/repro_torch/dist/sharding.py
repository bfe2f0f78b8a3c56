"""Sharding rules over a logical mesh — twin of ``repro.dist.sharding``.

One card holds every array of the port, so nothing is laid out across
devices; what carries over is the *logical* layout: the specs the
reference derives, which its checkpoints record and its elastic restore
re-derives.  :class:`LogicalMesh` stands in for ``jax.sharding.Mesh``
(axis names and sizes, no devices) and a spec is a tuple standing in for
a ``PartitionSpec``: ``()`` replicates, ``(None, "model")`` shards axis 1
over ``model``, ``("data",)`` shards axis 0 over ``data`` and ``(("pod",
"data"),)`` over both (a single axis stands bare, as ``PartitionSpec``
records it).

* ``param_specs`` — tensor parallelism: shard the widest divisible
  trailing axis (down to axis 1) of every >= 2-D parameter over the
  ``model`` axis; 1-D scales and biases replicate.  The rule reads the
  reference's *stacked* tree (``layers/ln1`` is (L, d) and gets ``(None,
  "model")``; the port's per-layer (d,) would replicate), so pass it
  ``convert.reference_shapes(cfg)``.
* ``batch_specs`` — data parallelism: the leading batch axis over the data
  axes (``pod`` composes into ``data``).
* ``cache_specs`` — caches laid out (L, B, ...): axis 1 over the data axes.

Every rule is divisibility-guarded as the reference's: an axis that does not
divide over its mesh axes replicates.  The reference's ``to_shardings``
(specs to ``NamedSharding``s on devices) has no counterpart: one card holds
all, and :func:`check_spec` is what a placement checks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

Pytree = Any
Spec = Tuple[Any, ...]

#: mesh axes that compose into data parallelism, outermost first
DP_AXES: Tuple[str, ...] = ("pod", "data")
#: the tensor-parallel mesh axis
TP_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Named mesh axes and their sizes (``jax.sharding.Mesh`` without
    devices): ``LogicalMesh(("data", "model"), (4, 2))``."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if (len(self.axis_names) != len(self.axis_sizes)
                or len(set(self.axis_names)) != len(self.axis_names)
                or any(n < 1 for n in self.axis_sizes)):
            raise ValueError(f"bad mesh {self.axis_names} {self.axis_sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def tree_map(fn: Callable, tree: Pytree) -> Pytree:
    """``fn`` on every leaf of a tree of nested mappings."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def dp_axes(mesh: LogicalMesh) -> Tuple[str, ...]:
    """The data-parallel axis names present on this mesh, outermost first."""
    return tuple(a for a in DP_AXES if a in mesh.axis_names)


def _dp_entry(mesh: LogicalMesh):
    """The data axes as one spec entry: a single axis bare, several as a
    tuple (``PartitionSpec``'s normal form)."""
    dp = dp_axes(mesh)
    return dp[0] if len(dp) == 1 else dp


def _dp_size(mesh: LogicalMesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def _shape(leaf: Any) -> Tuple[int, ...]:
    return tuple(leaf.shape)


def param_specs(params: Pytree, mesh: LogicalMesh) -> Pytree:
    """Spec per parameter of the reference's stacked tree: widest divisible
    trailing axis -> model.  A tree whose layers hold both a gated MLP and
    an MoE block (``MoEConfig.first_dense``) is not a stack of identical
    layers and raises."""
    layers = params.get("layers") if isinstance(params, Mapping) else None
    if isinstance(layers, Mapping) and "mlp" in layers and "moe" in layers:
        raise ValueError("layers hold both 'mlp' and 'moe' "
                         "(MoEConfig.first_dense): not a stacked layer tree")
    tp = mesh.shape.get(TP_AXIS, 1)

    def rule(leaf) -> Spec:
        shape = _shape(leaf)
        if tp <= 1 or len(shape) < 2:
            return ()
        # trailing axes first: (L, d_in, d_out) prefers the output dim
        for ax in range(len(shape) - 1, 0, -1):
            if shape[ax] % tp == 0 and shape[ax] >= tp:
                return tuple([None] * ax + [TP_AXIS])
        return ()

    return tree_map(rule, params)


def batch_specs(shapes: Pytree, mesh: LogicalMesh) -> Pytree:
    """Spec per model input: leading batch axis -> data axes."""
    dp = dp_axes(mesh)
    dpn = _dp_size(mesh)

    def rule(leaf) -> Spec:
        shape = _shape(leaf)
        if not dp or dpn <= 1 or not shape or shape[0] % dpn:
            return ()
        return (_dp_entry(mesh),)

    return tree_map(rule, shapes)


def cache_specs(cache_shapes: Pytree, mesh: LogicalMesh) -> Pytree:
    """Spec per cache entry: (L, B, ...) batch axis -> data axes."""
    dp = dp_axes(mesh)
    dpn = _dp_size(mesh)

    def rule(leaf) -> Spec:
        shape = _shape(leaf)
        if not dp or dpn <= 1 or len(shape) < 2 or shape[1] % dpn:
            return ()
        return (None, _dp_entry(mesh))

    return tree_map(rule, cache_shapes)


def check_spec(spec: Spec, shape: Tuple[int, ...], mesh: LogicalMesh,
               name: Optional[str] = None) -> None:
    """Raise unless ``spec`` lays an array of ``shape`` out on ``mesh``: no
    more entries than axes, every named mesh axis present, each sharded
    axis divisible by the product of its mesh axes (what placing it as a
    ``NamedSharding`` needs)."""
    where = f"{name}: " if name else ""
    if len(spec) > len(shape):
        raise ValueError(f"{where}spec {spec} has more entries than shape "
                         f"{tuple(shape)}")
    for dim, entry in zip(shape, spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        missing = [a for a in names if a not in mesh.shape]
        if missing:
            raise ValueError(f"{where}mesh {mesh.axis_names} has no axis "
                             f"{missing}")
        ways = math.prod(mesh.shape[a] for a in names)
        if dim % ways:
            raise ValueError(f"{where}axis of {dim} does not divide over "
                             f"{tuple(names)} ({ways} ways)")
