"""Op-level cost of one eager run — twin of ``repro.launch.hlo_cost``.

The reference walks XLA's partitioned HLO text, applying loop trip counts
because XLA's own ``cost_analysis()`` counts a ``while`` body once.  Eager
PyTorch has no such program: every loop iteration dispatches its ops, so
the trip count is implicit.  :func:`count_cost` runs a function once
under a ``TorchDispatchMode`` (on ``meta`` tensors it allocates nothing)
and costs every aten op it sees — the backward's and remat's recomputed
ops too, since autograd dispatches them through the same mode — with the
reference's rules moved to aten ops:

  * products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot`` …):
    2 × numel(result) × the contracted extent;
  * elementwise ops (aten's ``pointwise`` tag): 1 FLOP an output element;
    transcendentals (``exp``, ``log``, ``tanh``, ``rsqrt``, ``sqrt``,
    ``sigmoid``, ``sin``, ``cos``, ``erf``, ``silu`` …) also count into
    ``transcendentals``; softmax and log-softmax as their XLA lowering
    (subtract, exp, divide: 3 FLOPs and 1 transcendental an element);
    reductions and data movement cost bytes only, as the reference's
    ``reduce`` and movement ops do;
  * bytes: each op that is not a view counts its inputs plus its outputs
    (an input broadcast by stride 0 counts its stored elements).  In eager
    PyTorch every op is a kernel boundary: the twin of the reference's
    "traffic at the fusion boundary";
  * views (``view``, ``expand``, ``t``, ``transpose``, ``slice``,
    ``as_strided``, a ``reshape`` that views, ``_unsafe_view`` …) and
    allocations (``empty``) cost nothing;
  * windowed writes (``index_put_``, ``index_copy_``, ``index_add_``,
    ``scatter_``, ``slice_scatter`` …) count 2 × the window plus the
    indices, not the buffer, and windowed reads (``gather``, ``index``,
    ``index_select``, ``embedding``) 2 × the result plus the indices: the
    twin of the reference's ``_WINDOWED``; a ``copy_`` into a view counts
    the view, since its destination is the window.

The mode also tracks the peak of live output bytes: each storage an op
allocates counts from its first output until the last tensor the mode saw
on it dies (a weak reference a tensor), for the dry-run's temporary
memory.  Eager PyTorch has no collectives on one card, so
``collective_bytes`` and ``collective_counts`` stay zero here; the
dry-run models them from the logical specs.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_aten = torch.ops.aten

#: products: op -> the index of the left operand (its last axis is the
#: contracted one)
_PRODUCTS = {
    _aten.mm: 0, _aten.bmm: 0, _aten.addmm: 1, _aten.baddbmm: 1,
    _aten.mv: 0, _aten.addmv: 1, _aten.dot: 0, _aten.vdot: 0,
    _aten._addmm_activation: 1,
}
#: transcendental elementwise ops, by name (an in-place ``_`` stripped)
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
    "rsqrt", "sqrt", "sigmoid", "logit", "sin", "cos", "tan", "asin",
    "acos", "atan", "atan2", "sinh", "cosh", "erf", "erfc", "erfinv",
    "silu", "silu_backward", "gelu", "gelu_backward", "softplus",
    "softplus_backward", "mish", "logaddexp",
}
#: softmax-like ops: (FLOPs, transcendentals) an output element
_SOFTMAX = {
    _aten._softmax: (3, 1), _aten._log_softmax: (3, 1),
    _aten._softmax_backward_data: (3, 0),
    _aten._log_softmax_backward_data: (3, 1),
}
#: windowed writes: op -> (index of the update, indices of the index args)
_WINDOWED_WRITES = {
    _aten.index_put_: (2, (1,)), _aten.index_put: (2, (1,)),
    _aten._index_put_impl_: (2, (1,)),
    _aten.index_copy_: (3, (2,)), _aten.index_copy: (3, (2,)),
    _aten.index_add_: (3, (2,)), _aten.index_add: (3, (2,)),
    _aten.scatter_: (3, (2,)), _aten.scatter: (3, (2,)),
    _aten.scatter_add_: (3, (2,)), _aten.scatter_add: (3, (2,)),
    _aten.scatter_reduce_: (3, (2,)), _aten.scatter_reduce: (3, (2,)),
    _aten.slice_scatter: (1, ()), _aten.select_scatter: (1, ()),
}
#: windowed reads: op -> indices of the index args
_WINDOWED_READS = {
    _aten.gather: (2,), _aten.index: (1,), _aten.index_select: (2,),
    _aten.embedding: (1,),
}
#: bookkeeping that moves nothing
_FREE = {
    _aten._unsafe_view, _aten.empty, _aten.empty_like, _aten.empty_strided,
    _aten.lift_fresh, _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
    _aten.sym_storage_offset, _aten.is_same_size, _aten.set_,
    _aten.resize_, _aten._local_scalar_dense,
}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: Optional[Dict[str, float]] = None
    #: the largest contributors: (aten op, "N calls", bytes)
    top_traffic: Optional[List[Tuple[str, str, float]]] = None
    #: peak of live op-allocated bytes over the run
    peak_bytes: float = 0.0

    def __post_init__(self):
        if self.collective_counts is None:
            self.collective_counts = {k: 0.0 for k in COLLECTIVE_KINDS}
        if self.top_traffic is None:
            self.top_traffic = []

    def per_device(self, chips: int) -> "Cost":
        """The ideal partition over ``chips``: every count ÷ chips."""
        return Cost(
            self.flops / chips, self.bytes / chips,
            self.transcendentals / chips, self.collective_bytes / chips,
            dict(self.collective_counts),
            [(k, n, b / chips) for k, n, b in self.top_traffic],
            self.peak_bytes / chips)


def _stored_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` reads: a stride-0 (broadcast) axis
    counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of an op's arguments or outputs (tensors, sequences
    and mappings of them, other values)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


def _kind(func) -> Tuple[str, Any]:
    """How ``func`` is costed: (rule, what the rule needs)."""
    packet = func.overloadpacket
    if packet in _FREE or func.is_view:
        return "free", None
    if packet in _PRODUCTS:
        return "product", _PRODUCTS[packet]
    if packet in _SOFTMAX:
        return "softmax", _SOFTMAX[packet]
    if packet in _WINDOWED_WRITES:
        return "window_write", _WINDOWED_WRITES[packet]
    if packet in _WINDOWED_READS:
        return "window_read", _WINDOWED_READS[packet]
    if torch.Tag.pointwise in func.tags:
        name = packet.__name__.rstrip("_")
        return "pointwise", name in _TRANSCENDENTAL
    return "movement", None


def _key(x):
    """A hashable stand-in for an argument: a tensor by its metadata (what
    a functional op's output metadata depends on), a sequence by its
    items; raises ``TypeError`` for an unhashable value."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device)
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    hash(x)
    return x


def _describe(out):
    """The output's structure and tensors' metadata, to rebuild it."""
    if isinstance(out, torch.Tensor):
        return ("T", tuple(out.shape), out.stride(), out.dtype, out.device)
    if isinstance(out, (list, tuple)):
        return (type(out), [_describe(v) for v in out])
    return ("V", out)


def _rebuild(desc):
    if desc[0] == "T":
        return torch.empty_strided(desc[1], desc[2], dtype=desc[3],
                                   device=desc[4])
    if desc[0] == "V":
        return desc[1]
    return desc[0](_rebuild(v) for v in desc[1])


def _fresh_outputs(func) -> bool:
    """Whether ``func``'s outputs are new storage (no return aliases an
    argument: not a view, not in-place, not ``out=``)."""
    return not func.is_view and all(r.alias_info is None
                                    for r in func._schema.returns)


class OpCounter(TorchDispatchMode):
    """Costs every aten op dispatched under it (see the module docstring);
    the totals are :meth:`cost`."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        #: the products' share of ``flops`` (``FlopCounterMode``'s count)
        self.product_flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.traffic: Dict[str, List[float]] = {}
        self._kinds: Dict[Any, Tuple[Tuple[str, Any], bool]] = {}
        self._outputs: Dict[Any, Any] = {}
        self._live = 0
        self.peak = 0
        self._holders: Dict[int, int] = {}
        self._sizes: Dict[int, int] = {}

    # -- peak of live bytes ----------------------------------------------------
    def _drop(self, key: int) -> None:
        self._holders[key] -= 1
        if not self._holders[key]:
            del self._holders[key]
            self._live -= self._sizes.pop(key)

    def _track(self, out: List[torch.Tensor], fresh: bool) -> None:
        for t in out:
            key = t.untyped_storage()._cdata
            if key not in self._holders:
                if not fresh:
                    continue        # a view or in-place result of an input
                self._holders[key] = 0
                self._sizes[key] = t.untyped_storage().nbytes()
                self._live += self._sizes[key]
                self.peak = max(self.peak, self._live)
            self._holders[key] += 1
            weakref.finalize(t, self._drop, key)

    # -- costing -------------------------------------------------------------------
    def _run(self, func, args, kwargs, fresh: bool):
        """``func(*args, **kwargs)``; on ``meta`` tensors a functional
        op's output is rebuilt from the first call with the same argument
        metadata (a ``meta`` kernel is Python and costs ~0.1 ms a call; a
        long sequential scan calls thousands).  Views and in-place ops
        always run: their outputs alias their inputs."""
        if not fresh:
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(tuple(sorted(kwargs.items()))))
        except TypeError:
            return func(*args, **kwargs)
        desc = self._outputs.get(key)
        if desc is not None:
            return _rebuild(desc)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if outs and all(t.device.type == "meta" for t in outs):
            self._outputs[key] = _describe(out)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = (_kind(func), _fresh_outputs(func))
        (rule, arg), fresh = kind
        fresh = fresh and rule != "free"
        out = self._run(func, args, kwargs, fresh)
        outs = _tensors(out)
        self._track(outs, fresh)
        if rule == "free":
            return out
        flops = trans = 0.0
        if rule == "window_write":
            upd, idx = arg
            src = args[upd] if len(args) > upd else None
            if isinstance(src, torch.Tensor):
                window = _nbytes(src)
            else:                   # a scalar value: the indexed elements
                index = args[idx[0]]
                window = index.numel() * args[0].element_size()
            nbytes = 2 * window + sum(
                _nbytes(t) for i in idx for t in _tensors(args[i]))
        elif rule == "window_read":
            nbytes = 2 * sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for i in arg for t in _tensors(args[i]))
        else:
            nbytes = (sum(_stored_bytes(t)
                          for t in _tensors((args, kwargs)))
                      + sum(_nbytes(t) for t in outs))
            n = sum(t.numel() for t in outs)
            if rule == "product":
                flops = 2.0 * n * args[arg].shape[-1]
                self.product_flops += flops
            elif rule == "softmax":
                flops, trans = arg[0] * n, arg[1] * n
            elif rule == "pointwise":
                flops = float(n)
                trans = float(n) if arg else 0.0
        self.flops += flops
        self.transcendentals += trans
        self.bytes += nbytes
        row = self.traffic.setdefault(func.overloadpacket.__name__, [0, 0.0])
        row[0] += 1
        row[1] += nbytes
        return out

    def cost(self) -> Cost:
        top = sorted(((name, f"{calls} calls", b)
                      for name, (calls, b) in self.traffic.items()),
                     key=lambda t: -t[2])[:12]
        return Cost(flops=self.flops, bytes=self.bytes,
                    transcendentals=self.transcendentals, top_traffic=top,
                    peak_bytes=float(self.peak))


def count_cost(fn: Callable, *args, **kwargs) -> Cost:
    """The :class:`Cost` of ``fn(*args, **kwargs)`` run once (its result is
    dropped).  On ``meta`` tensors nothing is allocated or computed."""
    counter = OpCounter()
    with counter:
        fn(*args, **kwargs)
    return counter.cost()
