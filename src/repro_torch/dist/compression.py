"""Gradient compression for data-parallel reductions — twin of
``repro.dist.compression``.

Int8 linear quantization with a per-call scale, an error-feedback residual
(what quantization drops this step is carried and added back next step),
and the two reductions built on them.  The quantizer is the reference's,
operation for operation in float32 (``torch.round`` and ``jnp.round``
both round half to even; the scale has the same 1e-12 floor and the codes
the same clip at ±127), so both packages give the same codes and scales
bit for bit.

The reference reduces over a mesh axis inside ``shard_map``; one card has
no such axis, so here the data shards are explicit: a tensor's leading
axis, or a list (a shard per data-parallel rank, each quantized with its
own scale as each rank's local gradient is):

* ``compressed_psum``     — the sum over the shards of each shard's
  dequantized int8 codes (the wire carries int8 payloads + one fp32 scale
  a shard).
* ``dp_grads_compressed`` — each shard's ``loss_fn`` value and gradient,
  the gradients reduced through ``compressed_psum`` and divided by the
  number of shards, the losses averaged.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from repro_torch.dist.sharding import tree_map

Pytree = Any
_F32 = torch.float32


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes, fp32 scale); round-to-nearest, |err| <= scale/2."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(_F32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(_F32) * scale


def init_residual(tree: Pytree) -> Pytree:
    """Zero error-feedback residual matching a gradient tree (a tensor or
    nested mappings of tensors)."""
    return tree_map(lambda x: torch.zeros_like(x, dtype=_F32), tree)


def error_feedback_compress(grads: Pytree, residual: Pytree
                            ) -> Tuple[Pytree, Pytree]:
    """-> (dequantized compressed grads, updated residual).

    Compresses ``grads + residual``; the new residual is exactly the
    quantization error, so successive compressed steps sum to the true sum
    up to one quantization step."""
    def one(g, r):
        y = g.to(_F32) + r
        q, scale = quantize_int8(y)
        dq = dequantize_int8(q, scale)
        return dq, y - dq

    if isinstance(grads, torch.Tensor):
        return one(grads, residual)
    pairs = {k: error_feedback_compress(g, residual[k])
             for k, g in grads.items()}
    return ({k: p[0] for k, p in pairs.items()},
            {k: p[1] for k, p in pairs.items()})


def compressed_psum(shards) -> torch.Tensor:
    """Sum of the shards' locally int8-quantized values: ``shards`` is a
    tensor whose leading axis is the data axis, or a sequence of equally
    shaped tensors (one a shard)."""
    out = None
    for x in shards:
        q, scale = quantize_int8(x)
        dq = dequantize_int8(q, scale)
        out = dq if out is None else out + dq
    if out is None:
        raise ValueError("compressed_psum needs at least one shard")
    return out


def dp_grads_compressed(loss_fn: Callable[..., torch.Tensor]
                        ) -> Callable[..., Tuple[torch.Tensor, Pytree]]:
    """Data-parallel grads with a compressed reduction.

    ``loss_fn(w, batch)`` is evaluated on each shard's batch; the returned
    ``gfn(w, shards)`` (``w`` a tensor or a mapping of names to tensors,
    ``shards`` a sequence of per-shard batches) reduces the gradients
    through ``compressed_psum`` and averages them, and averages the loss."""
    def gfn(w: Pytree, shards: Sequence[Dict[str, torch.Tensor]]):
        single = isinstance(w, torch.Tensor)
        leaves = {"": w} if single else dict(w)
        names = list(leaves)
        losses, grads = [], {n: [] for n in names}
        for batch in shards:
            with torch.enable_grad():
                wg = {n: t.detach().requires_grad_(True)
                      for n, t in leaves.items()}
                loss = loss_fn(wg[""] if single else wg, batch)
                g = torch.autograd.grad(loss, [wg[n] for n in names])
            losses.append(loss.detach())
            for n, t in zip(names, g):
                grads[n].append(t)
        n_shards = len(losses)
        out = {n: compressed_psum(grads[n]) / n_shards for n in names}
        loss = torch.mean(torch.stack(losses))
        return loss, out[""] if single else out

    return gfn
