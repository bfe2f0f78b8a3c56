"""Train-step builder: grads (+ microbatch accumulation) + AdamW — twin of
``repro.train.step``.

``build_train_step`` returns the step and the parameter, optimizer and
batch specs the reference's builder derives over its mesh, here over a
:class:`~repro_torch.dist.LogicalMesh`; one card holds every array, so the
specs lay nothing out and are what a checkpoint's manifest records.  The
step updates the model and the AdamW state in place (the reference
donates both buffers to its jitted step); the first step turns gradients
on for the model it trains (``init_params`` makes them off, for serving).

The kernels have no backward (``kernels.build.refuse_grad``), so the
default call is the reference's own, ``CallConfig()`` with attention
``"xla"``: here ``TRAIN_CALL``, the plain attention and the plain scan.
A kernel asked for under autograd raises rather than dropping a gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch import convert
from repro_torch.core import trace
from repro_torch.core.offload import resolve_device
from repro_torch.dist.sharding import (
    LogicalMesh, batch_specs, param_specs,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import CallConfig, Transformer, loss_fn
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.schedule import linear_warmup_cosine

Pytree = Any
_F32 = torch.float32

#: the training call: the reference's ``CallConfig()`` (remat on, MoE with
#: drops) with its "xla" attention as the plain one, and the plain scan
TRAIN_CALL = CallConfig(attn_impl="plain", ssm_impl="plain")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    base_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatches: int = 1
    adamw: AdamWConfig = AdamWConfig()
    call: CallConfig = TRAIN_CALL


def make_loss(cfg: ModelConfig, call: CallConfig):
    def f(model: Transformer, batch: Mapping[str, Any]) -> torch.Tensor:
        total, _ = loss_fn(model, cfg, batch, call)
        return total
    return f


def grads_with_microbatching(
    cfg: ModelConfig, call: CallConfig, microbatches: int
) -> Callable:
    """-> ``gfn(model, batch)`` -> (loss, {name: gradient}).

    With more than one microbatch, the batch's leading axis is cut into
    ``microbatches`` slices of ``B // microbatches`` rows, each slice's
    gradients are added into float32 accumulators, and the loss and the
    gradients are the means over the slices."""
    lf = make_loss(cfg, call)

    def grads(model, batch):
        names, params = zip(*model.named_parameters())
        for p in params:
            if not p.requires_grad:
                p.requires_grad_(True)
        with torch.enable_grad():
            loss = lf(model, batch)
            g = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), names, g

    def gfn(model: Transformer, batch: Mapping[str, Any]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if microbatches <= 1:
            loss, names, g = grads(model, batch)
            return loss, dict(zip(names, g))
        loss_acc = acc = None
        for i in range(microbatches):
            mb = {k: v[i * (v.shape[0] // microbatches):
                       (i + 1) * (v.shape[0] // microbatches)]
                  for k, v in batch.items()}
            loss, names, g = grads(model, mb)
            if acc is None:
                loss_acc = torch.zeros((), dtype=_F32, device=loss.device)
                acc = [torch.zeros(t.shape, dtype=_F32, device=t.device)
                       for t in g]
            for a, t in zip(acc, g):
                a.add_(t)
            loss_acc = loss_acc + loss
            del g
        inv = 1.0 / microbatches
        return loss_acc * inv, {n: a.mul_(inv) for n, a in zip(names, acc)}

    return gfn


def train_step_fn(cfg: ModelConfig, tcfg: TrainConfig):
    """-> ``step_fn(model, opt_state, batch, step)`` -> (model, opt_state,
    metrics ``loss``, ``lr``, ``grad_norm``, ``arrivals``): one training
    step, the model and the state updated in place, recorded as the
    spans ``train.step`` and, inside it, ``train.grads`` (the loss and
    its gradients, every microbatch) and ``train.adamw`` (the update:
    the global norm, the clip and the per-tensor loop)."""
    gfn = grads_with_microbatching(cfg, tcfg.call, tcfg.microbatches)

    def step_fn(model: Transformer, opt_state: Dict[str, Any],
                batch: Mapping[str, Any], step):
        card = model.device.type == "cuda"
        with trace.span("train.step"):
            with trace.span("train.grads", device=card):
                loss, grads = gfn(model, batch)
            lr = linear_warmup_cosine(
                torch.as_tensor(step, device=loss.device),
                base_lr=tcfg.base_lr, warmup_steps=tcfg.warmup_steps,
                total_steps=tcfg.total_steps)
            del batch
            with trace.span("train.adamw", device=card):
                _, opt_state, om = adamw_update(grads, opt_state, model, lr,
                                                tcfg.adamw)
            metrics = {"loss": loss, "lr": lr, **om,
                       # the completion-unit arrival
                       "arrivals": torch.ones((), dtype=_F32,
                                              device=loss.device)}
        return model, opt_state, metrics

    return step_fn


def build_train_step(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    batch_shapes: Mapping[str, Any],
    *,
    mesh: Optional[LogicalMesh] = None,
    device=None,
):
    """-> (step, param_specs, opt_specs, batch_specs).

    ``step(model, opt_state, batch, i)`` runs :func:`train_step_fn`'s step
    on ``device`` (the card when None; raises without one): the batch
    (numpy arrays or tensors) must have ``batch_shapes``' keys and shapes
    (``data.input_specs`` gives them) and goes to the device; the model
    must live there.  The specs are the reference's over ``mesh`` (a 1 x 1
    ``("data", "model")`` mesh when None): the parameter specs over the
    reference's stacked tree (``convert.reference_shapes``), the moments'
    the same, the counter's and every unsharded leaf's ``()``.
    """
    dev = resolve_device(device, "the train step", "train")
    mesh = mesh or LogicalMesh(("data", "model"), (1, 1))
    pspecs = param_specs(convert.reference_shapes(cfg), mesh)
    ospecs = {"mu": pspecs, "nu": pspecs, "count": ()}
    bspecs = batch_specs(batch_shapes, mesh)
    want = {k: tuple(v.shape) for k, v in batch_shapes.items()}
    step_fn = train_step_fn(cfg, tcfg)

    def step(model: Transformer, opt_state: Dict[str, Any],
             batch: Mapping[str, Any], i):
        got = {k: tuple(v.shape) for k, v in batch.items()}
        if got != want:
            raise ValueError(f"batch shapes {got}, the step was built for "
                             f"{want}")
        if model.device.type != dev.type:
            raise ValueError(f"the model is on {model.device}, the step "
                             f"runs on {dev}")
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        return step_fn(model, opt_state, batch, i)

    return step, pspecs, ospecs, bspecs
