"""Cell builder: one countable program per (architecture × shape) — twin
of ``repro.launch.cells``.

A *cell* is the unit of the dry-run and the roofline table:

    train_4k     train_step       seq 4096,   global batch 256
    prefill_32k  prefill          seq 32768,  global batch 32
    decode_32k   serve_step       KV cache 32768, global batch 128
    long_500k    serve_step       state/cache 524288, global batch 1
                 (sub-quadratic archs only: zamba2, falcon-mamba —
                  full-attention archs are skipped, as in the reference)

``build_cell`` returns (fn, args, meta) and ``make_cell`` the same as a
:class:`Cell` with the call and train config they were built from:
``fn(*args)`` runs the cell's
program once on ``meta`` tensors — a ``meta`` model from
``init_params(cfg, device="meta")``, ``meta`` inputs from
``data.input_specs``, ``meta`` optimizer state and caches — so running it
under :func:`repro_torch.launch.op_cost.count_cost` allocates nothing,
as the reference's ``fn.lower(*args).compile()`` allocates nothing.
``cell_layout`` gives the arguments and outputs of a built cell, with
the specs under which a device holds them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import convert
from repro_torch.data.pipeline import input_specs
from repro_torch.dist.sharding import (
    LogicalMesh, batch_specs, cache_specs, param_specs,
)
from repro_torch.launch.roofline import model_flops_forward, model_flops_train
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import CallConfig, init_cache, init_params, prefill
from repro_torch.models.registry import count_params, get
from repro_torch.optim.adamw import adamw_init
from repro_torch.serve.engine import build_serve_step
from repro_torch.train.step import TrainConfig, build_train_step

SHAPES: Dict[str, Tuple[str, int, int]] = {
    "train_4k": ("train", 4096, 256),
    "prefill_32k": ("prefill", 32768, 32),
    "decode_32k": ("decode", 32768, 128),
    "long_500k": ("decode", 524288, 1),
}

#: the reference's ``CallConfig`` knobs the port has no field for: the
#: sharding constraints lay nothing out on one card, and the chunked
#: attention's per-chunk remat is not ported (``models/model.py``)
UNPORTED_CALL_KNOBS = ("residual_spec", "attn_q_sharding",
                       "moe_buffer_sharding", "attn_chunk_remat")


def applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention architecture: 500k-token dense KV "
                       "decode is out of regime (assignment: run for "
                       "SSM/hybrid only)")
    return True, ""


@dataclasses.dataclass
class CellMeta:
    arch: str
    shape: str
    mode: str
    seq: int
    global_batch: int
    tokens: int
    chips: int
    model_flops: float
    params_total: int
    params_active: int


def default_call(mode: str, seq: int, overrides: Optional[Dict] = None
                 ) -> CallConfig:
    """The reference's per-mode call with its "xla" attention as the plain
    one ("chunked" above 2048 tokens) and the plain scan.  An override
    naming one of :data:`UNPORTED_CALL_KNOBS` raises ``ValueError``."""
    kw: Dict[str, Any] = {"ssm_impl": "plain"}
    if mode in ("train", "prefill"):
        kw["attn_impl"] = "chunked" if seq > 2048 else "plain"
        kw["attn_chunk"] = 512
        kw["remat"] = mode == "train"
    if mode != "train":
        kw["moe_no_drop"] = mode == "decode"  # decode exact; prefill capacity
    if overrides:
        kw.update(overrides)
    for knob in UNPORTED_CALL_KNOBS:
        if knob in kw:
            raise ValueError(
                f"call override {knob!r}: the reference's CallConfig knob "
                f"has no field in the port's (one card lays nothing out; "
                f"{', '.join(UNPORTED_CALL_KNOBS)} are not ported)")
    return CallConfig(**kw)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass
class Cell:
    fn: Callable
    args: tuple                      # ``meta`` tensors and trees of them
    meta: CellMeta
    call: CallConfig
    train: Optional[TrainConfig]     # the train step's config; else None


def build_cell(
    arch: str,
    shape: str,
    mesh: LogicalMesh,
    call_overrides: Optional[Dict] = None,
    train_overrides: Optional[Dict] = None,
):
    """-> (fn, tuple of ``meta`` args, CellMeta)."""
    cell = make_cell(arch, shape, mesh, call_overrides, train_overrides)
    return cell.fn, cell.args, cell.meta


def make_cell(
    arch: str,
    shape: str,
    mesh: LogicalMesh,
    call_overrides: Optional[Dict] = None,
    train_overrides: Optional[Dict] = None,
) -> Cell:
    cfg = get(arch)
    ok, why = applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} × {shape} skipped: {why}")
    mode, seq, gbatch = SHAPES[shape]
    call = default_call(mode, seq, call_overrides)
    tcfg = None
    model = init_params(cfg, device="meta")
    n_total = count_params(cfg)
    n_active = count_params(cfg, active_only=True)
    batch = input_specs(cfg, mode=mode, batch=gbatch, seq=seq)

    if mode == "train":
        tokens = gbatch * seq
        tcfg = TrainConfig(**(train_overrides or {}), call=call)
        fn, _, _, _ = build_train_step(cfg, tcfg, batch, mesh=mesh,
                                       device="meta")
        args = (model, adamw_init(model, tcfg.adamw), batch,
                _meta((), torch.int32))
        mf = model_flops_train(n_active, tokens)
    elif mode == "prefill":
        tokens = gbatch * seq

        def fn(model, batch):
            with torch.no_grad():
                return prefill(model, cfg, batch, seq, call)

        args = (model, batch)
        mf = model_flops_forward(n_active, tokens)
    else:  # decode
        tokens = gbatch

        def fn(model, cache, tokens):
            with torch.no_grad():
                return build_serve_step(model, cfg, call)(cache, tokens)

        args = (model, init_cache(cfg, gbatch, seq, device="meta"),
                batch["tokens"])
        mf = model_flops_forward(n_active, tokens)

    meta = CellMeta(
        arch=arch, shape=shape, mode=mode, seq=seq, global_batch=gbatch,
        tokens=tokens, chips=mesh.size, model_flops=mf,
        params_total=n_total, params_active=n_active,
    )
    return Cell(fn, args, meta, call, tcfg)


def cell_layout(cell: Cell, mesh: LogicalMesh) -> Dict[str, Any]:
    """The cell's arguments and outputs as (tree of ``meta`` tensors,
    specs) pairs under ``mesh`` — the reference's in/out shardings:
    ``arguments``, ``outputs`` and ``aliased`` (the arguments the program
    updates in place, as the reference's donated buffers).  Parameters
    and moments are the reference's stacked tree
    (``convert.reference_shapes``); the same bytes as the port's, the
    moments in the dtype of the cell's own AdamW config."""
    cfg = get(cell.meta.arch)
    mode, seq, gbatch = cell.meta.mode, cell.meta.seq, cell.meta.global_batch
    params = convert.reference_shapes(cfg)
    pspecs = param_specs(params, mesh)
    batch = input_specs(cfg, mode=mode, batch=gbatch, seq=seq)
    bspecs = batch_specs(batch, mesh)
    if mode == "train":
        dt = getattr(torch, cell.train.adamw.moment_dtype)
        moments = {k: _moments(v, dt) for k, v in params.items()}
        opt = {"mu": moments, "nu": moments, "count": _meta((), torch.int32)}
        ospecs = {"mu": pspecs, "nu": pspecs, "count": ()}
        metrics = {k: _meta((), torch.float32)
                   for k in ("loss", "lr", "grad_norm", "arrivals")}
        state = [(params, pspecs), (opt, ospecs)]
        return {"arguments": state + [(batch, bspecs),
                                      (_meta((), torch.int32), ())],
                "outputs": state + [(metrics, _replicated(metrics))],
                "aliased": state}
    cache = init_cache(cfg, gbatch, seq, device="meta")
    cspecs = cache_specs(cache, mesh)
    logits = _meta((gbatch, 1, cfg.vocab_size), torch.float32)
    out = [(logits, ()), (cache, cspecs)]
    if mode == "prefill":
        return {"arguments": [(params, pspecs), (batch, bspecs)],
                "outputs": out, "aliased": []}
    return {"arguments": [(params, pspecs), (cache, cspecs),
                          (batch, bspecs)],
            "outputs": out, "aliased": [(cache, cspecs)]}


def _moments(tree, dtype):
    if isinstance(tree, dict):
        return {k: _moments(v, dtype) for k, v in tree.items()}
    return _meta(tree.shape, dtype)


def _replicated(tree):
    return {k: () for k in tree}
