"""Mixture-of-Experts block: top-k routing, capacity-based dispatch, shared
experts, load-balancing auxiliary loss — twin of ``repro.models.moe``.

With drops (training, ``no_drop=False``) dispatch is the reference's (E,
C, D) buffer: tokens scatter into per-expert capacity slots, one batched
product per expert matrix runs all experts (``torch.bmm``, the twin of the
reference's ``jnp.einsum``), and per-k gathers combine the results.
Entries beyond an expert's capacity are dropped (their combine weight is
zero).

Without drops (every serving program) the block groups the T·k routed
rows by expert instead (:func:`grouped_experts`): a stable sort of the
choices, per-expert offsets counted on the device, one gather of the rows,
and each expert's matrices over its own rows only
(``torch._grouped_mm`` with the offsets on the device).  The same
products as the (E, T, D) buffer of ``capacity(no_drop=True)``, whose
E / k times the routed work and (E·T, D) transients a long prompt cannot
hold; the rows' order within an expert is the buffer's, and the combine
is the same per-k sum in float32.  On the card only bf16 takes that path
(:func:`takes_grouped`): for other dtypes ``torch._grouped_mm`` copies
the offsets to the host and loops over the groups, so those keep the
buffer, which reads nothing on the host.

Three choices keep the port's routing the reference's:

* the top k come from a stable descending sort of the router's
  probabilities, so equal probabilities keep the lower expert index first,
  as ``jax.lax.top_k`` orders them (``torch.topk`` promises no order);
* the buffer is written with an accumulating scatter (``index_add_``), as
  the reference's ``.at[].add``: a dropped entry lands, zeroed, on slot
  C - 1 of its expert beside the real one, and adding zeros keeps that
  slot's value whatever the order;
* nothing is read on the host (no ``.item()``, no boolean-mask indexing,
  no shape that depends on the routing, no grouped product on the card
  but bf16's), so a decode step that calls the block is captured into
  one CUDA graph (``core/graphs.py``).

Eager calls record the spans ``moe.route``, ``moe.experts`` (the grouped
products, device time on the card) and ``moe.combine`` while tracing is
on (``core/trace.py``); inside a captured graph they record at the
capture only.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import trace
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import gated_mlp

CAPACITY_FACTOR = 1.25


def capacity(tokens: int, n_experts: int, top_k: int,
             no_drop: bool = False) -> int:
    """Slots per expert: ``tokens`` without drops (a token's k choices are
    distinct experts, so no expert receives more), else ``tokens · k / E ·
    CAPACITY_FACTOR`` rounded up to 8, at least 8."""
    if no_drop:
        return tokens
    c = int(tokens * top_k / n_experts * CAPACITY_FACTOR)
    return max(8, -(-c // 8) * 8)


def route(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` of ``probs`` (T, E) -> (values, indices), largest
    first, ties to the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _act(g: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return F.silu(g) if cfg.act == "silu" else F.gelu(g, approximate="tanh")


def takes_grouped(device: torch.device, dtype: torch.dtype) -> bool:
    """Whether the drop-less block runs :func:`grouped_experts` for
    activations of ``dtype`` on ``device``: off the card always (nothing
    is captured there), on the card for bf16 alone, the one dtype whose
    ``torch._grouped_mm`` reads its offsets on the device.  Other dtypes
    on the card take the (E·T, D) buffer: the operator's fallback copies
    the offsets to the host (a sync in every MoE layer, which no graph
    captures)."""
    return device.type != "cuda" or dtype == torch.bfloat16


def grouped_experts(xf: torch.Tensor, e_flat: torch.Tensor, ex: Mapping,
                    cfg: ModelConfig) -> torch.Tensor:
    """Every routed row through its expert, grouped by expert: ``xf`` (T,
    D), ``e_flat`` (K·T,) the experts chosen, k-major (row kk·T + t is
    token t's kk-th choice) -> (K·T, D) in ``e_flat``'s order.

    The rows are sorted by expert (stable: within an expert in (k, token)
    order, the order of the capacity buffer's slots), each expert's count
    is summed on the device into the offsets ``torch._grouped_mm`` takes,
    and ``wi``/``wg``/``wo`` (cast to the activations' dtype at use) run
    over each expert's own rows.  Fixed shapes, and no host read for the
    inputs :func:`takes_grouped` admits on the card: a decode step that
    calls it is captured as the buffer's was."""
    t = xf.shape[0]
    e = ex["wi"].shape[0]
    dt = xf.dtype
    order = torch.argsort(e_flat, stable=True)                 # (K*T,)
    counts = torch.zeros(e, dtype=torch.int32, device=xf.device)
    counts.index_add_(0, e_flat, torch.ones_like(e_flat, dtype=torch.int32))
    offs = torch.cumsum(counts, dim=0, dtype=torch.int32)      # group ends
    rows = xf[order % t]                                       # (K*T, D)
    h = torch._grouped_mm(rows, ex["wi"].to(dt), offs=offs)
    g = torch._grouped_mm(rows, ex["wg"].to(dt), offs=offs)
    y_sorted = torch._grouped_mm(_act(g, cfg) * h, ex["wo"].to(dt), offs=offs)
    return torch.empty_like(y_sorted).index_copy_(0, order, y_sorted)


def moe_block(x: torch.Tensor, p: Mapping, cfg: ModelConfig,
              no_drop: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D), ``p`` one layer's MoE weights (``router``,
    ``experts: {wi, wg, wo}``, ``shared: {wi, wg, wo}``) -> (output, aux
    load-balance loss).  ``no_drop`` routes every choice
    (:func:`grouped_experts`, or the (E·T, D) buffer where
    :func:`takes_grouped` says no); otherwise through capacity slots."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    xf = x.reshape(t, d)
    dev = x.is_cuda

    # --- router (f32) ---------------------------------------------------------
    with trace.span("moe.route"):
        logits = torch.matmul(xf.to(torch.float32),
                              p["router"].to(torch.float32))
        probs = torch.softmax(logits, dim=-1)                  # (T, E)
        gate_vals, gate_idx = route(probs, k)                  # (T, K)
        if m.norm_topk:
            gate_vals = gate_vals / torch.clamp(
                gate_vals.sum(-1, keepdim=True), min=1e-9)     # renormalise

        # --- load-balancing aux loss (Switch-style) ---------------------------
        me = probs.mean(dim=0)                                 # (E,)
        ce = F.one_hot(gate_idx[:, 0], e).to(torch.float32).mean(dim=0)
        aux = m.aux_loss_coef * e * torch.sum(me * ce)
        # flat (K*T,) expert choices and weights, in (k, token) order
        e_flat = gate_idx.T.reshape(-1)                        # (K*T,)
        w_flat = gate_vals.T.reshape(-1)

    if no_drop and takes_grouped(x.device, x.dtype):
        with trace.span("moe.experts", device=dev):
            y_rows = grouped_experts(xf, e_flat, p["experts"], cfg)
        with trace.span("moe.combine"):
            y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
            for kk in range(k):
                sl = slice(kk * t, (kk + 1) * t)
                y = y + w_flat[sl, None] * y_rows[sl].to(torch.float32)
        return _shared(y.to(x.dtype), xf, p, cfg).reshape(b, s, d), aux
    return _capacity_block(x, xf, p, cfg, e_flat, w_flat,
                           capacity(t, e, k, no_drop)), aux


def _shared(y: torch.Tensor, xf: torch.Tensor, p: Mapping,
            cfg: ModelConfig) -> torch.Tensor:
    """``y`` plus the always-on shared experts."""
    if cfg.moe.n_shared:
        sh = p["shared"]
        y = y + gated_mlp(xf, sh["wi"], sh["wg"], sh["wo"], cfg.act)
    return y


def _capacity_block(x, xf, p: Mapping, cfg: ModelConfig,
                    e_flat: torch.Tensor, w_flat: torch.Tensor, c: int
                    ) -> torch.Tensor:
    """The reference's dispatch through ``c`` capacity slots an expert
    (drops beyond them)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    # --- dispatch: positions within each expert's capacity ----------------------
    # priority by (k, token) order
    onehot = F.one_hot(e_flat, e).to(torch.int32)              # (K*T, E)
    pos_in_e = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos_flat = torch.gather(pos_in_e, 1, e_flat[:, None])[:, 0]
    keep = pos_flat < c
    pos_clamped = torch.clamp(pos_flat, max=c - 1).to(torch.long)

    tok_idx = torch.arange(t, device=x.device).repeat(k)
    contrib = torch.where(keep[:, None], xf[tok_idx], torch.zeros(
        (), dtype=x.dtype, device=x.device))
    buf = torch.zeros((e * c, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, e_flat * c + pos_clamped, contrib)
    buf = buf.view(e, c, d)                                    # (E, C, D)

    # --- expert FFNs: one batched product per expert matrix ---------------------
    dt = x.dtype
    ex = p["experts"]
    h = torch.bmm(buf, ex["wi"].to(dt))
    g = torch.bmm(buf, ex["wg"].to(dt))
    g = _act(g, cfg)
    y_buf = torch.bmm(g * h, ex["wo"].to(dt))                  # (E, C, D)

    # --- combine: per-k weighted gathers (transients at (T, D)) -----------------
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    zero = torch.zeros((), dtype=w_flat.dtype, device=x.device)
    for kk in range(k):
        sl = slice(kk * t, (kk + 1) * t)
        wk = torch.where(keep[sl], w_flat[sl], zero)
        y = y + wk[:, None] * y_buf[e_flat[sl], pos_clamped[sl]].to(
            torch.float32)
    return _shared(y.to(x.dtype), xf, p, cfg).reshape(b, s, d)
