"""Mixture-of-Experts block: top-k routing, capacity-based dispatch, shared
experts, load-balancing auxiliary loss — twin of ``repro.models.moe``.

Dispatch is the reference's (E, C, D) buffer: tokens scatter into
per-expert capacity slots, one batched product per expert matrix runs all
experts (``torch.bmm``, the twin of the reference's ``jnp.einsum``), and
per-k gathers combine the results.  Entries beyond an expert's capacity
are dropped (their combine weight is zero).

Three choices keep the port's routing the reference's:

* the top k come from a stable descending sort of the router's
  probabilities, so equal probabilities keep the lower expert index first,
  as ``jax.lax.top_k`` orders them (``torch.topk`` promises no order);
* the buffer is written with an accumulating scatter (``index_add_``), as
  the reference's ``.at[].add``: a dropped entry lands, zeroed, on slot
  C - 1 of its expert beside the real one, and adding zeros keeps that
  slot's value whatever the order;
* nothing is read on the host (no ``.item()``, no boolean-mask indexing,
  no shape that depends on the routing), so a decode step that calls the
  block is captured into one CUDA graph (``core/graphs.py``).
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

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


def moe_block(x: torch.Tensor, p: Mapping, cfg: ModelConfig,
              no_drop: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D), ``p`` one layer's MoE weights (``router``,
    ``experts: {wi, wg, wo}``, ``shared: {wi, wg, wo}``) -> (output, aux
    load-balance loss)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    c = capacity(t, e, k, no_drop)
    xf = x.reshape(t, d)

    # --- router (f32) ---------------------------------------------------------
    logits = torch.matmul(xf.to(torch.float32), p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    gate_vals, gate_idx = route(probs, k)                      # (T, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)             # renormalise

    # --- load-balancing aux loss (Switch-style) -------------------------------
    me = probs.mean(dim=0)                                     # (E,)
    ce = F.one_hot(gate_idx[:, 0], e).to(torch.float32).mean(dim=0)
    aux = m.aux_loss_coef * e * torch.sum(me * ce)

    # --- dispatch: positions within each expert's capacity ----------------------
    # flat (K*T,) expert choices, priority by (k, token) order
    e_flat = gate_idx.T.reshape(-1)                            # (K*T,)
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
    g = F.silu(g) if cfg.act == "silu" else F.gelu(g, approximate="tanh")
    y_buf = torch.bmm(g * h, ex["wo"].to(dt))                  # (E, C, D)

    # --- combine: per-k weighted gathers (transients at (T, D)) -----------------
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    w_flat = gate_vals.T.reshape(-1)                           # (K*T,)
    zero = torch.zeros((), dtype=w_flat.dtype, device=x.device)
    for kk in range(k):
        sl = slice(kk * t, (kk + 1) * t)
        wk = torch.where(keep[sl], w_flat[sl], zero)
        y = y + wk[:, None] * y_buf[e_flat[sl], pos_clamped[sl]].to(
            torch.float32)
    y = y.to(x.dtype)

    # --- shared experts (always on) ---------------------------------------------
    if m.n_shared:
        sh = p["shared"]
        y = y + gated_mlp(xf, sh["wi"], sh["wg"], sh["wo"], cfg.act)
    return y.reshape(b, s, d), aux
