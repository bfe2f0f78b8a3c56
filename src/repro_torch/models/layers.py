"""Shared neural-net layers: norms, rotary/sinusoidal positions, gated MLPs
(twin of ``repro.models.layers``; same arithmetic, in the same types)."""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in f32 (gemma-style ``(1 + w)`` scaling when plus_one)."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    w = weight.to(torch.float32)
    w = 1.0 + w if plus_one else w
    return (normed * w).to(x.dtype)


def gated_rms_norm(x: torch.Tensor, gate: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Mamba-2's norm: RMSNorm(x * silu(gate)) fused before out_proj."""
    return rms_norm(x * F.silu(gate.to(torch.float32)).to(x.dtype), weight, eps)


# --- positions -----------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str | None = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def yarn_mscale(factor: float, mscale: float) -> float:
    """DeepSeek-V2's ``yarn_get_mscale``: 0.1 · mscale · ln(factor) + 1,
    1 for a factor of at most 1."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_range(scaling, dim: int, theta: float) -> tuple:
    """(low, high): the rotary dims (of ``dim // 2``) where ``beta_fast``
    and ``beta_slow`` turns fit into the original context, floored and
    ceiled, clamped to [0, dim - 1] (``yarn_find_correction_range``)."""
    def at(turns: float) -> float:
        return (dim * math.log(scaling.original_max_position_embeddings
                               / (turns * 2 * math.pi))
                / (2 * math.log(theta)))
    return (max(math.floor(at(scaling.beta_fast)), 0),
            min(math.ceil(at(scaling.beta_slow)), dim - 1))


def yarn_freqs(dim: int, theta: float, scaling,
               device: torch.device | str | None = None) -> torch.Tensor:
    """YaRN's frequencies (dim/2,): the original ones (``f_extra``) below
    ``low``, those divided by ``factor`` (``f_inter``) above ``high``, a
    linear ramp between."""
    extra = rope_freqs(dim, theta, device)
    low, high = yarn_range(scaling, dim, theta)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0.0, 1.0)
    mask = 1.0 - ramp
    return extra / scaling.factor * (1.0 - mask) + extra * mask


def yarn_attn_factor(scaling) -> float:
    """The factor of YaRN's cos and sin: m(factor, mscale) / m(factor,
    mscale_all_dim)."""
    return (yarn_mscale(scaling.factor, scaling.mscale)
            / yarn_mscale(scaling.factor, scaling.mscale_all_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float, scaling=None) -> torch.Tensor:
    """NeoX-style half-rotation.  x: (..., S, D_head); positions: (..., S).
    ``scaling`` (a ``RopeScaling``) takes YaRN's frequencies and factor;
    without it nothing else is computed."""
    d = x.shape[-1]
    if scaling is None:
        freqs = rope_freqs(d, theta, x.device)                    # (d/2,)
    else:
        freqs = yarn_freqs(d, theta, scaling, x.device)
    angles = positions[..., None].to(torch.float32) * freqs       # (..., S, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    gain = 1.0 if scaling is None else yarn_attn_factor(scaling)
    if gain != 1.0:
        cos, sin = cos * gain, sin * gain
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """MusicGen-style sinusoidal embeddings.  positions: (..., S) -> (..., S, D)."""
    half = d_model // 2
    # filled on the positions' device (``torch.tensor`` would copy from
    # the host, which a CUDA graph capturing a decode step refuses)
    base = torch.full((), 10000.0, dtype=torch.float32,
                      device=positions.device)
    freqs = torch.exp(-torch.log(base) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# --- MLPs ------------------------------------------------------------------------


def gated_mlp(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
              wo: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU (silu) / GeGLU (gelu, tanh-approximate): wo( act(x·wg) * (x·wi) )."""
    h = torch.matmul(x, wi.to(x.dtype))
    g = torch.matmul(x, wg.to(x.dtype))
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return torch.matmul(g * h, wo.to(x.dtype))


# --- init -------------------------------------------------------------------------


def dense_init(shape: Sequence[int], generator: torch.Generator,
               in_axis: int = -2, dtype: torch.dtype = torch.float32,
               device: torch.device | str | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (the framework's only initializer):
    N(0, 1) cut at ±2, times ``1/sqrt(fan_in)``, drawn in f32 from
    ``generator`` (which must live on ``device``)."""
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    dense_init_(out, generator, in_axis)
    return out.to(dtype)


def dense_init_(t: torch.Tensor, generator: torch.Generator,
                in_axis: int = -2) -> torch.Tensor:
    """:func:`dense_init` in place, into an existing tensor (a parameter)."""
    shape = t.shape
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    std = (1.0 / max(1, fan_in)) ** 0.5
    with torch.no_grad():
        draw = t if t.dtype == torch.float32 else torch.empty_like(
            t, dtype=torch.float32)
        torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        draw.mul_(std)
        if draw is not t:
            t.copy_(draw)
    return t


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return logits
    return cap * torch.tanh(logits / cap)
