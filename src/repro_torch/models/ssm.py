"""State-space blocks: Mamba-1 (S6 selective scan) and Mamba-2 (SSD) —
twin of ``repro.models.ssm``.

The recurrence h_t = a_t ⊙ h_{t-1} + b_t runs one chunk of ``cfg.ssm.chunk``
steps at a time, as the reference's ``lax.scan`` over chunks does: the
(B, chunk, d_inner, d_state) gate tensors exist for one chunk only, so a
long prompt never materialises O(S·d_inner·d_state) state.  Each chunk's
scan goes through ``ssm_impl``:

  * "kernel" — the hand-written CUDA scan kernel (``kernels.ops.ssm_scan``,
               the twin of the Pallas ``ssm_scan``); CUDA tensors only;
  * "plain"  — the sequential scan in plain torch (``kernels.ref.ssm_scan``),
               on any device;
  * "auto"   — "kernel" for a CUDA tensor, "plain" for a CPU one.

Both carry the state from chunk to chunk through ``h0`` and
``return_state``.  The reference scans inside a chunk with an associative
scan; both of these are sequential, so the two differ by f32 rounding only.
The last chunk is passed short, not padded: the state it returns is the
state after the last real step, which is what the reference's zero-dt
padding gives.  Decode is the single-step recurrence in plain torch, as the
reference keeps it in jnp.

Mamba-2 (SSD, groups = 1), the hybrid family's block, goes through the
same scan: its decay exp(dt·A) is one scalar per (token, head), expanded
over the head's (P, N) states so that the scan sees D = H·P channels of N
states each, one decay per element as the kernel takes it; its input is
(dt·x)⊗B and C_t is shared by every head.  Parameters ``p`` are one
layer's mixer weights as a mapping, the reference's tree; products cast
each weight to the activations' dtype at use.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import gated_rms_norm

IMPLS = ("plain", "kernel", "auto")
Params = Mapping[str, torch.Tensor]
_F32 = torch.float32


def resolve_impl(impl: str, t: torch.Tensor) -> str:
    """``impl`` with "auto" decided by where ``t`` lies."""
    if impl not in IMPLS:
        raise ValueError(f"ssm impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "kernel" if t.is_cuda else "plain"
    return impl


def _scan(a, b, c, h0, impl: str):
    """One chunk's scan -> (y (B, chunk, D), h_last (B, D, N) f32)."""
    if resolve_impl(impl, a) == "kernel":
        return kops.ssm_scan(a, b, c, h0=h0, return_state=True,
                             impl="kernel")
    return kref.ssm_scan(a, b, c, h0=h0, return_state=True)


# --- the shared recurrence engine -----------------------------------------------


def chunked_linear_recurrence(a: torch.Tensor, b: torch.Tensor,
                              h0: torch.Tensor, chunk: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t -> (all h_t (B, S, ...), final state).

    ``a`` may be a broadcast-shaped decay (e.g. (B, S, H, 1, 1) against b's
    (B, S, H, P, N)).  Runs sequentially; ``chunk``, the reference's
    associative-scan block, changes nothing here but the rounding the
    reference's result carries, and is taken for its signature."""
    h = h0
    states = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        states.append(h)
    return torch.stack(states, dim=1), h


# --- causal depthwise conv (k small, unrolled shifts) -----------------------------


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (C, K); y_t = Σ_j w[:, j]·x_{t-K+1+j} + bias."""
    k = w.shape[-1]
    s = x.shape[1]
    out = x * w[:, -1]
    for j in range(1, k):
        shifted = F.pad(x, (0, 0, j, 0))[:, :s]
        out = out + shifted * w[:, -1 - j]
    return out + bias


def conv_decode(x_new: torch.Tensor, conv_state: torch.Tensor,
                w: torch.Tensor, bias: torch.Tensor):
    """One-step conv: state (B, K-1, C) holds the last K-1 inputs."""
    window = torch.cat([conv_state, x_new[:, None]], dim=1)     # (B, K, C)
    y = torch.einsum("bkc,ck->bc", window, w) + bias
    return y, window[:, 1:]


# --- Mamba-1 (S6) -------------------------------------------------------------------


def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def _dt_and_bc(xc: torch.Tensor, p: Params, cfg: ModelConfig):
    """Post-conv x -> (dt f32 (B, S, din), B_t, C_t (B, S, N)) and
    A = -exp(A_log) f32 (din, N)."""
    n = cfg.ssm.d_state
    r = _dt_rank(cfg)
    dbc = torch.matmul(xc, p["x_proj"].to(xc.dtype))
    dt_low, b_t, c_t = torch.split(dbc, [r, n, n], dim=-1)
    dt = torch.matmul(dt_low, p["dt_proj"].to(xc.dtype))
    dt = F.softplus(dt.to(_F32) + p["dt_bias"].to(_F32))
    a_mat = -torch.exp(p["A_log"].to(_F32))                    # (din, N)
    return dt, b_t, c_t, a_mat


def _mamba1_gates(xc: torch.Tensor, p: Params, cfg: ModelConfig):
    """Post-conv x -> (a, b_in, C_t) of the recurrence."""
    dt, b_t, c_t, a_mat = _dt_and_bc(xc, p, cfg)
    a = torch.exp(dt[..., None] * a_mat)                       # (B,S,din,N)
    b = (dt * xc.to(_F32))[..., None] * b_t.to(_F32)[:, :, None, :]
    return a, b, c_t


def _conv_tail(x_in: torch.Tensor, k: int) -> torch.Tensor:
    """The last K-1 pre-conv inputs (B, K-1, C): the decode cache's conv
    state.  A prompt shorter than K-1 is preceded by zeros, as the causal
    conv sees it."""
    tail = x_in[:, -(k - 1):]
    if tail.shape[1] < k - 1:
        tail = F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))
    return tail


def mamba1_block(x: torch.Tensor, p: Params, cfg: ModelConfig,
                 return_state: bool = False, impl: str = "auto"):
    """(B, S, D) -> (B, S, D); full-sequence S6.  With ``return_state``,
    also returns (conv_tail, h_last) for priming a decode cache.

    The (B, chunk, d_inner, d_state) gates are built one chunk at a time
    and scanned with ``impl`` (module docstring), the state carried from
    chunk to chunk."""
    s1 = cfg.ssm
    bsz, s = x.shape[0], x.shape[1]
    xz = torch.matmul(x, p["in_proj"].to(x.dtype))
    x_in, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(causal_conv(x_in, p["conv_w"].to(x.dtype),
                            p["conv_b"].to(x.dtype)))
    dt, b_t, c_t, a_mat = _dt_and_bc(xc, p, cfg)
    xc32, b32, c32 = xc.to(_F32), b_t.to(_F32), c_t.to(_F32)

    h = torch.zeros((bsz, cfg.d_inner, s1.d_state), dtype=_F32,
                    device=x.device)
    ys = []
    for start in range(0, s, s1.chunk):
        sl = slice(start, start + s1.chunk)
        dtc = dt[:, sl]
        a = (dtc[..., None] * a_mat).exp_()                  # (B,c,din,N)
        b = (dtc * xc32[:, sl])[..., None] * b32[:, sl, None, :]
        y_c, h = _scan(a, b, c32[:, sl].contiguous(), h, impl)
        ys.append(y_c)
        del a, b
    y = torch.cat(ys, dim=1) if ys else xc32.new_zeros((bsz, 0, cfg.d_inner))
    y = y + p["D"].to(_F32) * xc32
    y = (y * F.silu(z.to(_F32))).to(x.dtype)
    out = torch.matmul(y, p["out_proj"].to(x.dtype))
    if return_state:
        return out, (_conv_tail(x_in, s1.d_conv), h)
    return out


def mamba1_decode(x: torch.Tensor, p: Params, cfg: ModelConfig,
                  conv_state: torch.Tensor, h: torch.Tensor):
    """x: (B, 1, D); returns (y, conv_state, h)."""
    xz = torch.matmul(x, p["in_proj"].to(x.dtype))
    x_in, z = torch.chunk(xz[:, 0], 2, dim=-1)                  # (B, din)
    xc_flat, conv_state = conv_decode(x_in, conv_state,
                                      p["conv_w"].to(x.dtype),
                                      p["conv_b"].to(x.dtype))
    xc = F.silu(xc_flat)[:, None]                               # (B,1,din)
    a, b, c_t = _mamba1_gates(xc, p, cfg)
    h = a[:, 0] * h + b[:, 0]                                   # (B,din,N)
    y = torch.matmul(h, c_t[:, 0].to(_F32)[:, :, None])[..., 0]
    y = y + p["D"].to(_F32) * xc[:, 0].to(_F32)
    y = (y * F.silu(z.to(_F32))).to(x.dtype)[:, None]
    return (torch.matmul(y, p["out_proj"].to(x.dtype)), conv_state, h)


# --- Mamba-2 (SSD, groups = 1): the hybrid family's block ---------------------------


def _mamba2_split(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads H, head dim P, d_state N)."""
    s2 = cfg.ssm
    din = cfg.d_inner
    return din, din // s2.headdim, s2.headdim, s2.d_state


def _mamba2_dt(dt_raw: torch.Tensor, p: Params):
    """The raw dt -> (dt = softplus(dt_raw + dt_bias) f32 (B, S, H), A =
    -exp(A_log) f32 (H,))."""
    dt = F.softplus(dt_raw.to(_F32) + p["dt_bias"].to(_F32))
    return dt, -torch.exp(p["A_log"].to(_F32))


def _mamba2_gates(xbc: torch.Tensor, dt_raw: torch.Tensor, p: Params,
                  cfg: ModelConfig):
    """Post-conv xbc and the raw dt -> (a (B, S, H, 1, 1), b (B, S, H, P,
    N), x by heads (B, S, H, P), C_t (B, S, N)) of the recurrence."""
    din, nh, hp, n = _mamba2_split(cfg)
    x_c, b_t, c_t = torch.split(xbc, [din, n, n], dim=-1)
    dt, a_vec = _mamba2_dt(dt_raw, p)
    a = torch.exp(dt * a_vec)                                  # (B,S,H)
    xh = x_c.reshape(x_c.shape[:-1] + (nh, hp))
    b = (dt[..., None] * xh.to(_F32))[..., None] \
        * b_t.to(_F32)[:, :, None, None, :]                    # (B,S,H,P,N)
    return a[..., None, None], b, xh, c_t


def expanded_decay(dtc: torch.Tensor, a_vec: torch.Tensor, hp: int,
                   n: int) -> torch.Tensor:
    """A chunk's decay for the scan: exp(dt·A), one scalar per (token,
    head) of ``dtc`` (B, chunk, H) f32, repeated over the head's (P, N)
    states into a contiguous (B, chunk, H·P, N) tensor — one decay per
    element, as the scan kernel (and the TPU kernel it replaces) takes
    it."""
    bsz, cl, nh = dtc.shape
    return (dtc * a_vec).exp_()[..., None, None].expand(
        bsz, cl, nh, hp, n).reshape(bsz, cl, nh * hp, n).contiguous()


def mamba2_block(x: torch.Tensor, p: Params, cfg: ModelConfig,
                 return_state: bool = False, impl: str = "auto"):
    """(B, S, D) -> (B, S, D); full-sequence Mamba-2 SSD.  With
    ``return_state``, also returns (conv_tail, h_last) for priming a
    decode cache: the last K-1 pre-conv rows (B, K-1, d_inner + 2N) and
    the state (B, H, P, N) f32.

    The gates exist one chunk at a time, as in :func:`mamba1_block`: a
    chunk's decay is :func:`expanded_decay`'s (B, chunk, H·P, N) tensor and
    its input (dt·x)⊗B is reshaped to the same, so each chunk is one scan
    of D = H·P channels through ``impl``, the state carried as (B, H·P,
    N)."""
    s2 = cfg.ssm
    din, nh, hp, n = _mamba2_split(cfg)
    bsz, s = x.shape[0], x.shape[1]
    proj = torch.matmul(x, p["in_proj"].to(x.dtype))
    z, xbc_raw, dt_raw = torch.split(proj, [din, din + 2 * n, nh], dim=-1)
    xbc = F.silu(causal_conv(xbc_raw, p["conv_w"].to(x.dtype),
                             p["conv_b"].to(x.dtype)))
    x_c, b_t, c_t = torch.split(xbc, [din, n, n], dim=-1)
    dt, a_vec = _mamba2_dt(dt_raw, p)
    xh32 = x_c.reshape(bsz, s, nh, hp).to(_F32)
    b32, c32 = b_t.to(_F32), c_t.to(_F32)

    h = torch.zeros((bsz, nh * hp, n), dtype=_F32, device=x.device)
    ys = []
    for start in range(0, s, s2.chunk):
        sl = slice(start, start + s2.chunk)
        dtc = dt[:, sl]
        a = expanded_decay(dtc, a_vec, hp, n)
        b = ((dtc[..., None] * xh32[:, sl])[..., None]
             * b32[:, sl, None, None, :]).reshape(bsz, dtc.shape[1],
                                                  nh * hp, n)
        y_c, h = _scan(a, b, c32[:, sl].contiguous(), h, impl)
        ys.append(y_c)
        del a, b
    y = (torch.cat(ys, dim=1) if ys
         else xh32.new_zeros((bsz, 0, nh * hp))).reshape(bsz, s, nh, hp)
    y = y + p["D"].to(_F32)[:, None] * xh32
    y = y.reshape(bsz, s, din).to(x.dtype)
    y = gated_rms_norm(y, z, p["norm"], cfg.norm_eps)
    out = torch.matmul(y, p["out_proj"].to(x.dtype))
    if return_state:
        return out, (_conv_tail(xbc_raw, s2.d_conv),
                     h.reshape(bsz, nh, hp, n))
    return out


def mamba2_decode(x: torch.Tensor, p: Params, cfg: ModelConfig,
                  conv_state: torch.Tensor, h: torch.Tensor):
    """x: (B, 1, D); conv_state (B, K-1, d_inner + 2N); h (B, H, P, N) f32
    -> (y, conv_state, h)."""
    din, nh, hp, n = _mamba2_split(cfg)
    proj = torch.matmul(x, p["in_proj"].to(x.dtype))
    z, xbc, dt_raw = torch.split(proj[:, 0], [din, din + 2 * n, nh],
                                 dim=-1)
    xbc_flat, conv_state = conv_decode(xbc, conv_state,
                                       p["conv_w"].to(x.dtype),
                                       p["conv_b"].to(x.dtype))
    xbc1 = F.silu(xbc_flat)[:, None]
    a, b, xh, c_t = _mamba2_gates(xbc1, dt_raw[:, None], p, cfg)
    h = a[:, 0] * h + b[:, 0]                                   # (B,H,P,N)
    y = torch.matmul(h, c_t[:, 0].to(_F32)[:, None, :, None])[..., 0]
    y = y + p["D"].to(_F32)[:, None] * xh[:, 0].to(_F32)
    y = y.reshape(x.shape[0], 1, din).to(x.dtype)
    y = gated_rms_norm(y, z[:, None], p["norm"], cfg.norm_eps)
    return torch.matmul(y, p["out_proj"].to(x.dtype)), conv_state, h
