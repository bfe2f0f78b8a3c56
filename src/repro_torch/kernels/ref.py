"""Plain PyTorch versions of the port's kernels — the twin of
``repro.kernels.ref``.

Each function computes what its hand-written kernel computes, in the same
accumulator type (float64 for float64 inputs, float32 otherwise), and
takes the same leading batch axes.  The CPU tests run them; on the card
``chip_smoke.py`` holds each kernel against them.  Nothing on the offload
path calls them for a CUDA tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import acc_dtype


def axpy(x: torch.Tensor, y: torch.Tensor, alpha: float) -> torch.Tensor:
    acc = acc_dtype(x.dtype)
    return (alpha * x.to(acc) + y.to(acc)).to(x.dtype)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    acc = acc_dtype(a.dtype)
    return torch.matmul(a.to(acc), b.to(acc)).to(a.dtype)


def atax(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    acc = acc_dtype(a.dtype)
    a_ = a.to(acc)
    tmp = torch.matmul(a_, x.to(acc).unsqueeze(-1))
    return torch.matmul(a_.mT, tmp).squeeze(-1).to(a.dtype)


def covariance(data: torch.Tensor) -> torch.Tensor:
    acc = acc_dtype(data.dtype)
    d = data.to(acc)
    centred = d - d.mean(dim=-1, keepdim=True)
    return (torch.matmul(centred, centred.mT) / (data.shape[-1] - 1)
            ).to(data.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """Naive O(S²) attention, f32 accumulation — the flash kernel's plain
    version.  q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) with Hq a multiple of
    Hkv (GQA: the KV heads are repeated here; the kernel indexes them).
    The causal mask is aligned bottom-right (``col <= row + Skv - Sq``), as
    ``repro.kernels.ref.attention`` has it."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if k.shape[1] != h:
        rep = h // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / (d ** 0.5)
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril(
            diagonal=skv - sq)
        s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32)).to(q.dtype)


def causal_mask(sq: int, skv: int, device=None) -> torch.Tensor:
    """(Sq, Skv) bool, True where a row sees a column: the causal mask
    aligned bottom-right (``col <= row + Skv - Sq``)."""
    return torch.ones(sq, skv, dtype=torch.bool, device=device).tril(
        diagonal=skv - sq)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     allowed: torch.Tensor, scale: float | None = None
                     ) -> torch.Tensor:
    """softmax(scale · q kᵀ, -1e30 where ``allowed`` is False) · v in f32,
    in q's dtype; ``scale`` is 1/sqrt(q's head dim) when None.  q (B, H,
    Sq, Dq), k (B, H, Skv, Dq), v (B, H, Skv, Dv), ``allowed`` (Sq, Skv).
    The model's plain attention and the MLA kernel's plain version."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32))
    s = s / (d ** 0.5) if scale is None else s * scale
    s = s.masked_fill(~allowed[None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)


def ssm_scan(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
             h0: torch.Tensor | None = None, return_state: bool = False):
    """Sequential SSM scan in f32 — the scan kernel's plain version and the
    twin of ``repro.kernels.ref.ssm_scan``: h_t = a_t·h_{t-1} + b_t,
    y_t = Σ_n h_t[:, n]·c_t[n].  a, b (B, S, D, N); c (B, S, N) -> y
    (B, S, D) in a's dtype.  ``h0`` (B, D, N) is the state before the
    first step (zeros when None); with ``return_state`` the result is
    ``(y, h_last)``, h_last (B, D, N) float32 after the last step."""
    bsz, s, d, n = a.shape
    f32 = torch.float32
    h = (torch.zeros((bsz, d, n), dtype=f32, device=a.device) if h0 is None
         else h0.to(f32))
    a32, b32, c32 = a.to(f32), b.to(f32), c.to(f32)
    ys = []
    for t in range(s):
        h = a32[:, t] * h + b32[:, t]
        ys.append(torch.matmul(h, c32[:, t, :, None])[..., 0])
    y = (torch.stack(ys, dim=1) if ys
         else a32.new_zeros((bsz, 0, d))).to(a.dtype)
    return (y, h) if return_state else y
