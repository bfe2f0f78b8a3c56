"""MLA's prefill attention on Hopper: softmax(scale · q kᵀ + causal) v with
q and k of head dim 192 and v of 128 (DeepSeek-V2's nope 128 + rope 64, and
its ``v_head_dim``).

Launch wrapper of ``csrc/mla_attention.cu``.  The kernel replaces no Pallas
TPU kernel: the reference runs MLA's attention through XLA
(``repro.models.attention._chunked_attention``), and on the card this
kernel takes over the port's twin of that loop for the calls
:func:`takes` admits (``models.attention.multihead_attention``).

``q`` is (B, H, Sq, 192), ``k`` (B, H, Skv, 192), ``v`` (B, H, Skv, 128),
all bf16; the output is (B, H, Sq, 128) in bf16.  The causal mask is
aligned bottom-right, as the flash kernel's and the model's; a row that
sees no column (Sq > Skv) gives the mean of V, as the plain version
(``ref.masked_attention``) does.
``scale`` is the softmax's, 1/sqrt(192) when None.  Scores and softmax
statistics are f32; P enters P·V as a bf16 head and a bf16 tail, so it
keeps about 16 significant bits.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build as _b

__all__ = ["HEAD_DIMS", "mla_attention", "takes"]

KERNEL = _b.KERNELS["mla_attention"]
#: the head dims the kernel is built for: (q and k, v)
HEAD_DIMS = (192, 128)
#: query rows a CTA
BQ = 128
#: CTAs a launch: its grid is flat, and a grid's x holds 2^31 - 1
MAX_CTAS = 2 ** 31 - 1


def _scale(scale: Optional[float]) -> float:
    return HEAD_DIMS[0] ** -0.5 if scale is None else float(scale)


def _ctas(b: int, h: int, sq: int) -> int:
    return b * h * -(-sq // BQ)


def takes(q, k, v, prefix_len: int = 0) -> bool:
    """Whether the kernel computes this call: q and k of head dim 192 and v
    of 128, one head count, bf16 on the card, no prefix mask, no autograd
    recording (the kernel has no backward), and a grid of at most
    ``MAX_CTAS``.  It reads only the tensors' shapes, dtypes, devices and
    ``requires_grad``."""
    dq, dv = HEAD_DIMS
    return (not prefix_len and q.is_cuda
            and all(t.dtype == torch.bfloat16 for t in (q, k, v))
            and q.shape[-1] == k.shape[-1] == dq and v.shape[-1] == dv
            and q.shape[1] == k.shape[1] == v.shape[1]
            and _ctas(*q.shape[:3]) <= MAX_CTAS
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in (q, k, v))))


def mla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: Optional[float] = None) -> torch.Tensor:
    """The kernel on CUDA tensors (raises for anything else)."""
    _b.refuse_grad("mla_attention", q, k, v)
    dq, dv = HEAD_DIMS
    if (q.ndim != 4 or k.ndim != 4 or v.ndim != 4
            or q.shape[:2] != k.shape[:2] or k.shape[:3] != v.shape[:3]
            or q.shape[3] != dq or k.shape[3] != dq or v.shape[3] != dv):
        raise ValueError(
            f"mla_attention shapes q={tuple(q.shape)} k={tuple(k.shape)} "
            f"v={tuple(v.shape)}: q (B, H, Sq, {dq}), k (B, H, Skv, {dq}), "
            f"v (B, H, Skv, {dv})")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"mla_attention takes bfloat16, got {t.dtype}")
    _b.check_inputs("mla_attention", q, k, v)
    b, h, sq, _ = q.shape
    if _ctas(b, h, sq) > MAX_CTAS:
        raise ValueError(f"mla_attention: B*H*ceil(Sq/{BQ}) = "
                         f"{_ctas(b, h, sq)} > {MAX_CTAS}")
    if k.shape[2] == 0:    # the plain version has no softmax over no column
        raise ValueError("mla_attention needs at least one KV column")
    s = _scale(scale)
    if not s > 0 or s == float("inf"):
        raise ValueError(f"mla_attention: scale {s} is not positive and "
                         f"finite")
    o = q.new_empty((b, h, sq, dv))
    if o.numel() == 0:
        return o
    q, k, v = (_b.aligned(t) for t in (q, k, v))
    _b.launch("mla_attention", "repro_mla_attention", q, q.data_ptr(),
              k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, sq, k.shape[2],
              s)
    KERNEL.launches += 1
    return o
