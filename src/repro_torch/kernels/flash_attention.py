"""Flash attention on Hopper: softmax(Q Kᵀ/√D) V with an online softmax.

Launch wrapper of ``csrc/flash_attention.cu``, which replaces the Pallas
TPU kernel ``repro.kernels.flash_attention``.  ``q`` is (B, Hq, Sq, D) and
``k``/``v`` are (B, Hkv, Skv, D) with Hq a multiple of Hkv: the kernel
reads KV head ``h // (Hq // Hkv)`` for query head ``h``, so GQA repeats
nothing in memory.  The causal mask is aligned bottom-right, as the plain
version (``plain`` = ``kernels.ref.attention``) and the model's mask have
it.  f32 or bf16 in, f32 softmax and accumulators, output in ``q``'s
dtype; head dims 32, 64, 80 and 128.  bf16 runs on the tensor cores
(wgmma fed by TMA), f32 on the CUDA cores.  A causal row that sees no
column (Sq > Skv) gives the mean of V, as the plain version does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import attention as plain

__all__ = ["HEAD_DIMS", "flash_attention", "plain", "qk_tile"]

KERNEL = _b.KERNELS["flash_attention"]
#: the head dims the kernel is built for (one template instance each)
HEAD_DIMS = (32, 64, 80, 128)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    _b.refuse_grad("flash_attention", q, k, v)
    if (q.ndim != 4 or k.ndim != 4 or k.shape != v.shape
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]
            or k.shape[1] < 1 or q.shape[1] % k.shape[1]):
        raise ValueError(f"flash_attention shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention head dim {d} not in {HEAD_DIMS}")
    code = _b.check_inputs("flash_attention", q, k, v)
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention takes {DTYPES}, got {q.dtype}")
    if b * hq > 65535:
        raise ValueError(f"flash_attention: B*Hq = {b * hq} > 65535")
    if skv == 0:     # the plain version has no softmax over no column
        raise ValueError("flash_attention needs at least one KV column")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    q, k, v = (_b.aligned(t) for t in (q, k, v))
    _b.launch("flash_attention", "repro_flash_attention", q, code,
              q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq,
              hkv, sq, skv, d, int(bool(causal)))
    KERNEL.launches += 1
    return o


def qk_tile(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """S = q · kᵀ in f32 for one (64, D) bf16 tile each, through the bf16
    kernel's TMA loads and wgmma descriptors: a check of the tensor-core
    path on its own (not counted as a launch of the attention kernel)."""
    _b.refuse_grad("qk_tile", q, k)
    if (q.shape != k.shape or q.ndim != 2 or q.shape[0] != 64
            or q.shape[1] not in HEAD_DIMS or q.dtype != torch.bfloat16):
        raise ValueError(f"qk_tile takes two (64, D) bf16 tiles, D in "
                         f"{HEAD_DIMS}; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} {q.dtype}")
    _b.check_inputs("qk_tile", q, k)
    q, k = _b.aligned(q), _b.aligned(k)
    s = torch.empty((64, 64), dtype=torch.float32, device=q.device)
    _b.launch("flash_attention qk_tile", "repro_flash_qk_tile", q,
              q.data_ptr(), k.data_ptr(), s.data_ptr(), q.shape[1])
    return s
