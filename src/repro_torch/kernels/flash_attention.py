"""Flash attention on Hopper: softmax(Q Kᵀ/√D) V with an online softmax.

Launch wrapper of ``csrc/flash_attention.cu``, which replaces the Pallas
TPU kernel ``repro.kernels.flash_attention``.  ``q`` is (B, Hq, Sq, D) and
``k``/``v`` are (B, Hkv, Skv, D) with Hq a multiple of Hkv: the kernel
reads KV head ``h // (Hq // Hkv)`` for query head ``h``, so GQA repeats
nothing in memory.  The causal mask is aligned bottom-right, as the plain
version (``plain`` = ``kernels.ref.attention``) and the model's mask have
it.  f32 or bf16 in, f32 arithmetic, output in ``q``'s dtype; head dims
32, 64, 80 and 128.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import attention as plain

__all__ = ["HEAD_DIMS", "flash_attention", "plain"]

KERNEL = _b.KERNELS["flash_attention"]
#: the head dims the kernel is built for (one template instance each)
HEAD_DIMS = (32, 64, 80, 128)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
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
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = _b.library()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, hq, hkv, sq, skv, d, int(bool(causal)), _b.stream_of(q))
    _b.check_rc(rc, "flash_attention")
    KERNEL.launches += 1
    return o
