"""Decode attention on Hopper: one query token per row against the KV cache.

Launch wrapper of ``csrc/decode_attention.cu``.  The kernel replaces no
Pallas TPU kernel: the reference keeps its decode attention as plain XLA
(``repro.models.attention.gqa_decode_ragged`` and ``gqa_decode``), and this
kernel takes over that plain attend in the port's twins of both.

``q`` is (B, Hq, D) in f32 or bf16; ``k_cache`` and ``v_cache`` are the
cache as it is stored, (B, Smax, Hkv·D) in f32 or bf16, contiguous, read in
place; ``lengths`` is a (B,) int32 tensor: row b attends positions
``[0, min(lengths[b], Smax))``.  Query head h reads KV head h // (Hq // Hkv);
the kernel takes Hq // Hkv up to 8 and head dims 32, 64, 80, 128 and 256
(the plain version any).  Every product and sum is in f32; the output is
(B, Hq, D) in q's dtype.  Nothing is read on the host, so the call can be
captured into a CUDA graph once per cache length and replayed with new
lengths.

:func:`plan` picks the kernel's chunk of positions from the shapes, so that
short batches still fill the card.  ``plain`` is the PyTorch version of the
same function: the masked f32 attend the model's decode ran before, over
all Smax positions.  A row of length 0 has no softmax: the kernel writes
zeros there, the plain version the mean of V over the cache.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import build as _b

__all__ = ["HEAD_DIMS", "MAX_GROUP", "decode_attention", "plain", "plan",
           "tile", "validate"]

KERNEL = _b.KERNELS["decode_attention"]
#: the head dims the kernel is built for (one template instance each)
HEAD_DIMS = (32, 64, 80, 128, 256)
#: query heads a KV head (the group) the kernel holds at most
MAX_GROUP = 8
DTYPES = (torch.float32, torch.bfloat16)
NEG_INF = -1e30
#: the kernel's occupancy (csrc/decode_attention.cu: about 105 KB of shared
#: memory a CTA) and the waves of CTAs the plan aims for, so that the last
#: wave's ragged rows are a small part of the call
CTAS_PER_SM = 2
WAVES = 4
MAX_CHUNKS = 65535


def tile(d: int, dtype: torch.dtype) -> int:
    """Positions of a K/V tile in the kernel's ring (``Shape::TP``): 64
    rows up to 256 bytes, 32 up to 512, 16 past that."""
    row = d * dtype.itemsize
    return 64 if row <= 256 else 32 if row <= 512 else 16


def plan(b: int, hkv: int, smax: int, d: int, dtype: torch.dtype,
         sms: int) -> Tuple[int, int]:
    """``(chunk, chunks)``: the positions a CTA takes and how many chunks
    cover Smax, for a card of ``sms`` SMs.  Enough chunks that the B·Hkv
    rows give ``WAVES`` full waves of CTAs, never more than the tiles Smax
    holds; the chunk is a whole number of tiles (rounded down, so the
    chunks are at least that many, up to ``MAX_CHUNKS``)."""
    tp = tile(d, dtype)
    tiles = -(-smax // tp)
    want = -(-(WAVES * CTAS_PER_SM * sms) // max(1, b * hkv))
    chunks = max(1, min(want, tiles))
    chunk = max(tiles // chunks, -(-tiles // MAX_CHUNKS)) * tp
    return chunk, -(-smax // chunk)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def validate(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
             lengths: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """``(B, Hq, D, Smax, Hkv)`` of a call either version takes; raises
    ValueError for anything else: shapes, dtypes, a cache that is not
    contiguous.  The kernel's own limits (head dims, group) are
    :func:`decode_attention`'s."""
    if (q.ndim != 3 or k_cache.ndim != 3 or k_cache.shape != v_cache.shape
            or lengths.shape != (q.shape[0],)
            or k_cache.shape[0] != q.shape[0] or q.shape[2] < 1
            or k_cache.shape[2] % q.shape[2]
            or not 0 < k_cache.shape[2] // q.shape[2] <= q.shape[1]
            or q.shape[1] % (k_cache.shape[2] // q.shape[2])):
        raise ValueError(
            f"decode_attention shapes q={tuple(q.shape)} "
            f"k_cache={tuple(k_cache.shape)} v_cache={tuple(v_cache.shape)} "
            f"lengths={tuple(lengths.shape)}: q (B, Hq, D), caches (B, "
            f"Smax, Hkv·D) with Hq a multiple of Hkv, lengths (B,)")
    b, hq, d = q.shape
    smax, kvd = k_cache.shape[1], k_cache.shape[2]
    if smax < 1:
        raise ValueError("decode_attention needs at least one cache position")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype not in DTYPES:
            raise ValueError(f"decode_attention {name} takes {DTYPES}, "
                             f"got {t.dtype}")
    if v_cache.dtype != k_cache.dtype:
        raise ValueError(f"decode_attention: caches of {k_cache.dtype} and "
                         f"{v_cache.dtype}")
    if lengths.dtype != torch.int32:
        raise ValueError(f"decode_attention lengths are int32, got "
                         f"{lengths.dtype}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention reads the cache in place: "
                         "k_cache and v_cache must be contiguous")
    return b, hq, d, smax, kvd // d


def plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
          lengths: torch.Tensor, *, scale: float) -> torch.Tensor:
    """The masked f32 attend over the whole cache: query heads grouped by
    their KV head (the same products as repeating the KV heads, without the
    copy), columns at or past the row's length filled with -1e30."""
    b, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2] // d
    kk = k_cache.reshape(b, smax, hkv, d).transpose(1, 2)  # (B,Hkv,Smax,d)
    vv = v_cache.reshape(b, smax, hkv, d).transpose(1, 2)
    qg = q.to(torch.float32).reshape(b, hkv, hq // hkv, d)
    s = torch.einsum("bgrd,bgkd->bgrk", qg, kk.to(torch.float32))
    s = s * scale
    valid = (torch.arange(smax, device=q.device)[None, None, None, :]
             < lengths.to(q.device)[:, None, None, None])
    s = s.masked_fill(~valid, NEG_INF)
    o = torch.einsum("bgrk,bgkd->bgrd", torch.softmax(s, dim=-1),
                     vv.to(torch.float32))
    return o.reshape(b, hq, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: float) -> torch.Tensor:
    """The kernel on CUDA tensors (raises for anything else)."""
    _b.refuse_grad("decode_attention", q, k_cache, v_cache)
    b, hq, d, smax, hkv = validate(q, k_cache, v_cache, lengths)
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention head dim {d} not in {HEAD_DIMS}")
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: {hq // hkv} query heads a KV "
                         f"head, past the kernel's {MAX_GROUP}")
    q = q.contiguous()
    lengths = lengths.contiguous()
    code = _b.check_inputs("decode_attention", k_cache, v_cache)
    for t in (q, lengths):
        if t.device != k_cache.device:
            raise ValueError(f"decode_attention: tensors on {k_cache.device} "
                             f"and {t.device}")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention reads the cache in 16-byte "
                         "copies: a cache off a 16-byte boundary")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    chunk, chunks = plan(b, hkv, smax, d, k_cache.dtype,
                         _sms(k_cache.get_device()))
    g = hq // hkv
    f32 = dict(dtype=torch.float32, device=q.device)
    part_acc = torch.empty(b * hkv * chunks * g * d, **f32)
    part_ml = torch.empty(b * hkv * chunks * g * 2, **f32)
    _b.launch("decode_attention", "repro_decode_attention", q, code,
              _b.DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
              v_cache.data_ptr(), lengths.data_ptr(), part_acc.data_ptr(),
              part_ml.data_ptr(), out.data_ptr(), b, hq, hkv, smax, d, chunk,
              chunks, float(scale))
    KERNEL.launches += 1
    return out
