"""Attention: GQA + RoPE (+ QKV bias) — twin of ``repro.models.attention``.

Five implementations behind one switch (``impl``):
  * "plain"   — dense masked attention written here (the twin of "xla");
  * "chunked" — online softmax over KV chunks in plain torch: O(S·chunk)
                memory; with ``remat_chunk`` each chunk is recomputed in
                the backward pass.  On the card, a call of MLA's dims (q/k
                192, v 128) in bf16 with no prefix mask and no autograd
                recording runs the same online softmax as one launch of
                the hand-written kernel ``kernels/csrc/mla_attention.cu``
                (:func:`repro_torch.kernels.mla_attention.takes`); the
                loop stays on the CPU, in f32, under autograd and at other
                head dims;
  * "kernel"  — the hand-written CUDA flash-attention kernel through
                ``kernels.ops.attention`` (the twin of "pallas"), or for
                the calls the MLA kernel takes, that kernel; CUDA tensors
                only, and it raises for a prefix-LM mask;
  * "stub"    — the reference's flash-substitution measurement stub: the
                mean of V over the sequence, plus 1e-6 of q's mean over
                its head dim, at every query row (attention's shapes at
                negligible work; it launches no kernel);
  * "auto"    — "kernel" for a flash call on CUDA tensors (q, k and v of
                one head dim, no prefix mask), "plain" otherwise: on the
                CPU, for MLA's q/k of nope + rope with v of
                ``v_head_dim``, and for a prefix-LM mask.  A head dim the
                kernel is not built for stays "kernel" and raises.
MLA (DeepSeek-V2's low-rank KV compression) is at the end of the file.

Decode (one query token against a cache) is a separate path: the
reference keeps it always-XLA, a matrix-vector product per head bound by
streaming the cache.  Here it goes through ``kernels.ops.decode_attention``:
on CUDA tensors the hand-written kernel, which reads the cache in place and
only each row's live positions; on the CPU the plain masked attend.  It
reads no tensor value on the host (the lengths are device tensors), so the
serve engine captures it into a CUDA graph (``core/graphs.py``).

Parameters ``p`` are one layer's attention weights as a mapping
(``p["wq"]`` …), the reference's tree; projections cast each weight to the
activations' dtype at use.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.kernels import mla_attention as kmla
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.config import ModelConfig
from repro_torch.core import trace
from repro_torch.models.layers import apply_rope, rms_norm, yarn_mscale

NEG_INF = -1e30
IMPLS = ("plain", "chunked", "kernel", "stub", "auto")

Params = Mapping[str, torch.Tensor]


def kernel_takes(q: torch.Tensor, k: Optional[torch.Tensor] = None,
                 v: Optional[torch.Tensor] = None,
                 prefix_len: int = 0) -> bool:
    """Whether this is a flash-kernel call: q, k and v of one head dim and
    no prefix mask (the device aside).  The reference's kernel never runs
    MLA's split dims or a prefix mask; any single head dim it does run, so
    one outside the port's ``HEAD_DIMS`` is still the kernel's call (and
    the kernel's wrapper raises for it rather than going plain unseen)."""
    d = q.shape[-1]
    return (not prefix_len
            and all(t is None or t.shape[-1] == d for t in (k, v)))


def resolve_impl(impl: str, q: torch.Tensor,
                 k: Optional[torch.Tensor] = None,
                 v: Optional[torch.Tensor] = None,
                 prefix_len: int = 0) -> str:
    """``impl`` with "auto" decided: "kernel" for a flash call on CUDA
    tensors (:func:`kernel_takes`), else "plain"; "kernel", chosen or
    resolved, raises where the kernel refuses the shapes."""
    if impl not in IMPLS:
        raise ValueError(f"attn impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return ("kernel" if q.is_cuda and kernel_takes(q, k, v, prefix_len)
                else "plain")
    return impl


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1).transpose(1, 2)     # (B, H, S, d)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _repeat_kv(k: torch.Tensor, v: torch.Tensor,
               hq: int) -> Tuple[torch.Tensor, torch.Tensor]:
    hkv = k.shape[1]
    if hq == hkv:
        return k, v
    return (k.repeat_interleave(hq // hkv, dim=1),
            v.repeat_interleave(hq // hkv, dim=1))


def _stub_attention(q, v) -> torch.Tensor:
    """The reference's measurement stub (``multihead_attention(impl=
    "stub")``): the mean of v over the sequence plus 1e-6 × the mean of q
    (in v's dtype) over its head dim, broadcast to q's rows with v's head
    dim, in q's dtype.  It keeps attention's shapes at negligible work, so
    a run with it measures everything but attention."""
    o = v.mean(dim=2, keepdim=True) + 1e-6 * q.to(v.dtype).mean(
        dim=-1, keepdim=True)
    return o.expand(*q.shape[:3], v.shape[-1]).to(q.dtype)


def _chunk_step(m, l, acc, q32, kb, vb, start: int, skv: int,
                prefix_len: int):
    """One KV chunk of the online softmax: the carry ``(m, l, acc)`` updated
    with keys ``kb`` and values ``vb`` from column ``start`` on."""
    sq = q32.shape[2]
    kb = kb.to(torch.float32)
    vb = vb.to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q32, kb)
    allowed = kref.causal_mask(sq, skv, q32.device, prefix_len=prefix_len,
                               start=start, width=kb.shape[2])
    s = s.masked_fill(~allowed[None, None], NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vb)
    return m_new, l, acc


def _chunked_attention(q, k, v, *, prefix_len: int, chunk: int = 512,
                       remat_chunk: bool = False,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Online softmax over KV chunks (flash attention in plain torch).

    k and v may have different head dims (MLA: qk = nope + rope, v =
    ``v_head_dim``).  A last chunk shorter than ``chunk`` is sliced short.

    ``remat_chunk`` — when autograd records the call, each chunk's body is
    recomputed in the backward pass (``torch.utils.checkpoint``,
    non-reentrant, so it nests inside the layer's remat) instead of saving
    its (B, H, Sq, chunk) score and probability tiles: only the carry, the
    scaled q and the chunk's K/V are kept, O(S) in place of O(S²/chunk) a
    chunk, for about one more forward of the chunks.  The body draws no
    random numbers, so the RNG state is not stashed.  The forward's result
    is the same bits either way.  ``scale`` replaces 1/sqrt(d) (MLA's
    YaRN factor)."""
    b, h, sq, d = q.shape
    dv = v.shape[-1]
    skv = k.shape[2]
    q32 = (q.to(torch.float32) / (d ** 0.5) if scale is None
           else q.to(torch.float32) * scale)
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    remat = (remat_chunk and torch.is_grad_enabled()
             and any(t.requires_grad for t in (q, k, v)))
    for start in range(0, skv, chunk):
        kb = k[:, :, start:start + chunk]
        vb = v[:, :, start:start + chunk]
        if remat:
            m, l, acc = torch.utils.checkpoint.checkpoint(
                _chunk_step, m, l, acc, q32, kb, vb, start, skv, prefix_len,
                use_reentrant=False, preserve_rng_state=False)
        else:
            m, l, acc = _chunk_step(m, l, acc, q32, kb, vb, start, skv,
                                    prefix_len)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l).to(q.dtype)


def multihead_attention(
    q: torch.Tensor,          # (B, Hq, Sq, d)
    k: torch.Tensor,          # (B, Hkv, Skv, d)
    v: torch.Tensor,
    *,
    impl: str = "auto",
    prefix_len: int = 0,
    chunk: int = 512,
    remat_chunk: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``scale``, the softmax's, is 1/sqrt(d) when None (every path); the
    plain and chunked paths and the MLA kernel take another (MLA under
    YaRN).  "chunked" and "kernel" run the MLA kernel for the calls it
    takes (:func:`repro_torch.kernels.mla_attention.takes`)."""
    impl = resolve_impl(impl, q, k, v, prefix_len)
    if impl in ("chunked", "kernel") and kmla.takes(q, k, v, prefix_len):
        return kops.mla_attention(q, k, v, scale=scale, impl="kernel")
    if impl == "kernel":
        if prefix_len:
            raise NotImplementedError("prefix-LM uses plain/chunked")
        if scale is not None:
            raise NotImplementedError("the kernel scales by 1/sqrt(d); "
                                      "another scale uses plain/chunked")
        # the kernel indexes KV head h // rep: nothing is repeated
        return kops.attention(q, k, v, causal=True, impl="kernel")
    k, v = _repeat_kv(k, v, q.shape[1])
    if impl == "stub":
        return _stub_attention(q, v)
    if impl == "chunked":
        return _chunked_attention(q, k, v, prefix_len=prefix_len, chunk=chunk,
                                  remat_chunk=remat_chunk, scale=scale)
    mask = kref.causal_mask(q.shape[2], k.shape[2], q.device,
                            prefix_len=prefix_len)
    return kref.masked_attention(q, k, v, mask, scale)


# ---------------------------------------------------------------------------
# GQA block (dense and MoE families)
# ---------------------------------------------------------------------------


def gqa_project(x, p: Params, cfg: ModelConfig, positions):
    """x -> rotated q, k, v with head split.  p: this layer's attn params."""
    dt = x.dtype
    q = torch.matmul(x, p["wq"].to(dt))
    k = torch.matmul(x, p["wk"].to(dt))
    v = torch.matmul(x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = _split_heads(q, cfg.n_heads)
    k = _split_heads(k, cfg.n_kv_heads)
    v = _split_heads(v, cfg.n_kv_heads)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions[:, None], cfg.rope_theta)
        k = apply_rope(k, positions[:, None], cfg.rope_theta)
    return q, k, v


def gqa_attention(x, p: Params, cfg: ModelConfig, positions, *,
                  impl: str = "auto", prefix_len: int = 0,
                  chunk: int = 512, remat_chunk: bool = False
                  ) -> torch.Tensor:
    q, k, v = gqa_project(x, p, cfg, positions)
    o = multihead_attention(q, k, v, impl=impl, prefix_len=prefix_len,
                            chunk=chunk, remat_chunk=remat_chunk)
    return torch.matmul(_merge_heads(o), p["wo"].to(x.dtype))


def _decode_attend(q, k_cache, v_cache, lengths, cfg: ModelConfig
                   ) -> torch.Tensor:
    """One query token per row against the cache as stored, in f32.

    q (B, Hq, 1, d); k_cache, v_cache (B, Smax, Hkv*d); row b attends
    positions [0, lengths[b]).  Query heads are grouped by their KV head
    (the same products as repeating the KV heads, without the copy)."""
    b, hq, _, d = q.shape
    o = kops.decode_attention(q.reshape(b, hq, d), k_cache, v_cache, lengths,
                              scale=1.0 / cfg.head_dim ** 0.5)
    return o.reshape(b, hq, 1, d)


def gqa_decode(x, p: Params, cfg: ModelConfig, k_cache, v_cache, pos):
    """One-token decode: write the caches at `pos`, attend over
    ``cache[:, :pos+1]``, as the reference does.

    ``pos`` is a device int32 scalar (or a Python int): the row is written
    with a device-side index op and every row attends ``pos + 1``
    positions, so no shape depends on it and nothing is read on the host —
    the body a CUDA graph captures once per cache length.
    k_cache/v_cache: (B, Smax, Hkv*dh), updated in place (the reference
    returns new arrays; the port writes the one cell).  Returns (out,
    k_cache, v_cache)."""
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    positions = pos.expand(b, 1)
    q, k, v = gqa_project(x, p, cfg, positions)            # (B,H,1,d)
    idx = pos.to(torch.long).reshape(1)
    k_cache.index_copy_(1, idx, _merge_heads(k).to(k_cache.dtype))
    v_cache.index_copy_(1, idx, _merge_heads(v).to(v_cache.dtype))
    o = _decode_attend(q, k_cache, v_cache, (pos + 1).expand(b), cfg)
    out = torch.matmul(_merge_heads(o), p["wo"].to(x.dtype))
    return out, k_cache, v_cache


def gqa_decode_ragged(x, p: Params, cfg: ModelConfig, k_cache, v_cache,
                      pos_b: torch.Tensor):
    """One-token decode with a *per-row* position (continuous batching).

    ``pos_b``: (B,) integer tensor — row b's cache is written at
    ``pos_b[b]`` and attended over ``cache[b, :pos_b[b]+1]``; RoPE uses each
    row's own position.  k_cache/v_cache: (B, Smax, Hkv*dh), updated in
    place."""
    b = x.shape[0]
    positions = pos_b[:, None]                              # (B, 1)
    q, k, v = gqa_project(x, p, cfg, positions)             # (B,H,1,d)
    rows = torch.arange(b, device=x.device)
    idx = pos_b.to(torch.long)
    k_cache[rows, idx] = _merge_heads(k)[:, 0].to(k_cache.dtype)
    v_cache[rows, idx] = _merge_heads(v)[:, 0].to(v_cache.dtype)
    o = _decode_attend(q, k_cache, v_cache, (pos_b + 1).to(torch.int32),
                       cfg)
    out = torch.matmul(_merge_heads(o), p["wo"].to(x.dtype))
    return out, k_cache, v_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank KV compression; the cache stores only
# (c_kv, k_rope) — kv_lora_rank + rope_dim per token instead of 2·H·d.
# ---------------------------------------------------------------------------


def mla_project_q(x, p: Params, cfg: ModelConfig, positions):
    """x -> (q_nope, q_rope rotated), each (B, H, S, ·)."""
    m = cfg.mla
    q = torch.matmul(x, p["wq"].to(x.dtype))
    q = q.reshape(x.shape[0], x.shape[1], cfg.n_heads,
                  m.qk_nope_head_dim + m.qk_rope_head_dim).transpose(1, 2)
    q_nope, q_rope = torch.split(
        q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions[:, None], cfg.rope_theta,
                        cfg.rope_scaling)
    return q_nope, q_rope


def mla_compress_kv(x, p: Params, cfg: ModelConfig, positions):
    """x -> (c_kv normed (B, S, rank), k_rope rotated (B, 1, S, rope)):
    exactly what the MLA cache stores."""
    m = cfg.mla
    ckv = torch.matmul(x, p["wdkv"].to(x.dtype))
    c, k_rope = torch.split(ckv, [m.kv_lora_rank, m.qk_rope_head_dim],
                            dim=-1)
    c = rms_norm(c, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, None], positions[:, None], cfg.rope_theta,
                        cfg.rope_scaling)
    return c, k_rope


def mla_scale(cfg: ModelConfig) -> Optional[float]:
    """MLA's softmax scale: None (the plain 1/sqrt(nope + rope)) or, under
    YaRN with an ``mscale_all_dim``, that times m(factor,
    mscale_all_dim)²."""
    m, rs = cfg.mla, cfg.rope_scaling
    if rs is None or not rs.mscale_all_dim:
        return None
    return ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
            * yarn_mscale(rs.factor, rs.mscale_all_dim) ** 2)


def mla_attention(x, p: Params, cfg: ModelConfig, positions, *,
                  impl: str = "auto", c=None, k_rope=None,
                  chunk: int = 512, remat_chunk: bool = False
                  ) -> torch.Tensor:
    """Full-sequence MLA attention (``c``/``k_rope`` may be precomputed, as
    prefill does).  q and k have head dim nope + rope and v ``v_head_dim``,
    so "auto" resolves to "plain" (the flash kernel takes one head dim);
    "chunked" runs the MLA kernel where it takes the call (bf16 on the
    card at 192/128, no autograd).  Under YaRN the softmax scale is
    :func:`mla_scale`'s.  The attention itself is the span ``mla.attend``
    (device time on the card)."""
    m = cfg.mla
    dt = x.dtype
    b = x.shape[0]
    if c is None:
        c, k_rope = mla_compress_kv(x, p, cfg, positions)
    q_nope, q_rope = mla_project_q(x, p, cfg, positions)
    k_nope = _split_heads(torch.matmul(c, p["wuk"].to(dt)), cfg.n_heads)
    v = _split_heads(torch.matmul(c, p["wuv"].to(dt)), cfg.n_heads)
    k_rope_b = k_rope.expand(b, cfg.n_heads, k_rope.shape[2],
                             m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    with trace.span("mla.attend", device=x.is_cuda):
        o = multihead_attention(q, k, v, impl=impl, chunk=chunk,
                                remat_chunk=remat_chunk,
                                scale=mla_scale(cfg))
    return torch.matmul(_merge_heads(o), p["wo"].to(dt))


def mla_decode(x, p: Params, cfg: ModelConfig, c_cache, rope_cache, pos):
    """One-token MLA decode against the compressed cache: ``wuk`` absorbed
    into q, ``wuv`` applied after the softmax, the scale :func:`mla_scale`
    as in the full-sequence path.

    c_cache (B, Smax, rank), rope_cache (B, Smax, rope), written in place
    at ``pos`` (a device int32 scalar or a Python int) and attended over
    their whole length with the columns past ``pos`` masked, as
    :func:`gqa_decode` does.  Returns (out, c_cache, rope_cache)."""
    m = cfg.mla
    dt = x.dtype
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    positions = pos.expand(b, 1)
    c_new, k_rope_new = mla_compress_kv(x, p, cfg, positions)
    idx = pos.to(torch.long).reshape(1)
    c_cache.index_copy_(1, idx, c_new.to(c_cache.dtype))
    rope_cache.index_copy_(1, idx, k_rope_new[:, 0].to(rope_cache.dtype))
    q_nope, q_rope = mla_project_q(x, p, cfg, positions)   # (B,H,1,·)

    # score = (q_nope·wukᵀ)·c + q_rope·k_rope
    wuk = p["wuk"].to(dt).reshape(m.kv_lora_rank, cfg.n_heads,
                                  m.qk_nope_head_dim)
    q_c = torch.einsum("bhqn,rhn->bhqr", q_nope, wuk)      # (B,H,1,rank)
    c32 = c_cache.to(torch.float32)
    s = torch.einsum("bhqr,bsr->bhqs", q_c.to(torch.float32), c32)
    s = s + torch.einsum("bhqn,bsn->bhqs", q_rope.to(torch.float32),
                         rope_cache.to(torch.float32))
    scale = mla_scale(cfg)
    s = (s / ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5)
         if scale is None else s * scale)
    valid = torch.arange(c_cache.shape[1], device=x.device) <= pos
    s = s.masked_fill(~valid[None, None, None, :], NEG_INF)
    o_c = torch.einsum("bhqs,bsr->bhqr", torch.softmax(s, dim=-1), c32)
    wuv = p["wuv"].to(dt).reshape(m.kv_lora_rank, cfg.n_heads, m.v_head_dim)
    o = torch.einsum("bhqr,rhn->bhqn", o_c.to(dt), wuv)   # (B,H,1,v)
    out = torch.matmul(_merge_heads(o), p["wo"].to(dt))
    return out, c_cache, rope_cache
