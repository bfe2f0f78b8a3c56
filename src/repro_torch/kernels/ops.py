"""Entry points for the port's kernels — the twin of ``repro.kernels.ops``.

Every op takes ``impl`` ∈ {"kernel", "plain", "auto"}:
  * "kernel" — the hand-written CUDA kernel; needs CUDA tensors and raises
               otherwise (a failed build or launch raises too);
  * "plain"  — the plain PyTorch version; CPU tensors only;
  * "auto"   — the kernel for a CUDA tensor, the plain version for a CPU
               tensor (the framework default).
A CUDA tensor never takes the plain path: there is no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.atax import atax as _atax_kernel
from repro_torch.kernels.axpy import axpy as _axpy_kernel
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels.covariance import covariance as _cov_kernel
from repro_torch.kernels.flash_attention import (
    flash_attention as _flash_kernel,
)
from repro_torch.kernels import mla_attention as _mla
from repro_torch.kernels.matmul import matmul as _matmul_kernel
from repro_torch.kernels.ssm_scan import ssm_scan as _ssm_kernel

IMPLS = ("kernel", "plain", "auto")


def _resolve(impl: str, t: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "kernel" if t.is_cuda else "plain"
    if impl == "kernel" and not t.is_cuda:
        raise RuntimeError(
            "impl='kernel' needs CUDA tensors (the kernels run only on the "
            f"card); got a tensor on {t.device}")
    if impl == "plain" and t.is_cuda:
        raise ValueError(
            "impl='plain' takes CPU tensors only; a CUDA tensor runs the kernel")
    return impl


def axpy(x, y, alpha, *, impl: str = "auto") -> torch.Tensor:
    if _resolve(impl, x) == "kernel":
        return _axpy_kernel(x.contiguous(), y.contiguous(), alpha)
    return ref.axpy(x, y, alpha)


def matmul(a, b, *, impl: str = "auto") -> torch.Tensor:
    if _resolve(impl, a) == "kernel":
        return _matmul_kernel(a.contiguous(), b.contiguous())
    return ref.matmul(a, b)


def atax(a, x, *, impl: str = "auto") -> torch.Tensor:
    if _resolve(impl, a) == "kernel":
        return _atax_kernel(a.contiguous(), x.contiguous())
    return ref.atax(a, x)


def covariance(data, *, impl: str = "auto") -> torch.Tensor:
    if _resolve(impl, data) == "kernel":
        return _cov_kernel(data.contiguous())
    return ref.covariance(data)


def attention(q, k, v, *, causal: bool = True,
              impl: str = "auto") -> torch.Tensor:
    """Multi-head attention with GQA support: k/v may have fewer heads than
    q (q heads must be a multiple).  The kernel indexes KV head
    ``h // rep`` and repeats nothing; the plain version repeats the heads.
    The causal mask is aligned bottom-right (``kernels.ref.attention``)."""
    hq, hkv = q.shape[1], k.shape[1]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"GQA heads {hq} not a multiple of {hkv}")
    if _resolve(impl, q) == "kernel":
        return _flash_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=causal)
    return ref.attention(q, k, v, causal=causal)


def mla_attention(q, k, v, *, scale=None, impl: str = "auto"
                  ) -> torch.Tensor:
    """MLA's causal attention: q and k of head dim 192, v of 128, one head
    count, bf16 for the kernel; the mask aligned bottom-right, scores times
    ``scale`` (1/sqrt(192) when None) (``kernels.mla_attention``)."""
    if _resolve(impl, q) == "kernel":
        return _mla.mla_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), scale=scale)
    return ref.masked_attention(
        q, k, v, ref.causal_mask(q.shape[2], k.shape[2], q.device), scale)


def decode_attention(q, k_cache, v_cache, lengths, *, scale: float,
                     impl: str = "auto") -> torch.Tensor:
    """One query token per row against the KV cache, grouped query heads:
    q (B, Hq, D), k_cache/v_cache (B, Smax, Hkv·D) as stored (contiguous,
    read in place), lengths (B,) int32 -> (B, Hq, D) in q's dtype; row b
    attends positions [0, min(lengths[b], Smax)), scores times ``scale``
    (``kernels.decode_attention``)."""
    if _resolve(impl, q) == "kernel":
        return _decode.decode_attention(q, k_cache, v_cache, lengths,
                                        scale=scale)
    _decode.validate(q, k_cache, v_cache, lengths)
    return _decode.plain(q, k_cache, v_cache, lengths, scale=scale)


def ssm_scan(a, b, c, *, h0=None, return_state: bool = False,
             impl: str = "auto"):
    """The SSM scan h_t = a_t⊙h_{t-1} + b_t, y_t = Σ_n h_t[:, n]·c_t[n]:
    a, b (B, S, D, N), c (B, S, N) -> y (B, S, D), or ``(y, h_last)`` with
    ``return_state``; ``h0`` (B, D, N) f32 starts the state
    (``kernels.ref.ssm_scan``)."""
    if _resolve(impl, a) == "kernel":
        return _ssm_kernel(
            a.contiguous(), b.contiguous(), c.contiguous(),
            h0=None if h0 is None else h0.to(torch.float32).contiguous(),
            return_state=return_state)
    return ref.ssm_scan(a, b, c, h0=h0, return_state=return_state)
