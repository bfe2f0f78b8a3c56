"""Covariance on Hopper: cov = (X − μ)(X − μ)ᵀ / (N − 1) (PolyBench, §5.1).

Launch wrapper of ``csrc/covariance.cu``, which replaces the Pallas TPU
kernel ``repro.kernels.covariance``.  ``data`` is (..., M, N): M variables
of N samples, with leading batch axes; the result is (..., M, M).  The
mean pass is the first of the two kernels the wrapper launches; its
per-row means live in scratch the wrapper allocates.  ``plain`` is the
PyTorch version of the same function.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import covariance as plain

__all__ = ["covariance", "plain"]

KERNEL = _b.KERNELS["covariance"]


def covariance(data: torch.Tensor) -> torch.Tensor:
    _b.refuse_grad("covariance", data)
    if data.ndim < 2:
        raise ValueError(f"covariance wants (..., M, N), got {tuple(data.shape)}")
    m, n = data.shape[-2:]
    if n < 2:
        raise ValueError("need at least 2 samples")
    code = _b.check_inputs("covariance", data)
    batch = math.prod(data.shape[:-2])
    out = torch.empty(data.shape[:-2] + (m, m), dtype=data.dtype,
                      device=data.device)
    if out.numel() == 0:
        return out
    mean = torch.empty((batch, m), dtype=_b.acc_dtype(data.dtype),
                       device=data.device)
    _b.launch("covariance", "repro_covariance", data, code, data.data_ptr(),
              mean.data_ptr(), out.data_ptr(), batch, m, n)
    KERNEL.launches += 1
    return out
