"""Tiled matmul on Hopper: C = A @ B (BLAS-3, paper §5.1).

Launch wrapper of ``csrc/matmul.cu``, which replaces the Pallas TPU kernel
``repro.kernels.matmul``.  ``a`` is (..., M, K) and ``b`` (..., K, N) with
the same leading batch axes; the output takes ``a``'s dtype.  ``plain`` is
the PyTorch version of the same function.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import matmul as plain

__all__ = ["matmul", "plain"]

KERNEL = _b.KERNELS["matmul"]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _b.refuse_grad("matmul", a, b)
    if (a.ndim < 2 or b.ndim != a.ndim or a.shape[:-2] != b.shape[:-2]
            or a.shape[-1] != b.shape[-2]):
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    code = _b.check_inputs("matmul", a, b)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = math.prod(a.shape[:-2])
    c = torch.empty(a.shape[:-2] + (m, n), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    if k == 0:
        return c.zero_()
    _b.launch("matmul", "repro_matmul", a, code, a.data_ptr(), b.data_ptr(),
              c.data_ptr(), batch, m, n, k, m * k, k * n, m * n)
    KERNEL.launches += 1
    return c
