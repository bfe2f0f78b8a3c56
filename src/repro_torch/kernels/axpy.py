"""AXPY on Hopper: z = alpha * x + y (BLAS-1, paper §5.1).

Launch wrapper of ``csrc/axpy.cu``, which replaces the Pallas TPU kernel
``repro.kernels.axpy``.  ``x`` and ``y`` may carry leading batch axes (the
offload path passes clusters × fused jobs); the kernel sees them as one
vector laid end to end.  ``plain`` is the PyTorch version of the same
function.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import axpy as plain

__all__ = ["axpy", "plain"]

KERNEL = _b.KERNELS["axpy"]


def axpy(x: torch.Tensor, y: torch.Tensor, alpha: float) -> torch.Tensor:
    _b.refuse_grad("axpy", x, y)
    if x.shape != y.shape or x.ndim < 1:
        raise ValueError(f"axpy wants equal shapes, got {x.shape}, {y.shape}")
    code = _b.check_inputs("axpy", x, y)
    z = torch.empty_like(x)
    total = x.numel()
    if total == 0:
        return z
    _b.launch("axpy", "repro_axpy", x, code, x.data_ptr(), y.data_ptr(),
              z.data_ptr(), float(alpha), total)
    KERNEL.launches += 1
    return z
