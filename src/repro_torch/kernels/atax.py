"""ATAX on Hopper: y = Aᵀ (A x) (PolyBench, paper §5.1).

Launch wrapper of ``csrc/atax.cu``, which replaces the Pallas TPU kernel
``repro.kernels.atax``.  ``a`` is (..., M, N) and ``x`` (..., N) with the
same leading batch axes.  The wrapper allocates the kernel's scratch: one
accumulator row of N per (batch, block), summed by the second pass.
``plain`` is the PyTorch version of the same function.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import atax as plain

__all__ = ["atax", "plain", "partial_blocks"]

KERNEL = _b.KERNELS["atax"]
ROWS = 8                 # rows per panel (csrc/atax.cu ROWS)
BLOCKS_PER_SM = 2


def partial_blocks(m: int, batch: int, sms: int) -> int:
    """Blocks per batch item: enough for ~2 blocks per SM over the whole
    batch, never more than there are row panels."""
    panels = -(-m // ROWS)
    return max(1, min(panels, -(-BLOCKS_PER_SM * sms // batch)))


def atax(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if a.ndim < 2 or x.ndim != a.ndim - 1 or a.shape[:-2] != x.shape[:-1] \
            or a.shape[-1] != x.shape[-1]:
        raise ValueError(f"atax shapes {tuple(a.shape)}, {tuple(x.shape)}")
    code = _b.check_inputs("atax", a, x)
    m, n = a.shape[-2:]
    batch = math.prod(a.shape[:-2])
    y = torch.empty(x.shape, dtype=a.dtype, device=a.device)
    if y.numel() == 0:
        return y
    if m == 0:
        return y.zero_()
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    g = partial_blocks(m, batch, sms)
    partial = torch.empty((batch, g, n), dtype=_b.acc_dtype(a.dtype),
                          device=a.device)
    _b.launch("atax", "repro_atax", a, code, a.data_ptr(), x.data_ptr(),
              partial.data_ptr(), y.data_ptr(), batch, m, n, g)
    KERNEL.launches += 1
    return y
