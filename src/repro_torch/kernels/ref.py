"""Plain PyTorch versions of the port's kernels — the twin of
``repro.kernels.ref``.

Each function computes what its hand-written kernel computes, in the same
accumulator type (float64 for float64 inputs, float32 otherwise), and
takes the same leading batch axes.  The CPU tests run them; on the card
``chip_smoke.py`` holds each kernel against them.  Nothing on the offload
path calls them for a CUDA tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import acc_dtype


def axpy(x: torch.Tensor, y: torch.Tensor, alpha: float) -> torch.Tensor:
    acc = acc_dtype(x.dtype)
    return (alpha * x.to(acc) + y.to(acc)).to(x.dtype)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    acc = acc_dtype(a.dtype)
    return torch.matmul(a.to(acc), b.to(acc)).to(a.dtype)


def atax(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    acc = acc_dtype(a.dtype)
    a_ = a.to(acc)
    tmp = torch.matmul(a_, x.to(acc).unsqueeze(-1))
    return torch.matmul(a_.mT, tmp).squeeze(-1).to(a.dtype)


def covariance(data: torch.Tensor) -> torch.Tensor:
    acc = acc_dtype(data.dtype)
    d = data.to(acc)
    centred = d - d.mean(dim=-1, keepdim=True)
    return (torch.matmul(centred, centred.mT) / (data.shape[-1] - 1)
            ).to(data.dtype)
