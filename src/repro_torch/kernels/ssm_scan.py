"""The SSM scan on Hopper: h_t = a_t ⊙ h_{t-1} + b_t, y_t = Σ_n h_t·c_t.

Launch wrapper of ``csrc/ssm_scan.cu``, which replaces the Pallas TPU
kernel ``repro.kernels.ssm_scan``.  ``a`` and ``b`` are (B, S, D, N), ``c``
is (B, S, N) and the result ``y`` is (B, S, D) in ``a``'s dtype; the state
is f32.  ``h0`` (B, D, N) f32 is the state before the first step (zeros
when None); with ``return_state`` the result is ``(y, h_last)``.  f32 or
bf16 in; N ∈ {8, 16, 32, 64}; any S ≥ 1 and D ≥ 1.  The plain version is
``plain`` = ``kernels.ref.ssm_scan``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import ssm_scan as plain

__all__ = ["STATE_SIZES", "plain", "ssm_scan"]

KERNEL = _b.KERNELS["ssm_scan"]
#: the state sizes N the kernel is built for (one template instance each)
STATE_SIZES = (8, 16, 32, 64)
DTYPES = (torch.float32, torch.bfloat16)


def ssm_scan(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
             h0: Optional[torch.Tensor] = None, return_state: bool = False):
    _b.refuse_grad("ssm_scan", a, b, c, h0)
    if (a.ndim != 4 or b.shape != a.shape or c.ndim != 3
            or tuple(c.shape) != (a.shape[0], a.shape[1], a.shape[3])):
        raise ValueError(f"ssm_scan shapes a={tuple(a.shape)} "
                         f"b={tuple(b.shape)} c={tuple(c.shape)}")
    bsz, s, d, n = a.shape
    if n not in STATE_SIZES:
        raise ValueError(f"ssm_scan state size {n} not in {STATE_SIZES}")
    code = _b.check_inputs("ssm_scan", a, b, c)
    if a.dtype not in DTYPES:
        raise ValueError(f"ssm_scan takes {DTYPES}, got {a.dtype}")
    if bsz > 65535:
        raise ValueError(f"ssm_scan: batch {bsz} > 65535")
    if h0 is not None:
        if (tuple(h0.shape) != (bsz, d, n) or h0.dtype != torch.float32
                or h0.device != a.device or not h0.is_contiguous()):
            raise ValueError(
                f"ssm_scan h0 must be a contiguous float32 ({bsz}, {d}, {n}) "
                f"tensor on {a.device}, got {h0.dtype} {tuple(h0.shape)} on "
                f"{h0.device}")
    if a.numel() == 0:
        raise ValueError(f"ssm_scan needs B, S, D >= 1, got {tuple(a.shape)}")
    y = torch.empty((bsz, s, d), dtype=a.dtype, device=a.device)
    h_last = (torch.empty((bsz, d, n), dtype=torch.float32, device=a.device)
              if return_state else None)
    _b.launch("ssm_scan", "repro_ssm_scan", a, code, a.data_ptr(),
              b.data_ptr(), c.data_ptr(),
              None if h0 is None else h0.data_ptr(), y.data_ptr(),
              None if h_last is None else h_last.data_ptr(), bsz, s, d, n)
    KERNEL.launches += 1
    return (y, h_last) if return_state else y
