"""Flash-kernel substitution — twin of ``repro.launch.flashsub``: the
roofline of a cell with the flash-attention kernel in place of the plain
attention path.

Method: the plain and chunked attention paths write every (B, H, Sq,
chunk) score and probability tile to memory — traffic and temporary
memory a flash kernel does not have (its tiles stay in shared memory and
registers).  The kernel has no backward and does not run on ``meta``
tensors, so its cell-level effect is modelled as:

    cell(flash) = cell(stub) + flash_kernel_terms

where ``cell(stub)`` is the same program counted with the shape- and
grad-preserving zero-cost attention stub (``attn_impl="stub"``: it
isolates the everything-but-attention cost, including the QKV/O
projections, the MLP, the optimizer and the collectives), and
``flash_kernel_terms`` are the kernel's analytic FLOPs and memory traffic
per the standard flash accounting:

    fwd  FLOPs = 2 · 2 · B·H·S²·dh · causal_frac      (QKᵀ + PV)
    bwd  FLOPs = 2.5 × fwd                             (dQ,dK,dV + recompute)
    remat fwd  = 1 × fwd                               (train-only recompute)
    HBM bytes  = passes · (3 reads + 1 write) · B·H·S·dh · dtype_bytes
                 (+ O(S) softmax stats, negligible)

Collective bytes are the stub count's (the kernel adds none).  The
numbers are analytic and do not depend on the card; ``substitute`` turns
them into times through this package's roofline, with the H100's
constants.  Every such number is "flash-substituted (modelled on the
counted stub)", never a count of the kernel's own run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.launch.roofline import Roofline
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class AttnShape:
    layers: int
    batch_global: int
    heads: int          # query heads
    head_dim: int       # qk head dim (v dim assumed equal for traffic)
    seq: int
    causal_frac: float = 0.5
    passes_flops: float = 4.5    # fwd(1) + remat(1) + bwd(2.5) — train
    passes_bytes: float = 3.0    # qkv+o streamed per pass
    dtype_bytes: int = 2


def attn_shape_for(cfg: ModelConfig, mode: str, seq: int, gbatch: int
                   ) -> Optional[AttnShape]:
    if cfg.family == "ssm":
        return None
    heads = cfg.n_heads
    hd = cfg.head_dim
    layers = cfg.n_layers
    if cfg.mla:
        hd = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
    if cfg.family == "hybrid":
        layers = cfg.n_layers // cfg.hybrid.period   # shared-block apps
        heads = cfg.hybrid.shared_attn_heads
        hd = cfg.d_model // heads
    if mode == "prefill":
        return AttnShape(layers, gbatch, heads, hd, seq,
                         passes_flops=1.0, passes_bytes=1.0)
    return AttnShape(layers, gbatch, heads, hd, seq)


def flash_terms(a: AttnShape, chips: int) -> Tuple[float, float]:
    """(flops_per_device, hbm_bytes_per_device) of the flash kernel."""
    fwd = 2.0 * 2.0 * a.batch_global * a.heads * a.seq ** 2 * a.head_dim \
        * a.causal_frac
    flops = fwd * a.passes_flops / chips
    stream = (4.0 * a.batch_global * a.heads * a.seq * a.head_dim
              * a.dtype_bytes)
    nbytes = stream * a.passes_bytes * max(1.0, a.passes_flops / 2) / chips
    return a.layers * flops, a.layers * nbytes


def substitute(stub_roof: Roofline, a: Optional[AttnShape]) -> Roofline:
    """Roofline of stub-cell + flash kernel terms."""
    if a is None:
        return stub_roof
    f, b = flash_terms(a, stub_roof.chips)
    return dataclasses.replace(
        stub_roof,
        flops=stub_roof.flops + f,
        bytes_accessed=stub_roof.bytes_accessed + b,
    )
