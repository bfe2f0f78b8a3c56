"""Weights made from the seed, on the device, in a few large draws.

One flat float32 buffer is filled with N(0, 1) in chunks of ``CHUNK``
elements from one ``torch.Generator`` on the device, then each leaf, a view
of it, is scaled: a matrix by 1/sqrt(fan in), the embedding by
1/sqrt(d_model), a norm's gain to 1 + 0.1 N(0, 1), so that a norm that is
skipped or misapplied shows.  The same seed on the same device gives the
same bits, so the reference makes its own copy after the program's is
freed.  The leaves and their names are the architecture's
(``bench/arch/<architecture>.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from bench import arch

CHUNK = 1 << 30


def init_leaf(name: str, leaf: torch.Tensor) -> None:
    """Scale one leaf of N(0, 1) in place: a norm's gain to 1 + 0.1 N, the
    embedding by 1/sqrt(d_model), a matrix by 1/sqrt(fan in).  An
    architecture whose leaves need another rule gives ``init_leaf`` in its
    ``bench/arch`` module."""
    if leaf.dim() == 1:
        leaf.mul_(0.1).add_(1.0)
    elif name == "embed":
        leaf.mul_(leaf.shape[1] ** -0.5)
    else:
        leaf.mul_(leaf.shape[0] ** -0.5)


@torch.no_grad()
def make_weights(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``cfg``'s model, float32 views of one buffer on
    ``device``, drawn from ``seed``."""
    a = arch.load(cfg)
    shapes = a.leaf_shapes(cfg)
    init = getattr(a, "init_leaf", init_leaf)
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for start in range(0, total, CHUNK):
        flat[start:start + CHUNK].normal_(generator=gen)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape in shapes:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        at += n
        init(name, leaf)
        out[name] = leaf
    return out
