"""AdamW with decoupled weight decay and global-norm clipping — twin of
``repro.optim.adamw``.

The reference works on a pytree; the port works on named parameters (an
``nn.Module``'s ``named_parameters()`` or any mapping of names to tensors).
Its state is ``{"mu": {name: tensor}, "nu": {name: tensor}, "count"}``,
``count`` an int32 scalar on the parameters' device, and the bias
corrections are float32 tensors of it, as the reference computes them:
nothing is read on the host.  ``adamw_update`` writes the parameters and
the state in place (the reference's donated buffers).

Weight decay goes to the leaves the reference decays: those whose *stacked*
rank is at least 2 (``repro.optim.adamw`` tests ``p.ndim >= 2`` on a tree
whose layer leaves carry a leading L axis).  A per-layer tensor of the
port (``layers.<i>.…``, the reference's ``layers/…`` stacked over L) counts
one rank more than it has, so its norms and biases are decayed, as the
reference's (L, d) leaves are; the top-level ``final_norm`` and the
hybrid's unstacked ``shared_block`` norms are not (:func:`decays`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Tuple, Union

import torch
from torch import nn

Named = Union[nn.Module, Mapping[str, torch.Tensor]]
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0         # 0 disables clipping
    moment_dtype: str = "float32"


def _named(params: Named) -> Dict[str, torch.Tensor]:
    """The parameters of a module (``named_parameters()``) or a mapping, as
    a dict of names to tensors."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether AdamW decays ``name``: the rank of the reference's leaf is at
    least 2, a per-layer leaf (``layers.<i>.…``) counting its L axis."""
    return p.ndim + name.startswith("layers.") >= 2


def adamw_init(params: Named, cfg: AdamWConfig = AdamWConfig()
               ) -> Dict[str, object]:
    params = _named(params)
    dt = getattr(torch, cfg.moment_dtype)
    device = next(iter(params.values())).device if params else None
    return {
        "mu": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
               for n, p in params.items()},
        "nu": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
               for n, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def _values(tree) -> Iterable[torch.Tensor]:
    return tree.values() if isinstance(tree, Mapping) else tree


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ g²) over every tensor of ``tree`` (a mapping or a sequence),
    in float32."""
    leaves = [torch.sum(torch.square(g.to(_F32))) for g in _values(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: Dict[str, object],
                 params: Named, lr, cfg: AdamWConfig = AdamWConfig()
                 ) -> Tuple[Named, Dict[str, object], Dict[str, torch.Tensor]]:
    """One AdamW step, in place -> (params, state, {"grad_norm"}).

    ``grads`` maps every parameter's name to its gradient; ``lr`` is a
    float32 scalar (a tensor from a schedule, or a number)."""
    tensors = _named(params)
    count = state["count"]
    count.add_(1)
    gnorm = global_norm(grads[n] for n in tensors)
    scale = None
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** count.to(_F32)
    c2 = 1.0 - b2 ** count.to(_F32)
    lr = torch.as_tensor(lr, dtype=_F32, device=count.device)
    for name, p in tensors.items():
        g = grads[name]
        if scale is not None:
            g = g * scale.to(g.dtype)
        g32 = g.to(_F32)
        mu, nu = state["mu"][name], state["nu"][name]
        m = b1 * mu.to(_F32) + (1 - b1) * g32
        v = b2 * nu.to(_F32) + (1 - b2) * g32 * g32
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if cfg.weight_decay > 0 and decays(name, p):
            step = step + cfg.weight_decay * p.to(_F32)
        p.copy_(p.to(_F32) - lr * step)
        mu.copy_(m)
        nu.copy_(v)
    return params, state, {"grad_norm": gnorm}
