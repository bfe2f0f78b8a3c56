"""Optimizer substrate (plain PyTorch, no ``torch.optim``): AdamW,
schedules and clipping — twin of ``repro.optim``."""

from repro_torch.optim.adamw import (
    AdamWConfig, adamw_init, adamw_update, decays, global_norm,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "decays", "global_norm",
    "cosine_schedule", "linear_warmup_cosine",
]
