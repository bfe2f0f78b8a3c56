"""Learning-rate schedules (float32 scalar tensors of the step counter) —
twin of ``repro.optim.schedule``.

``step`` is an integer tensor on the device (or a Python int, taken as a
CPU tensor), so a schedule reads nothing on the host."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, *, base_lr: float, total_steps: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    t = torch.clamp(_f32(step) / max(1, total_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return base_lr * (final_frac + (1.0 - final_frac) * cos)


def linear_warmup_cosine(step, *, base_lr: float, warmup_steps: int,
                         total_steps: int, final_frac: float = 0.1
                         ) -> torch.Tensor:
    step = torch.as_tensor(step)
    warm = base_lr * (_f32(step) + 1.0) / max(1, warmup_steps)
    cos = cosine_schedule(
        step - warmup_steps, base_lr=base_lr,
        total_steps=max(1, total_steps - warmup_steps), final_frac=final_frac)
    return torch.where(step < warmup_steps, warm, cos)
