"""LR schedules (port of ``repro/optim/schedule.py``): float32 tensor math,
as ``jnp`` computes it."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int = 100, total: int = 10_000,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to min_frac.  Returns an lr *scale*,
    a float32 scalar tensor on ``step``'s device (the CPU for an int).
    Divisions are tensor by tensor: on the card, a tensor divided by a
    Python number is a multiply by its reciprocal, not IEEE division."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / torch.full_like(step, max(warmup, 1)), max=1.0)
    prog = torch.clamp((step - warmup) / torch.full_like(step, max(total - warmup, 1)), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
