"""LR schedules as functions of the step counter (``repro/optim/schedule.py``)."""

from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, peak_lr: float, warmup: int = 100, total: int = 10_000,
                  floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine down
    to ``floor_frac * peak_lr`` at ``total``; float32, as in JAX.  ``step`` is
    an int or a tensor (the result lives on its device)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * s / max(warmup, 1)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos)


__all__ = ["cosine_warmup"]
