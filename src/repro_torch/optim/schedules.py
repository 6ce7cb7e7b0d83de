"""Learning-rate schedules: callables ``step -> lr`` (fp32 tensors).

The port of ``repro.optim.schedules``; ``step`` may be a Python number or
a tensor.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    """From ``lr`` down to ``final_frac·lr`` over ``total_steps``, then flat."""
    def f(step):
        t = torch.clamp(_f32(step) / max(1, total_steps), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.0):
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay
    to ``final_frac·lr`` at ``total_steps``."""
    def f(step):
        s = _f32(step)
        warm = lr * s / max(1, warmup_steps)
        t = torch.clamp((s - warmup_steps)
                        / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = lr * (final_frac
                    + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)
    return f
