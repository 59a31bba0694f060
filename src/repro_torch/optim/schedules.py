"""Learning-rate schedules as step -> multiplier callables (a port of
``repro/optim/schedules.py``).

A schedule returns a float32 scalar tensor that multiplies the optimizer's
base lr; ``step`` is an int or an integer tensor.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant():
    return lambda step: torch.tensor(1.0, dtype=torch.float32)


def cosine_decay(total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return final_frac + (1.0 - final_frac) * cos
    return f


def linear_warmup_cosine(warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(max(total_steps - warmup_steps, 1), final_frac)

    def f(step):
        step = torch.as_tensor(step)
        warm = _f32(step) / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm,
                           cos(step - warmup_steps))
    return f
