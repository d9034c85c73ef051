"""Learning-rate schedules (plain callables step -> lr), as the JAX package's.

A schedule takes an int or a 0-d tensor step and returns a 0-d f32 tensor,
on the step's device when it is a tensor.
"""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "warmup_cosine", "warmup_linear"]

f32 = torch.float32


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(f32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=f32,
                                   device=torch.as_tensor(step).device)


def _warmup_then(peak: float, warmup: int, total: int, decay):
    def fn(step):
        s = _step(step)
        warm = peak * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return torch.where(s < warmup, warm, decay(frac))
    return fn


def warmup_linear(peak: float, warmup: int, total: int, floor: float = 0.0):
    return _warmup_then(peak, warmup, total,
                        lambda frac: peak + (floor - peak) * frac)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.0):
    return _warmup_then(
        peak, warmup, total,
        lambda frac: floor + 0.5 * (peak - floor)
        * (1.0 + torch.cos(math.pi * frac)))
