"""Learning-rate schedules (pure functions of the step counter; twin of
`repro/optim/schedules.py`), in float32 as the reference computes them.
A schedule takes the step as an int or a tensor and returns a 0-d
float32 tensor on the step's device (the CPU for an int)."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(*, peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    def schedule(step):
        step = _f32(step)
        # divisors as tensors: a true division, as the reference's
        warm = peak * step / step.new_tensor(max(warmup_steps, 1))
        frac = (step - warmup_steps) / step.new_tensor(
            max(total_steps - warmup_steps, 1))
        frac = torch.clamp(frac, 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def constant(value: float):
    def schedule(step):
        return torch.tensor(value, dtype=torch.float32,
                            device=torch.as_tensor(step).device)
    return schedule
