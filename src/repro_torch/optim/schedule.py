"""Learning-rate schedules (``repro.optim.schedule``).

``noam_schedule`` is the transformer schedule of the paper's model
(Vaswani et al. 2017 eq. 3): lr = scale * d_model^-0.5 *
min(t^-0.5, t * w^-1.5), in f32.  ``cosine_schedule`` ramps linearly to
``peak_lr`` over the warm-up, then decays along a half cosine to
``min_ratio * peak_lr`` at ``total_steps``; ``constant_schedule`` is one
rate.  Each takes the step as a tensor (or a Python int) and returns an
f32 scalar on its device.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def noam_schedule(d_model: int, warmup_steps: int = 4000, scale: float = 2.0):
    def lr(step) -> torch.Tensor:
        t = torch.clamp(_f32(step), min=1.0)
        return scale * d_model ** -0.5 * torch.minimum(
            t ** -0.5, t * warmup_steps ** -1.5)
    return lr


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    def lr(step) -> torch.Tensor:
        t = _f32(step)
        warm = peak_lr * t / max(warmup_steps, 1)
        frac = torch.clamp((t - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) *
                         0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(t < warmup_steps, warm, cos)
    return lr


def constant_schedule(lr_value: float):
    def lr(step) -> torch.Tensor:
        return torch.full((), lr_value, dtype=torch.float32,
                          device=_f32(step).device)
    return lr
