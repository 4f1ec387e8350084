"""Learning-rate schedules (``repro.optim.schedule``).

``noam_schedule`` is the transformer schedule of the paper's model
(Vaswani et al. 2017 eq. 3): lr = scale * d_model^-0.5 *
min(t^-0.5, t * w^-1.5), in f32.
"""
from __future__ import annotations

import torch


def noam_schedule(d_model: int, warmup_steps: int = 4000, scale: float = 2.0):
    def lr(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(step.to(torch.float32), min=1.0)
        return scale * d_model ** -0.5 * torch.minimum(
            t ** -0.5, t * warmup_steps ** -1.5)
    return lr
