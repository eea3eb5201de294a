"""Learning-rate schedules (warmup + cosine), as plain functions of step."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """The learning-rate multiplier at ``step`` as a float32 0-dim tensor
    (on ``step``'s device when it is a tensor).  Every divide is tensor
    by tensor: torch turns a division by a python number into a
    reciprocal multiply on the card."""
    step = torch.as_tensor(step).to(torch.float32)
    den = torch.tensor(float(max(warmup_steps, 1)), device=step.device)
    warm = step / den
    span = torch.tensor(float(max(total_steps - warmup_steps, 1)),
                        device=step.device)
    t = torch.clamp((step - warmup_steps) / span, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, cos)
