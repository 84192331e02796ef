"""LR schedules (pure functions of the step counter): the port of
``repro/optim/schedules.py``, in float32 as the reference computes them."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> torch.Tensor:
    """``step``: an integer tensor (or int). Returns a float32 0-d tensor on its device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(warmup_steps, 1)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(s < warmup_steps, warm, cos)
