"""LR schedules: the port of ``src/repro/optim/schedule.py``, in f32."""
from __future__ import annotations

import math

import torch

#: the floor of the cosine decay, as a share of the peak (the reference's)
MIN_RATIO = 0.1


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup_steps`` (step ``s``
    gives ``peak_lr * (s + 1) / warmup_steps``), then a cosine decay to
    ``MIN_RATIO * peak_lr`` at ``total_steps``; a scalar f32 tensor on the
    device of ``step`` (the CPU for a Python int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (MIN_RATIO + (1 - MIN_RATIO)
                     * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)
