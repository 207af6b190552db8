"""LR schedules (torch; a port of ``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, base_lr: float, warmup: int = 100,
                    total: int = 10000, min_ratio: float = 0.1
                    ) -> torch.Tensor:
    """Linear warmup to ``base_lr`` over ``warmup`` steps (0 at step 0),
    then a cosine decay to ``min_ratio * base_lr`` at ``total``.  ``step``
    is an int or a 0-d tensor; the result is a 0-d fp32 tensor on its
    device (the CPU for an int), computed in fp32 as JAX computes it."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(s < warmup, warm, base_lr * cos)
