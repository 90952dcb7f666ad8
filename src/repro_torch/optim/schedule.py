"""Learning-rate schedules."""

from __future__ import annotations

import math
from typing import Union

import torch


def cosine_schedule(step: Union[int, torch.Tensor], *, peak_lr: float,
                    warmup_steps: int = 100, total_steps: int = 10_000,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """The lr of `step` as a 0-d fp32 tensor on the CPU, in the
    reference's order of fp32 operations: a linear warmup, then a cosine
    down to `min_ratio` of the peak."""
    f32 = torch.float32
    step = torch.as_tensor(step).to("cpu", f32)
    # 1-indexed warmup so the very first update has a non-zero LR
    warm = peak_lr * (step + 1.0) / max(warmup_steps, 1)
    progress = torch.clamp((step - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) *
                     0.5 * (1 + torch.cos(math.pi * progress)))
    return torch.where(step < warmup_steps, warm, cos)
