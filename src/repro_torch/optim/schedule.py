"""LR schedules: functions of the step, an int32 scalar tensor, that return
an f32 scalar tensor on its device."""
import math

import torch


def warmup_cosine(step, *, base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    s = step.float()
    warm = base_lr * s / max(warmup_steps, 1)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                       0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup_steps, warm, cos)


def constant(step, *, base_lr: float, **_):
    return torch.full((), base_lr, dtype=torch.float32, device=step.device)


SCHEDULES = {"warmup_cosine": warmup_cosine, "constant": constant}
