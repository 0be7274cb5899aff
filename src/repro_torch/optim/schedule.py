"""Learning-rate schedules as functions of the step (counterpart of
`repro.optim.schedule`): `step` is an integer tensor (0-dim int32 in the
train state) or a Python int, and the result a float32 tensor on its
device."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, total_steps, final_frac=0.1):
    frac = torch.clamp(torch.as_tensor(step).float() / max(total_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return final_frac + (1.0 - final_frac) * cos


def linear_warmup_cosine(step, warmup_steps, total_steps, final_frac=0.1):
    step = torch.as_tensor(step)
    s = step.float()
    warm = s / max(warmup_steps, 1)
    return torch.where(s < warmup_steps, warm,
                       cosine_schedule(step - warmup_steps,
                                       max(total_steps - warmup_steps, 1),
                                       final_frac))
