"""LR schedules (counterpart of `repro.optim.schedules`): cosine (the
default) and WSD (Warmup-Stable-Decay), the MiniCPM schedule
[arXiv:2404.06395] of the minicpm-2b config. Each maps a step (an int or
a 0-dim tensor, on whatever device it lies) to a 0-dim f32 tensor,
computed in f32 as the JAX functions compute it."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1):
    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(
            math.pi * t))
        return torch.where(step < warmup, warm, peak_lr * cos)
    return lr


def wsd_schedule(peak_lr: float, warmup: int, stable: int, decay: int,
                 final_frac: float = 0.01):
    """MiniCPM WSD: linear warmup -> flat stable phase -> exponential-ish
    decay over the last `decay` steps."""
    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
        dec = peak_lr * (final_frac ** t)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable,
                                       torch.full_like(step, peak_lr), dec))
    return lr
