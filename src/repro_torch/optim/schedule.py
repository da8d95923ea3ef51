"""LR schedules (warmup + cosine decay) and λ (entropy-penalty) ramps.

Mirrors the JAX package's ``optim/schedule.py``: both return float32
tensors.  Ramping λ from 0 lets one run anneal into the low-entropy regime
without an early accuracy cliff.
"""
from __future__ import annotations

import math

import torch


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def warmup_cosine(step, *, base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> torch.Tensor:
    s = _f32(step)
    warm = s / _f32(max(warmup, 1))
    prog = torch.clamp((s - warmup) / _f32(max(total - warmup, 1)), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(s < warmup, warm, cos)


def lambda_ramp(step, *, lam: float, ramp_steps: int) -> torch.Tensor:
    """Linear 0 -> λ ramp over ramp_steps."""
    s = _f32(step)
    return lam * torch.clamp(s / _f32(max(ramp_steps, 1)), 0.0, 1.0)
