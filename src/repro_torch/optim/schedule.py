"""LR schedules: constant (the paper's uptraining, §4.1), cosine, and WSD
(warmup-stable-decay, MiniCPM's schedule).

The port's own copy of the JAX package's ``optim/schedule.py``.  Each
schedule maps a step (an int or an integer tensor) to a 0-d f32 tensor on
the step's device, computed in f32 with the reference's constants and
order of operations.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def constant(lr: float):
    return lambda step: _f32(lr, torch.as_tensor(step))


def cosine(peak: float, warmup: int, total: int, floor_frac: float = 0.1):
    def fn(step):
        step = _step(step)
        warm = peak * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = (floor_frac * peak
               + (1 - floor_frac) * peak * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return fn


def wsd(peak: float, warmup: int, stable: int, decay: int, floor_frac: float = 0.01):
    """MiniCPM warmup-stable-decay: linear warmup → flat → exponential decay."""
    def fn(step):
        step = _step(step)
        warm = peak * step / max(warmup, 1)
        t = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
        dec = peak * torch.pow(_f32(floor_frac, t), t)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable, _f32(peak, t), dec))
    return fn


def get(name: str, **kw):
    return {"constant": constant, "cosine": cosine, "wsd": wsd}[name](**kw)
