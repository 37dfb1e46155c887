"""Shared layers: RMSNorm, SwiGLU MLP, embeddings (and the tied LM head),
the cross-entropy loss, init helpers."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def dense_init(shape: Sequence[int], generator: torch.Generator, device,
               scale: Optional[float] = None, in_axis: int = 0) -> torch.Tensor:
    """Truncated-normal (±3σ) fan-in init (LLaMA-style), drawn from
    ``generator`` on ``device``; on the meta device a shape-only
    ``torch.empty`` that draws nothing (``generator`` may be None)."""
    fan_in = shape[in_axis]
    if scale is None:
        scale = fan_in ** -0.5
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if t.is_meta:
        return t
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return t.mul_(scale)


def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * params["scale"]).to(dt)


def mlp_init(d_model: int, d_ff: int, generator: torch.Generator, device) -> dict:
    return {
        "w_gate": dense_init((d_model, d_ff), generator, device),
        "w_up": dense_init((d_model, d_ff), generator, device),
        "w_down": dense_init((d_ff, d_model), generator, device),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU feed-forward."""
    h = F.silu(x @ params["w_gate"].to(x.dtype)) * (x @ params["w_up"].to(x.dtype))
    return h @ params["w_down"].to(x.dtype)


def embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["table"].to(dtype)[tokens]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """The tied LM head: x @ table^T, logits in f32."""
    return x.float() @ params["table"].float().T


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in f32.  logits [B,S,V], labels [B,S]
    (int64), mask [B,S] (the mean is over its sum, at least 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
