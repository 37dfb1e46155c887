"""Rotary position embeddings, including EliteKV's per-head partial RoPE.

Conventions (same as the JAX package):

* Interleaved pairing: chunk ``i`` of a head vector is ``(x[2i], x[2i+1])``.
* Chunk ``i`` carries frequency ``theta_i = base ** (-2 i / d_h)`` — chunk 0
  is the highest frequency.
* EliteKV models store, per KV head, the ``r`` elite frequencies
  (``elite_freqs`` — theta values, not indices; projection columns are
  permuted so elite chunks occupy the first ``2r`` dims).

Angles are computed in f32.
"""
from __future__ import annotations

import torch


def chunk_freqs(d_head: int, theta: float = 10000.0, device="cuda") -> torch.Tensor:
    """theta_i for each 2-D chunk: shape [d_head // 2], descending frequency."""
    i = torch.arange(d_head // 2, dtype=torch.float32, device=device)
    return theta ** (-2.0 * i / d_head)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs of the last axis of x.

    x: [..., 2C]; cos/sin broadcastable to [..., C].
    """
    orig_dtype = x.dtype
    x = x.float()
    x2 = x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2))
    x_even, x_odd = x2[..., 0], x2[..., 1]
    out_even = x_even * cos - x_odd * sin
    out_odd = x_even * sin + x_odd * cos
    out = torch.stack([out_even, out_odd], dim=-1).reshape(x.shape)
    return out.to(orig_dtype)


def apply_elite_rope(x: torch.Tensor, positions: torch.Tensor,
                     elite_freqs: torch.Tensor) -> torch.Tensor:
    """Per-head RoPE over the packed elite dims.

    x: [B, S, H, 2r] — the elite slice; elite_freqs: [H, r] (theta values
    per head).  positions: [S] or [B, S].
    """
    B, S, H, r2 = x.shape
    assert elite_freqs.shape == (H, r2 // 2), (tuple(elite_freqs.shape), (H, r2 // 2))
    if positions.dim() == 1:
        ang = positions[:, None, None].float() * elite_freqs[None]         # [S,H,r]
        cos, sin = torch.cos(ang)[None], torch.sin(ang)[None]              # [1,S,H,r]
    else:
        ang = positions[:, :, None, None].float() * elite_freqs[None, None]
        cos, sin = torch.cos(ang), torch.sin(ang)                          # [B,S,H,r]
    return rotate(x, cos, sin)


def expand_kv_to_q(per_kv: torch.Tensor, q_group: int) -> torch.Tensor:
    """[n_kv, ...] → [n_kv * q_group, ...]: query head h uses kv head h // q_group."""
    return torch.repeat_interleave(per_kv, q_group, dim=0)
