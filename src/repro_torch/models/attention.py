"""Baseline GQA/MHA attention with full RoPE (the paper's starting point).

Counterpart of the JAX package's ``models/attention.py``.  Three modes over
a contiguous cache:

  * ``apply_full``    — whole-sequence causal forward (no cache);
  * ``apply_prefill`` — the same, and it writes the prompt's K/V into the
    cache;
  * ``apply_decode``  — one token per lane against the cache.

``apply_full`` attends through ``_attend``, the plain masked softmax (the
reference's XLA path; no query chunking at the port's sizes), and is the
oracle the cached modes are held to.  Prefill and decode attend through the
``flash_prefill`` kernel (``kernels.ops``): prefill with ``q_offsets = 0``
and ``kv_lens = S``, decode as one query row per lane with
``q_offsets = index`` and ``kv_lens = index + 1`` over the whole
``[B, max_len, nkv, dh]`` cache.  The cache is written in place.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import rope as rope_lib
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init

NEG_INF = -1e30


def init(cfg, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    d, dh, nh, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    g = generator
    return {
        "wq": dense_init((d, nh, dh), g, device),
        "wk": dense_init((d, nkv, dh), g, device),
        "wv": dense_init((d, nkv, dh), g, device),
        "wo": dense_init((nh, dh, d), g, device, in_axis=2, scale=(nh * dh) ** -0.5),
    }


def _attend(q, k, v, q_group: int, scale: float, q_offset: int = 0) -> torch.Tensor:
    """Causal attention.  q [B,Sq,nh,dh]; k,v [B,Sk,nkv,dh]; key j visible
    to query i iff ``j <= i + q_offset``.  → [B,Sq,nh,dh]."""
    if q_group > 1:
        k = torch.repeat_interleave(k, q_group, dim=2)
        v = torch.repeat_interleave(v, q_group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = s + causal_mask(q.shape[1], k.shape[1], q_offset, device=q.device)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def causal_mask(Sq: int, Sk: int, offset: int = 0, dtype=torch.float32,
                device="cpu") -> torch.Tensor:
    """Additive causal mask [Sq, Sk]: 0 where ``j <= i + offset``, else -1e30."""
    qi = torch.arange(Sq, device=device)[:, None]
    kj = torch.arange(Sk, device=device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(kj <= qi + offset, zero, torch.full_like(zero, NEG_INF))


def _qkv(params, cfg, x, positions):
    dt = x.dtype
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhe->bshe", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhe->bshe", x, params["wv"].to(dt))
    q, k = rope_lib.apply_rope_qk(q, k, positions, cfg.rope_theta)
    return q, k, v.contiguous()


def apply_full(params, cfg, x, positions) -> torch.Tensor:
    q, k, v = _qkv(params, cfg, x, positions)
    o = _attend(q, k, v, cfg.q_group, cfg.head_dim ** -0.5)
    return torch.einsum("bshe,hed->bsd", o, params["wo"].to(x.dtype))


def init_cache(cfg, batch: int, max_len: int, device) -> Dict[str, torch.Tensor]:
    """One layer's f32 cache: k, v [batch, max_len, nkv, dh]."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, device=device), "v": torch.zeros(shape, device=device)}


def apply_prefill(params, cfg, x, positions, cache) -> torch.Tensor:
    """Prompts x [B,S,d] at ``positions`` [S]; writes cache rows [0, S) in
    place.  → out [B,S,d]."""
    B, S = x.shape[:2]
    q, k, v = _qkv(params, cfg, x, positions)
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    offs = torch.zeros(B, dtype=torch.int32, device=x.device)
    lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
    o = ops.flash_prefill(q, k, v, cfg.q_group, cfg.head_dim ** -0.5, offs, lens)
    return torch.einsum("bshe,hed->bsd", o, params["wo"].to(x.dtype))


def apply_decode(params, cfg, x, index: int, cache) -> torch.Tensor:
    """x [B,1,d], the token at position ``index`` of every lane; writes
    cache row ``index`` in place and attends rows ``[0, index]``.
    → out [B,1,d]."""
    dt = x.dtype
    B = x.shape[0]
    pos = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(params, cfg, x, pos)
    cache["k"][:, index] = k[:, 0]
    cache["v"][:, index] = v[:, 0]
    o = ops.flash_prefill(q, cache["k"], cache["v"], cfg.q_group, cfg.head_dim ** -0.5,
                          pos[:, 0], pos[:, 0] + 1)
    return torch.einsum("bshe,hed->bsd", o, params["wo"].to(dt))
