"""Baseline GQA/MHA attention with full RoPE (the paper's starting point).

Counterpart of the JAX package's ``models/attention.py``.  Three modes over
a contiguous cache:

  * ``apply_full``    — whole-sequence causal forward (no cache);
  * ``apply_prefill`` — the same, and it writes the prompt's K/V into the
    cache;
  * ``apply_decode``  — one token per lane against the cache.

``apply_full`` attends through ``_attend``, the plain masked softmax (the
reference's XLA path, which training differentiates), and is the oracle
the cached modes are held to.  Long sequences (S >= 4096, or
``cfg.attn_chunk_q``) attend in query chunks, as the reference does, so the
[S, S] scores never exist whole; under grad each chunk is recomputed in the
backward (``torch.utils.checkpoint``), so only the chunk outputs persist.
Prefill and decode attend through the ``flash_prefill`` kernel
(``kernels.ops``): prefill with ``q_offsets = 0`` and ``kv_lens = S``,
decode as one query row per lane with ``q_offsets = index`` and
``kv_lens = index + 1`` over the whole ``[B, max_len, nkv, dh]`` cache.
The cache is written in place.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import rope as rope_lib
from repro_torch.distributed.sharding import einsum, is_dtensor, replicated_like
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init

NEG_INF = -1e30
_NOOP = lambda name, x: x


def init(cfg, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    d, dh, nh, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    g = generator
    return {
        "wq": dense_init((d, nh, dh), g, device),
        "wk": dense_init((d, nkv, dh), g, device),
        "wv": dense_init((d, nkv, dh), g, device),
        "wo": dense_init((nh, dh, d), g, device, in_axis=2, scale=(nh * dh) ** -0.5),
    }


def _auto_chunk(Sq: int, chunk_q: Optional[int]) -> Optional[int]:
    """The query chunk: ``chunk_q`` where it divides Sq and is shorter, else
    1024 from Sq = 4096 on (multiples of 1024), else None (no chunks)."""
    if chunk_q is not None:
        return chunk_q if Sq > chunk_q and Sq % chunk_q == 0 else None
    if Sq >= 4096 and Sq % 1024 == 0:
        return 1024
    return None


def _block(q, k, v, scale: float, q_offset: int) -> torch.Tensor:
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = s + causal_mask(q.shape[1], k.shape[1], q_offset, device=q.device)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _local_block(q, k, v, scale: float, q_offset: int) -> torch.Tensor:
    """``_block`` on ``DTensor``s: every (lane, head) attends on its own, so
    each rank runs ``_block`` on its local lanes and heads (``local_map``,
    keys and values placed as the queries), as the reference's GSPMD keeps
    the scores sharded by batch and head."""
    from torch.distributed.tensor.experimental import local_map
    pl = list(q.placements)
    fn = local_map(lambda ql, kl, vl: _block(ql, kl, vl, scale, q_offset),
                   out_placements=pl, in_placements=(pl, pl, pl),
                   device_mesh=q.device_mesh, redistribute_inputs=True)
    return fn(q, k, v)


def _attend(q, k, v, q_group: int, scale: float, q_offset: int = 0,
            chunk_q: Optional[int] = None, constrain=_NOOP) -> torch.Tensor:
    """Causal attention.  q [B,Sq,nh,dh]; k,v [B,Sk,nkv,dh]; key j visible
    to query i iff ``j <= i + q_offset``.  → [B,Sq,nh,dh].  Queries go in
    chunks of ``_auto_chunk(Sq, chunk_q)`` rows, each recomputed in the
    backward under grad.  The kv heads repeated to the query heads are
    constrained as ``heads4``."""
    if q_group > 1:
        k = constrain("heads4", torch.repeat_interleave(k, q_group, dim=2))
        v = constrain("heads4", torch.repeat_interleave(v, q_group, dim=2))
    block = _local_block if is_dtensor(q) else _block
    cq = _auto_chunk(q.shape[1], chunk_q)
    if cq is None:
        return block(q, k, v, scale, q_offset)
    remat = torch.is_grad_enabled()
    outs = [checkpoint(block, q[:, i:i + cq], k, v, scale, q_offset + i, use_reentrant=False)
            if remat else block(q[:, i:i + cq], k, v, scale, q_offset + i)
            for i in range(0, q.shape[1], cq)]
    return torch.cat(outs, dim=1)


def causal_mask(Sq: int, Sk: int, offset: int = 0, dtype=torch.float32,
                device="cpu") -> torch.Tensor:
    """Additive causal mask [Sq, Sk]: 0 where ``j <= i + offset``, else -1e30."""
    qi = torch.arange(Sq, device=device)[:, None]
    kj = torch.arange(Sk, device=device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(kj <= qi + offset, zero, torch.full_like(zero, NEG_INF))


def _qkv(params, cfg, x, positions, constrain=_NOOP):
    dt = x.dtype
    c = constrain
    q = c("attn_q", einsum("bsd,dhe->bshe", x, params["wq"].to(dt)))
    k = c("attn_kv", einsum("bsd,dhe->bshe", x, params["wk"].to(dt)))
    v = c("attn_kv", einsum("bsd,dhe->bshe", x, params["wv"].to(dt)))
    q, k = rope_lib.apply_rope_qk(q, k, positions, cfg.rope_theta)
    return c("attn_q", q), c("attn_kv", k), v.contiguous()


def apply_full(params, cfg, x, positions, constrain=_NOOP) -> torch.Tensor:
    q, k, v = _qkv(params, cfg, x, positions, constrain)
    o = _attend(q, k, v, cfg.q_group, cfg.head_dim ** -0.5, chunk_q=cfg.attn_chunk_q,
                constrain=constrain)
    return einsum("bshe,hed->bsd", o, params["wo"].to(x.dtype))


def init_cache(cfg, batch: int, max_len: int, device) -> Dict[str, torch.Tensor]:
    """One layer's f32 cache: k, v [batch, max_len, nkv, dh]."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, device=device), "v": torch.zeros(shape, device=device)}


def apply_prefill(params, cfg, x, positions, cache, constrain=_NOOP) -> torch.Tensor:
    """Prompts x [B,S,d] at ``positions`` [S]; writes cache rows [0, S) in
    place.  → out [B,S,d]."""
    B, S = x.shape[:2]
    q, k, v = _qkv(params, cfg, x, positions, constrain)
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    offs = replicated_like(x, torch.zeros(B, dtype=torch.int32, device=x.device))
    lens = replicated_like(x, torch.full((B,), S, dtype=torch.int32, device=x.device))
    o = ops.flash_prefill(q, k, v, cfg.q_group, cfg.head_dim ** -0.5, offs, lens)
    return einsum("bshe,hed->bsd", o, params["wo"].to(x.dtype))


def apply_decode(params, cfg, x, index: int, cache) -> torch.Tensor:
    """x [B,1,d], the token at position ``index`` of every lane; writes
    cache row ``index`` in place and attends rows ``[0, index]``.  A placed
    cache whose sequence is sharded raises ``ValueError``: merging the
    pieces needs ``flash_prefill``'s decode body to give its log-sum-exp
    (ROADMAP item 15c.3).  → out [B,1,d]."""
    if is_dtensor(cache["k"]) and any(p.is_shard(1) for p in cache["k"].placements):
        raise ValueError("the baseline's decode over a sequence-sharded cache needs "
                         "flash_prefill's decode body to return its log-sum-exp and a merge "
                         "across the shards: ROADMAP item 15c.3")
    dt = x.dtype
    B = x.shape[0]
    pos = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(params, cfg, x, pos)
    cache["k"][:, index] = k[:, 0]
    cache["v"][:, index] = v[:, 0]
    o = ops.flash_prefill(q, cache["k"], cache["v"], cfg.q_group, cfg.head_dim ** -0.5,
                          pos[:, 0], pos[:, 0] + 1)
    return torch.einsum("bshe,hed->bsd", o, params["wo"].to(dt))
