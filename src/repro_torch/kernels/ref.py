"""Plain PyTorch versions of the hand-written CUDA kernels.

They compute the same functions as the JAX package's ``kernels/ref.py``
oracles and serve two purposes: the kernel wrappers take them for tensors
that lie on the CPU, and tests and ``chip_smoke.py`` hold each CUDA kernel
against them on the card.  Rows with no visible key output exact zeros.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _decode_masked(q_e, q_lat, k_e, c_k, c_v, valid, q_group: int,
                   scale: float) -> torch.Tensor:
    """Decode-attention core with an explicit key-validity mask
    ``valid [B, 1, S]``."""
    B, nh, r2 = q_e.shape
    S, nkv = k_e.shape[1], k_e.shape[2]
    qe_g = q_e.reshape(B, nkv, q_group, r2)
    s_e = torch.einsum("bhge,bkhe->bhgk", qe_g, k_e).reshape(B, nh, S)
    s_lat = torch.einsum("bhc,bkc->bhk", q_lat, c_k)
    s = (s_e + s_lat) * scale
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # rows with no visible key (empty serving slots) attend to nothing
    p = torch.where(valid.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    return torch.einsum("bhk,bkc->bhc", p.to(c_v.dtype), c_v)


def elite_decode_ref(q_e, q_lat, k_e, c_k, c_v, lengths, q_group: int,
                     scale: float) -> torch.Tensor:
    """Absorbed EliteKV decode attention over a contiguous cache.

    q_e [B,nh,2r], q_lat [B,nh,dc], k_e [B,S,nkv,2r], c_k/c_v [B,S,dc],
    lengths [B] int32 → [B,nh,dc].
    """
    S = k_e.shape[1]
    valid = torch.arange(S, device=k_e.device)[None, None, :] < lengths[:, None, None]
    return _decode_masked(q_e, q_lat, k_e, c_k, c_v, valid, q_group, scale)


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor,
                 block_size: int) -> torch.Tensor:
    """Flat pool stream ``[n_slots, ...]`` → per-lane contiguous
    ``[B, mb·bs, ...]``: logical position ``p`` of lane ``b`` comes from slot
    ``block_tables[b, p // bs] · bs + p % bs``."""
    B, mb = block_tables.shape
    paged = pages.reshape((-1, block_size) + tuple(pages.shape[1:]))
    return paged[block_tables.long()].reshape((B, mb * block_size) + tuple(pages.shape[1:]))


def elite_decode_paged_ref(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                           block_tables, lengths, q_group: int, scale: float,
                           block_size: int) -> torch.Tensor:
    """Paged EliteKV decode attention: gather each lane's chain, then the
    contiguous version.

    k_e_pages [n_slots,nkv,2r], c_k/c_v_pages [n_slots,dc],
    block_tables [B,mb] int32 (pad = 0), lengths [B] int32 (0 = empty lane)
    → [B,nh,dc].
    """
    return elite_decode_ref(q_e, q_lat,
                            gather_pages(k_e_pages, block_tables, block_size),
                            gather_pages(c_k_pages, block_tables, block_size),
                            gather_pages(c_v_pages, block_tables, block_size),
                            lengths, q_group, scale)


def flash_prefill_ref(q, k, v, q_group: int, scale: float, q_offsets,
                      kv_lens) -> torch.Tensor:
    """Causal GQA attention.  q [B,Sq,nh,dh], k/v [B,Sk,nkv,dh],
    q_offsets/kv_lens [B] int32 → [B,Sq,nh,dh].

    Key ``j`` is visible to query ``i`` of lane ``b`` iff
    ``j <= i + q_offsets[b]`` and ``j < kv_lens[b]``.  Queries with no
    visible key output exact zeros.
    """
    B, Sq, nh, dh = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, nkv, q_group, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * scale
    kpos = torch.arange(Sk, device=q.device)[None, None, :]
    qpos = torch.arange(Sq, device=q.device)[None, :, None]
    mask = (kpos <= qpos + q_offsets[:, None, None]) & (kpos < kv_lens[:, None, None])
    mask = mask[:, None, None]                               # [B,1,1,Sq,Sk]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o.reshape(B, Sq, nh, dh)
