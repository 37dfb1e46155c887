"""EliteKV attention over the block-paged compressed cache (serving path).

Weight layout, as in the JAX package (``core/elite_attention.py``):

  wq    [d, n_h, d_h]       query projection; dims [0:2r) of each head are its
                            KV group's elite chunks, [2r:) the non-elite dims
  wk_e  [d, n_kv, 2r]       elite key slice (rotated with per-head elite freqs)
  a_kv  [d, d_ckv]          J-LRD shared down-projection (a_k/a_v for S-LRD)
  bk    [d_c, n_kv, d_h-2r] K up-projection (latent → non-elite key dims)
  bv    [d_c, n_kv, d_h]    V up-projection
  wo    [n_h, d_h, d]       output projection

Buffers: ``elite_freqs`` [n_kv, r], the theta values of the elite chunks.

The pool holds, per token and layer, the rotated elite keys ``k_e`` and the
latent ``c`` (``c_k``/``c_v`` under S-LRD).  Page tensors are the pool's
per-layer views ``[n_slots, ...]`` and are written **in place**.

Decode absorbs ``bk`` into the query and ``bv`` into the output, so its
attention (the ``elite_decode_paged`` kernel) reads only the compressed
cache.

Prefill routing differs from the reference, which attends through XLA
(``_attend`` for fresh chunks, ``_attend_resumed`` over a gathered prefix):
here every prefill attention is the ``flash_prefill`` kernel, whose contract
is a contiguous key axis with per-lane ``q_offsets``/``kv_lens``.  A fresh
one-shot prefill calls it on the in-chunk K/V with offset 0.  A batch of
resumed chunks first scatters the chunk into the pool, then gathers each
lane's whole chain (prefix plus chunk, already grown by the scheduler) so
that logical position ``j`` sits at index ``j``, up-projects it through
``bk``/``bv``, and calls the kernel with ``q_offsets = chunk_start`` and
``kv_lens = chunk_start + valid tokens``.  The result agrees with the
reference to a float tolerance, not bit for bit.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core import rope as rope_lib
from repro_torch.kernels import ops
from repro_torch.kernels.ref import gather_pages
from repro_torch.models.layers import dense_init


def init(cfg, generator: torch.Generator, device) -> Tuple[Dict, Dict]:
    """Random (params, buffers) for one layer."""
    d, dh, nh, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    e = cfg.elitekv
    r2 = 2 * e.elite_r
    d_nope = dh - r2
    g, dev = generator, device
    params = {
        "wq": dense_init((d, nh, dh), g, dev),
        "wk_e": dense_init((d, nkv, r2), g, dev),
        "wo": dense_init((nh, dh, d), g, dev, in_axis=2, scale=(nh * dh) ** -0.5),
    }
    if e.lrd == "joint":
        params["a_kv"] = dense_init((d, e.d_ckv), g, dev)
        params["bk"] = dense_init((e.d_ckv, nkv, d_nope), g, dev, scale=e.d_ckv ** -0.5)
        params["bv"] = dense_init((e.d_ckv, nkv, dh), g, dev, scale=e.d_ckv ** -0.5)
    else:
        params["a_k"] = dense_init((d, e.d_ck), g, dev)
        params["a_v"] = dense_init((d, e.d_cv), g, dev)
        params["bk"] = dense_init((e.d_ck, nkv, d_nope), g, dev, scale=e.d_ck ** -0.5)
        params["bv"] = dense_init((e.d_cv, nkv, dh), g, dev, scale=e.d_cv ** -0.5)
    # default elite chunks: the r highest frequencies (the real sets come from
    # the RoPElite search at conversion time)
    freqs = rope_lib.chunk_freqs(dh, cfg.rope_theta, device=dev)
    buffers = {"elite_freqs": freqs[None, :e.elite_r].repeat(nkv, 1)}
    return params, buffers


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _project_q(params, cfg, x):
    """Unrotated q_e [B,S,nh,2r] and linear q_ne [B,S,nh,d_nope]."""
    r2 = 2 * cfg.elitekv.elite_r
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"].to(x.dtype))
    return q[..., :r2], q[..., r2:]


def _rot_q(cfg, buffers, q_e, positions):
    ef_q = rope_lib.expand_kv_to_q(buffers["elite_freqs"], cfg.q_group)  # [nh, r]
    return rope_lib.apply_elite_rope(q_e, positions, ef_q)


def _latents(params, cfg, x):
    """Down-projected latent(s) (c_k, c_v) — the same tensor under J-LRD."""
    dt = x.dtype
    if cfg.elitekv.lrd == "joint":
        c = x @ params["a_kv"].to(dt)
        return c, c
    return x @ params["a_k"].to(dt), x @ params["a_v"].to(dt)


def _materialized(params, cfg, buffers, x, positions):
    dt = x.dtype
    q_e, q_ne = _project_q(params, cfg, x)
    q_e = _rot_q(cfg, buffers, q_e, positions)
    k_e = torch.einsum("bsd,dhe->bshe", x, params["wk_e"].to(dt))
    k_e = rope_lib.apply_elite_rope(k_e, positions, buffers["elite_freqs"])
    c_k, c_v = _latents(params, cfg, x)
    k_ne = torch.einsum("bsc,che->bshe", c_k, params["bk"].to(dt))
    v = torch.einsum("bsc,che->bshe", c_v, params["bv"].to(dt))
    q = torch.cat([q_e, q_ne], dim=-1)
    k = torch.cat([k_e, k_ne], dim=-1)
    return q, k, v.contiguous(), k_e, c_k, c_v


# ---------------------------------------------------------------------------
# pool writes
# ---------------------------------------------------------------------------

class Writes(NamedTuple):
    """Which token rows go to which pool slots: ``rows`` index the flattened
    token axis of a forward, ``slots`` the flat pool slots they land in."""
    rows: torch.Tensor
    slots: torch.Tensor


def write_index(slot_mapping: torch.Tensor, n_slots: int, device) -> Writes:
    """Drop the out-of-range sentinel (``PagedKVPool.oob_slot``, used for idle
    lanes and prompt padding) from a slot mapping.  Torch has no dropping
    scatter — an out-of-range ``index_copy_`` raises on the CPU and asserts on
    the card — so the sentinel rows are masked here, once per forward, on the
    device the mapping lives on (the scheduler builds it on the host)."""
    flat = slot_mapping.reshape(-1)
    rows = torch.nonzero(flat < n_slots).squeeze(1)
    return Writes(rows.to(device), flat[rows].long().to(device))


def _scatter_pages(pages, k_e_new, c_k_new, c_v_new, writes: Writes) -> None:
    """Write per-token compressed streams into pool pages, in place.
    k_e_new [N,nkv,2r], c_*_new [N,dc]."""
    rows, slots = writes

    def put(name, val):
        buf = pages[name]
        buf.index_copy_(0, slots, val[rows].to(buf.dtype))

    put("k_e", k_e_new)
    if "c" in pages:
        put("c", c_k_new)
    else:
        put("c_k", c_k_new)
        put("c_v", c_v_new)


def _page_latents(pages):
    if "c" in pages:
        return pages["c"], pages["c"]
    return pages["c_k"], pages["c_v"]


def _gather_chain(pages, params, block_tables, block_size: int, dt):
    """Contiguous K/V of each lane's cached chain: block_tables [B, mb] →
    K [B, mb·bs, nkv, dh], V [B, mb·bs, nkv, dh].  Positions past a lane's
    live length land on blocks of other sequences (or the pad block 0); the
    caller masks them by ``kv_lens``."""
    k_e = gather_pages(pages["k_e"], block_tables, block_size).to(dt)
    c_k_pages, c_v_pages = _page_latents(pages)
    c_k = gather_pages(c_k_pages, block_tables, block_size).to(dt)
    c_v = c_k if c_v_pages is c_k_pages else \
        gather_pages(c_v_pages, block_tables, block_size).to(dt)
    k_ne = torch.einsum("bsc,che->bshe", c_k, params["bk"].to(dt))
    v = torch.einsum("bsc,che->bshe", c_v, params["bv"].to(dt))
    return torch.cat([k_e, k_ne], dim=-1), v.contiguous()


# ---------------------------------------------------------------------------
# paged prefill and decode
# ---------------------------------------------------------------------------

def apply_prefill_paged(params, cfg, buffers, x, positions, pages, writes: Writes,
                        block_tables=None, prefix_lens=None, kv_lens=None,
                        block_size: int = 0):
    """Prefill a batch of (chunks of) sequences, writing their streams into
    the pool pages.

    Fresh prompts (``block_tables is None``): x [B,S,d] at positions [S];
    causal attention over the (padded) prompt itself.

    Resumed chunks: ``positions`` [B,S] are the chunks' global positions,
    ``block_tables`` [B,mb] each lane's chain (grown to cover the chunk),
    ``prefix_lens`` [B] its cached length before the chunk (its
    ``q_offsets``) and ``kv_lens`` [B] its length after the chunk's valid
    tokens.  Lanes with ``kv_lens == 0`` output zeros.
    → out [B,S,d]; ``pages`` updated in place.
    """
    dt = x.dtype
    B, S = x.shape[:2]
    q, k, v, k_e, c_k, c_v = _materialized(params, cfg, buffers, x, positions)
    _scatter_pages(pages, k_e.reshape(B * S, *k_e.shape[2:]),
                   c_k.reshape(B * S, -1), c_v.reshape(B * S, -1), writes)
    scale = cfg.head_dim ** -0.5
    if block_tables is None:
        offs = torch.zeros(B, dtype=torch.int32, device=x.device)
        lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
        o = ops.flash_prefill(q, k, v, cfg.q_group, scale, offs, lens)
    else:
        k_all, v_all = _gather_chain(pages, params, block_tables, block_size, dt)
        o = ops.flash_prefill(q, k_all, v_all, cfg.q_group, scale,
                              prefix_lens, kv_lens)
    return torch.einsum("bshe,hed->bsd", o, params["wo"].to(dt))


def apply_decode_paged(params, cfg, buffers, x, pages, writes: Writes,
                       block_tables, lengths, block_size: int):
    """Absorbed decode over the block pool — one token per serving lane.

    x [B,1,d]; lengths [B] int32, the live length *including* the new token
    (0 for idle lanes, whose writes hit the sentinel and whose attention
    output is zero); block_tables [B,mb] int32.
    → out [B,1,d]; ``pages`` updated in place.
    """
    dt = x.dtype
    B = x.shape[0]
    nh, dh, G = cfg.n_heads, cfg.head_dim, cfg.q_group
    pos = (lengths - 1)[:, None]                             # [B,1] per lane

    q_e, q_ne = _project_q(params, cfg, x)
    q_e = _rot_q(cfg, buffers, q_e, pos)
    bk_q = rope_lib.expand_kv_to_q(params["bk"].permute(1, 0, 2), G)  # [nh,dc,dn]
    q_lat = torch.einsum("bshn,hcn->bshc", q_ne, bk_q.to(dt))

    k_e_new = torch.einsum("bsd,dhe->bshe", x, params["wk_e"].to(dt))
    k_e_new = rope_lib.apply_elite_rope(k_e_new, pos, buffers["elite_freqs"])
    c_k_new, c_v_new = _latents(params, cfg, x)
    _scatter_pages(pages, k_e_new[:, 0], c_k_new[:, 0], c_v_new[:, 0], writes)

    C_k, C_v = _page_latents(pages)
    o = ops.elite_decode_paged(
        q_e.reshape(B, nh, -1).contiguous(), q_lat.reshape(B, nh, -1).contiguous(),
        pages["k_e"], C_k, C_v, block_tables, lengths, G, dh ** -0.5, block_size)
    o = o.reshape(B, 1, nh, C_v.shape[-1]).to(dt)

    bv_q = rope_lib.expand_kv_to_q(params["bv"].permute(1, 0, 2), G)  # [nh,dc,dh]
    o_heads = torch.einsum("bqhc,hcd->bqhd", o, bv_q.to(dt))
    return torch.einsum("bshe,hed->bsd", o_heads, params["wo"].to(dt))
