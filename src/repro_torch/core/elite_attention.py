"""EliteKV attention over the block-paged compressed cache (serving path)
and over a contiguous cache (lockstep batch generation).

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
attention reads only the compressed cache.  Its kernel is one of a family
of four, picked by the pool's dtype and by ``sparse_topk``:
``elite_decode_paged`` (f32 pages, the whole chain), ``elite_decode_paged_q8``
(int8 pages plus per-slot scales), and their sparse variants
``elite_decode_sparse_paged[_q8]``, which walk a block-top-k selection
scored against per-block latent summaries (``kernels/ref.py::
select_topk_blocks``).  A selection at least as wide as the table is the
whole chain, and the sparse kernels then give the dense kernels' bits.

Speculative verify (``apply_verify_paged``) is decode with a window: the
``W = k+1`` tokens of each lane's window are scattered into the pool first,
then scored in one walk of the block table by ``elite_verify_paged`` (or
``_q8``), row ``w`` masked offset-causally at ``q_offsets + w``.  It stays
in the absorbed latent space, like decode.

An int8 pool (``"k_e_scale" in pages``) quantizes every row when the
scatter writes it and dequantizes wherever a stream is read back.  A fresh
one-shot prefill attends over ``quant.roundtrip_rows`` of its own streams,
as the reference does, so it sees exactly what later reads of the pool
will.  A resumed chunk needs no round-trip here: unlike the reference, which
concatenates the chunk's round-tripped K/V to the gathered prefix, the port
gathers the whole chain, chunk included, from the pool *after* the scatter,
so the chunk comes back dequantized already.

The contiguous half (``apply_full``, ``init_cache``, ``apply_prefill``,
``apply_decode``) keeps the reference's ``[B, max_len, ...]`` cache leaves,
f32 only, written in place at rows ``[0, S)`` by prefill and at row
``index`` by decode.  ``apply_full`` attends through the plain ``_attend``
(the reference's XLA path, query-chunked at ``cfg.attn_chunk_q``) and is
the training forward and the oracle of cache-on == cache-off;
prefill attends its own K/V through ``flash_prefill`` with offset 0, and
decode is the absorbed path through the ``elite_decode`` kernel with
``lengths = index + 1`` (the reference's ``use_kernel=False`` einsum branch
is that kernel's plain version, ``ref.elite_decode_ref``).  Every forward
of every path projects q_e and k_e first and rotates them together in one
``rope_elite`` launch per layer (``_project``, ``core/rope.py``).  Under
grad that launch is differentiable on the card (``kernels/ops.py``), so
``wk_e`` and the elite columns of ``wq`` get their gradients through it.

Tensor parallelism (``mesh=``, a ``launch.mesh.TPMesh``, on a pool placed
over it): decode and verify attend through ``kernels/ops.py``'s ``*_tp``
wrappers, each head shard over its own ``k_e`` pages; the block selection
runs once, on the full-head query.  Everything else runs full-head on the
mesh's first device, as at tp 1: the projections, the ``bk``/``bv``
absorption, the ``wo`` contraction and prefill, whose chain gather
reassembles ``k_e`` from the shards first (``_full_heads``, the reference's
``_pin``).  So a logits row's bits do not depend on tp.

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

from repro_torch.core import quant
from repro_torch.core import rope as rope_lib
from repro_torch.core.cache import BLOCK_SUMMARY_SUFFIXES, HEAD_SPLIT, first, put_rows
from repro_torch.distributed.sharding import (einsum, is_dtensor, local_range, matmul,
                                              replicated_like)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import gather_pages
from repro_torch.models.attention import _attend
from repro_torch.models.layers import dense_init

_NOOP = lambda name, x: x


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

def _project(params, cfg, buffers, x, positions, constrain=_NOOP):
    """Rotated elite queries q_e [B,S,nh,2r], linear q_ne [B,S,nh,d_nope],
    rotated k_e [B,S,nkv,2r] and the latents c_k, c_v [B,S,dc] of x [B,S,d]
    at ``positions``: q_e and k_e rotate in one call, query head h with kv
    head ``h // q_group``'s elite frequencies."""
    dt = x.dtype
    r2 = 2 * cfg.elitekv.elite_r
    q = einsum("bsd,dhe->bshe", x, params["wq"].to(dt))
    k_e = einsum("bsd,dhe->bshe", x, params["wk_e"].to(dt))
    q_e, k_e = ops.rope_elite_qk(q[..., :r2], k_e, positions, buffers["elite_freqs"],
                                 cfg.q_group, 1)
    return q_e, q[..., r2:], k_e, *_latents(params, cfg, x, constrain)


def _latents(params, cfg, x, constrain=_NOOP):
    """Down-projected latent(s) (c_k, c_v) — the same tensor under J-LRD —
    constrained as ``latent``."""
    dt = x.dtype
    if cfg.elitekv.lrd == "joint":
        c = constrain("latent", matmul(x, params["a_kv"].to(dt)))
        return c, c
    return (constrain("latent", matmul(x, params["a_k"].to(dt))),
            constrain("latent", matmul(x, params["a_v"].to(dt))))


def _streams(params, cfg, buffers, x, positions, constrain=_NOOP):
    """Rotated queries q [B,S,nh,dh] (constrained as ``attn_q``) and the
    compressed streams the pool stores: k_e [B,S,nkv,2r], c_k, c_v [B,S,dc]
    (one tensor under J-LRD)."""
    q_e, q_ne, *streams = _project(params, cfg, buffers, x, positions, constrain)
    return (constrain("attn_q", torch.cat([q_e, q_ne], dim=-1)), *streams)


def _up_project(params, k_e, c_k, c_v, dt, constrain=_NOOP):
    """Keys and values from the compressed streams: K = [k_e | c_k·bk],
    V = c_v·bv, each [B,S,nkv,dh], constrained as ``attn_kv``."""
    k_ne = einsum("bsc,che->bshe", c_k, params["bk"].to(dt))
    v = constrain("attn_kv", einsum("bsc,che->bshe", c_v, params["bv"].to(dt)))
    return constrain("attn_kv", torch.cat([k_e, k_ne], dim=-1)), v.contiguous()


# ---------------------------------------------------------------------------
# full-sequence forward and the contiguous cache
# ---------------------------------------------------------------------------

def _materialized(params, cfg, buffers, x, positions, constrain=_NOOP):
    """q [B,S,nh,dh], K/V [B,S,nkv,dh] and the streams k_e, c_k, c_v."""
    q, k_e, c_k, c_v = _streams(params, cfg, buffers, x, positions, constrain)
    k, v = _up_project(params, k_e, c_k, c_v, x.dtype, constrain)
    return q, k, v, k_e, c_k, c_v


def apply_full(params, cfg, buffers, x, positions, constrain=_NOOP) -> torch.Tensor:
    """Whole-sequence causal forward, no cache.  → out [B,S,d]."""
    q, k, v, *_ = _materialized(params, cfg, buffers, x, positions, constrain)
    o = _attend(q, k, v, cfg.q_group, cfg.head_dim ** -0.5, chunk_q=cfg.attn_chunk_q,
                constrain=constrain)
    return einsum("bshe,hed->bsd", o, params["wo"].to(x.dtype))


def init_cache(cfg, batch: int, max_len: int, device) -> Dict[str, torch.Tensor]:
    """One layer's f32 cache: k_e [batch, max_len, nkv, 2r] and c
    [batch, max_len, d_ckv] (c_k/c_v under S-LRD)."""
    e = cfg.elitekv
    lead = (batch, max_len)
    cache = {"k_e": torch.zeros(lead + (cfg.n_kv_heads, 2 * e.elite_r), device=device)}
    if e.lrd == "joint":
        cache["c"] = torch.zeros(lead + (e.d_ckv,), device=device)
    else:
        cache["c_k"] = torch.zeros(lead + (e.d_ck,), device=device)
        cache["c_v"] = torch.zeros(lead + (e.d_cv,), device=device)
    return cache


def _cache_latents(cache):
    if "c" in cache:
        return cache["c"], cache["c"]
    return cache["c_k"], cache["c_v"]


def _write_cache(cache, rows, k_e, c_k, c_v) -> None:
    """Write the streams of rows ``rows`` (a slice, or one index:
    ``_put_row``) of the position axis into the cache in place."""
    streams = ((("k_e", k_e), ("c", c_k)) if "c" in cache
               else (("k_e", k_e), ("c_k", c_k), ("c_v", c_v)))
    for name, v in streams:
        if isinstance(rows, int):
            _put_row(cache[name], rows, v)
        else:
            cache[name][:, rows] = v


def _put_row(leaf, index: int, row) -> None:
    """``leaf[:, index] = row`` in place.  On a ``DTensor`` cache leaf each
    rank writes into its own piece, and only where that piece holds row
    ``index`` (over a mesh dim that shards the sequence, one rank of each
    group), with ``row`` placed as the leaf's other dims (``local_map``):
    nothing of the cache moves, where an indexed assignment on a
    sequence-sharded ``DTensor`` could gather it."""
    if not is_dtensor(leaf):
        leaf[:, index] = row
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    start, n = local_range(leaf, 1)
    row_pl = [Replicate() if p == Shard(1) else Shard(p.dim - 1)
              if isinstance(p, Shard) and p.dim > 1 else p for p in leaf.placements]

    def local(leaf_l, row_l):
        if start <= index < start + n:
            leaf_l[:, index - start] = row_l

    local_map(local, out_placements=None, in_placements=(leaf.placements, row_pl),
              device_mesh=leaf.device_mesh, redistribute_inputs=True)(leaf, row)


def apply_prefill(params, cfg, buffers, x, positions, cache,
                  constrain=_NOOP) -> torch.Tensor:
    """Prompts x [B,S,d] at ``positions`` [S]: causal attention over the
    prompt itself; writes cache rows [0, S) in place (a placed cache keeps
    its placements: the rows are redistributed to them).  → out [B,S,d]."""
    B, S = x.shape[:2]
    q, k, v, k_e, c_k, c_v = _materialized(params, cfg, buffers, x, positions, constrain)
    _write_cache(cache, slice(0, S), k_e, c_k, c_v)
    offs = replicated_like(x, torch.zeros(B, dtype=torch.int32, device=x.device))
    lens = replicated_like(x, torch.full((B,), S, dtype=torch.int32, device=x.device))
    o = ops.flash_prefill(q, k, v, cfg.q_group, cfg.head_dim ** -0.5, offs, lens)
    return einsum("bshe,hed->bsd", o, params["wo"].to(x.dtype))


def apply_decode(params, cfg, buffers, x, index: int, cache, constrain=_NOOP) -> torch.Tensor:
    """Absorbed decode over the contiguous cache: x [B,1,d], the token at
    position ``index`` of every lane.  Writes cache row ``index`` in place,
    then attends rows [0, index] through the compressed cache only.
    ``constrain``: the reference's ``attn_q`` on the rotated ``q_e`` and on
    ``q_lat``.  On a placed cache (``DTensor``s, the sequence possibly
    sharded) the row goes to the rank that holds it (``_put_row``) and the
    attention merges the sequence's pieces (``ops.elite_decode``).
    → out [B,1,d]."""
    dt = x.dtype
    B, dev = x.shape[0], x.device
    if is_dtensor(x):      # one position for every lane: the [S] form of the rotation
        pos = replicated_like(x, torch.full((1,), index, dtype=torch.int32, device=dev))
        lengths = replicated_like(x, torch.full((B,), index + 1, dtype=torch.int32,
                                                device=dev))
    else:
        pos = torch.full((B, 1), index, dtype=torch.int32, device=dev)
        lengths = pos[:, 0] + 1
    q_e, q_ne, k_e, c_k, c_v = _project(params, cfg, buffers, x, pos)
    q_e = constrain("attn_q", q_e)
    q_lat = constrain("attn_q", _absorbed_query(params, cfg, q_ne, dt))
    _write_cache(cache, index, k_e[:, 0], c_k[:, 0], c_v[:, 0])
    C_k, C_v = _cache_latents(cache)
    o = ops.elite_decode(q_e[:, 0].contiguous(), q_lat[:, 0].contiguous(), cache["k_e"],
                         C_k, C_v, lengths, cfg.q_group, cfg.head_dim ** -0.5)
    return _absorbed_out(params, cfg, o[:, None], dt)


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
    k_e_new [N,nkv,2r], c_*_new [N,dc].  An int8 pool gets each row
    quantized here, with its scale written to the same slot of
    ``<name>_scale``; a pool with block summaries gets the touched blocks'
    summaries recomputed after the write.  A tensor-parallel pool's shards
    each get their kv heads of ``k_e`` (quantized whole: a scale is per
    slot) and every copy of the replicated leaves all of theirs
    (``cache.put_rows``)."""
    rows, slots = writes
    quantized = "k_e_scale" in pages

    def put(name, val):
        val = val[rows]
        if quantized:
            val, s = quant.quantize_rows(val)
            put_rows(name + "_scale", pages[name + "_scale"], 0, slots, s)
        put_rows(name, pages[name], 0, slots, val.to(first(pages[name]).dtype))

    put("k_e", k_e_new)
    if "c" in pages:
        put("c", c_k_new)
    else:
        put("c_k", c_k_new)
        put("c_v", c_v_new)
    key = _latent_key(pages)
    if key + BLOCK_SUMMARY_SUFFIXES[0] in pages and slots.numel():
        _update_block_summaries(pages, key, slots)


def _latent_key(pages) -> str:
    """The latent key stream, the one block summaries describe."""
    return "c" if "c" in pages else "c_k"


def _update_block_summaries(pages, key: str, slots: torch.Tensor) -> None:
    """Recompute the summaries of every block a scatter touched: the masked
    mean and absmax over the block's valid rows of the just-written (and,
    in an int8 pool, dequantized) ``key`` stream.  A block's valid height is
    its largest offset written in this call plus one, since writes within a
    block are sequential.  Each touched block is written once: on the card
    ``index_copy_`` with a repeated index has no defined winner.  A
    tensor-parallel pool's summaries are computed once, from the first copy
    of the latent, and written to every copy."""
    n_blocks = first(pages[key + BLOCK_SUMMARY_SUFFIXES[0]]).shape[0]
    latent = first(pages[key])
    bs = latent.shape[0] // n_blocks
    blk = slots // bs
    height = torch.zeros(n_blocks, dtype=slots.dtype, device=slots.device)
    height.scatter_reduce_(0, blk, slots % bs + 1, "amax")
    blocks = torch.unique(blk)
    counts = height[blocks]
    idx = blocks[:, None] * bs + torch.arange(bs, device=slots.device)[None, :]
    content = latent[idx].float()                            # [U, bs, dc]
    if key + "_scale" in pages:
        content = content * first(pages[key + "_scale"])[idx][..., None]
    mask = (torch.arange(bs, device=slots.device)[None, :] < counts[:, None])[..., None]
    zero = torch.zeros((), device=content.device)
    mean = torch.where(mask, content, zero).sum(1) / counts.clamp(min=1)[:, None].float()
    amax = torch.where(mask, content.abs(), zero).amax(1)
    for sfx, val in zip(BLOCK_SUMMARY_SUFFIXES, (mean, amax)):
        put_rows(key + sfx, pages[key + sfx], 0, blocks, val)


def _page_latents(pages):
    if "c" in pages:
        return pages["c"], pages["c"]
    return pages["c_k"], pages["c_v"]


def _page_scales(pages):
    """Per-slot scales ``(k_e, c_k, c_v)`` of an int8 pool, None for an f32
    one.  J-LRD's single latent serves both roles with one scale."""
    if "k_e_scale" not in pages:
        return None
    if "c" in pages:
        return pages["k_e_scale"], pages["c_scale"], pages["c_scale"]
    return pages["k_e_scale"], pages["c_k_scale"], pages["c_v_scale"]


def _gather_chain(pages, params, block_tables, block_size: int, dt):
    """Contiguous K/V of each lane's cached chain: block_tables [B, mb] →
    K [B, mb·bs, nkv, dh], V [B, mb·bs, nkv, dh].  Positions past a lane's
    live length land on blocks of other sequences (or the pad block 0); the
    caller masks them by ``kv_lens``.  A tensor-parallel pool's ``k_e`` is
    reassembled with every kv head on the tables' device before anything
    is computed from it (``_full_heads``)."""
    gather = lambda a: gather_pages(first(a), block_tables, block_size)
    k_e = _full_heads(pages[HEAD_SPLIT], block_tables, block_size).to(dt)
    c_k_pages, c_v_pages = _page_latents(pages)
    c_k = gather(c_k_pages).to(dt)
    c_v = c_k if c_v_pages is c_k_pages else gather(c_v_pages).to(dt)
    scales = _page_scales(pages)
    if scales is not None:                # int8 pool: dequantize the chain
        ks, cks, cvs = (gather(a).to(dt) for a in scales)
        shared = c_v is c_k
        k_e, c_k = k_e * ks[..., None, None], c_k * cks[..., None]
        c_v = c_k if shared else c_v * cvs[..., None]
    return _up_project(params, k_e, c_k, c_v, dt)


def _full_heads(leaf, block_tables, block_size: int):
    """``k_e`` of each lane's chain with every kv head, ``[B, mb·bs, nkv,
    2r]`` on the tables' device: a tensor-parallel pool's shards gathered,
    copied there and concatenated in shard order.  The reference's ``_pin``
    of its prefix gather to replicated: prefill runs full-head on one
    device, so the cross-head ``wo`` sum keeps the single-device order."""
    if torch.is_tensor(leaf):
        return gather_pages(leaf, block_tables, block_size)
    dev = block_tables.device
    return torch.cat([gather_pages(t, block_tables.to(t.device), block_size).to(dev)
                      for t in leaf], 2)


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
    q, k_e, c_k, c_v = _streams(params, cfg, buffers, x, positions)
    _scatter_new(pages, k_e, c_k, c_v, writes)
    scale = cfg.head_dim ** -0.5
    if block_tables is None:
        if "k_e_scale" in pages:
            # int8 pool: attend over what later pool reads will dequantize
            rt = lambda a: quant.roundtrip_rows(a, batch_dims=2)
            shared = c_v is c_k
            k_e, c_k = rt(k_e), rt(c_k)
            c_v = c_k if shared else rt(c_v)
        k, v = _up_project(params, k_e, c_k, c_v, dt)
        offs = torch.zeros(B, dtype=torch.int32, device=x.device)
        lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
        o = ops.flash_prefill(q, k, v, cfg.q_group, scale, offs, lens)
    else:
        k_all, v_all = _gather_chain(pages, params, block_tables, block_size, dt)
        o = ops.flash_prefill(q, k_all, v_all, cfg.q_group, scale,
                              prefix_lens, kv_lens)
    return torch.einsum("bshe,hed->bsd", o, params["wo"].to(dt))


def _q_heads(per_kv, q_group: int, wo):
    """``rope.expand_kv_to_q``: [nkv, ...] → [nh, ...], query head h with kv
    head ``h // q_group``'s rows.  On a ``DTensor`` each rank takes its own
    query heads' rows from its kv heads (sharded with them, or replicated)
    without communication, placed with the heads sharded as ``wo``'s (the
    query heads' weight)."""
    if not is_dtensor(per_kv):
        return rope_lib.expand_kv_to_q(per_kv, q_group)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = per_kv.device_mesh
    hd = [i for i, p in enumerate(wo.placements) if p == Shard(0)]
    out_pl = [Shard(0) if i in hd else Replicate() for i in range(mesh.ndim)]
    in_pl = [p if (i in hd and p == Shard(0)) else Replicate()
             for i, p in enumerate(per_kv.placements)]
    nh = per_kv.shape[0] * q_group

    def local(w):
        if not hd:
            return rope_lib.expand_kv_to_q(w, q_group)
        hq = nh // mesh.size(hd[0])
        q0 = mesh.get_coordinate()[hd[0]] * hq
        first_kv = q0 // q_group if in_pl[hd[0]] == Shard(0) else 0
        idx = torch.arange(q0, q0 + hq, device=w.device) // q_group - first_kv
        return w.index_select(0, idx)

    return local_map(local, out_placements=out_pl, in_placements=(in_pl,), device_mesh=mesh,
                     redistribute_inputs=True)(per_kv)


def _absorbed_query(params, cfg, q_ne, dt):
    """The bk-absorbed latent queries q_lat [B,S,nh,dc] of the linear
    queries q_ne [B,S,nh,d_nope]."""
    bk_q = _q_heads(params["bk"].permute(1, 0, 2), cfg.q_group, params["wo"])  # [nh,dc,dn]
    return einsum("bshn,hcn->bshc", q_ne, bk_q.to(dt))


def _scatter_new(pages, k_e, c_k, c_v, writes: Writes) -> None:
    """Write the compressed streams k_e [B,S,nkv,2r], c_k, c_v [B,S,dc]
    into the pool, row ``b·S + s`` to its slot in ``writes``."""
    B, S = k_e.shape[:2]
    _scatter_pages(pages, k_e.reshape(B * S, *k_e.shape[2:]),
                   c_k.reshape(B * S, -1), c_v.reshape(B * S, -1), writes)


def _absorbed_out(params, cfg, o, dt):
    """Latent attention output o [B,S,nh,dc] → o·bv·wo [B,S,d]."""
    bv_q = _q_heads(params["bv"].permute(1, 0, 2), cfg.q_group, params["wo"])  # [nh,dc,dh]
    o_heads = einsum("bqhc,hcd->bqhd", o.to(dt), bv_q.to(dt))
    return einsum("bshe,hed->bsd", o_heads, params["wo"].to(dt))


def apply_decode_paged(params, cfg, buffers, x, pages, writes: Writes,
                       block_tables, lengths, block_size: int,
                       sparse_topk: int = 0, sparse_recent: int = 0, mesh=None):
    """Absorbed decode over the block pool — one token per serving lane.

    x [B,1,d]; lengths [B] int32, the live length *including* the new token
    (0 for idle lanes, whose writes hit the sentinel and whose attention
    output is zero); block_tables [B,mb] int32.  ``sparse_topk > 0`` attends
    only the ``min(sparse_topk + sparse_recent, mb)`` blocks that
    ``select_topk_blocks`` picks from the pool's block summaries (written by
    the scatter below, so the new token's block is current); it needs a
    ``block_summaries=True`` pool.  ``mesh`` (a ``TPMesh`` over which
    ``pages`` are placed) runs the attention head-sharded (``ops.*_tp``);
    the selection runs once, on the full-head ``q_lat``, so every shard
    walks the same blocks.
    → out [B,1,d]; ``pages`` updated in place.
    """
    dt = x.dtype
    B = x.shape[0]
    nh, dh, G = cfg.n_heads, cfg.head_dim, cfg.q_group
    pos = (lengths - 1)[:, None]                             # [B,1] per lane
    q_e, q_ne, *streams = _project(params, cfg, buffers, x, pos)
    q_lat = _absorbed_query(params, cfg, q_ne, dt)
    _scatter_new(pages, *streams, writes)

    C_k, C_v = _page_latents(pages)
    q_e = q_e.reshape(B, nh, -1).contiguous()
    q_lat = q_lat.reshape(B, nh, -1).contiguous()
    if sparse_topk > 0:
        key = _latent_key(pages)
        num_sel = min(sparse_topk + sparse_recent, block_tables.shape[1])
        walk = ops.select_topk_blocks(
            q_lat, *(first(pages[key + sfx]) for sfx in BLOCK_SUMMARY_SUFFIXES),
            block_tables, lengths, block_size, num_sel, sparse_recent)
        fn = ops.elite_decode_sparse_paged_tp
    else:
        walk = (block_tables, lengths)
        fn = ops.elite_decode_paged_tp
    o = fn(q_e, q_lat, pages[HEAD_SPLIT], C_k, C_v, _page_scales(pages), *walk, G,
           dh ** -0.5, block_size, mesh)
    return _absorbed_out(params, cfg, o.reshape(B, 1, nh, -1), dt)


def apply_verify_paged(params, cfg, buffers, x, pages, writes: Writes,
                       block_tables, q_offsets, lengths, block_size: int, mesh=None):
    """Absorbed multi-query verify for speculative decode: one forward
    scores each lane's window of ``W = k+1`` tokens (the pending token and
    ``k`` draft proposals) against its paged prefix and the window itself.

    x [B,W,d]; lane ``b``'s window starts at position ``q_offsets[b]`` (its
    cached prefix length) and ``lengths[b]`` is its live length including
    the window's valid tokens (0 for an idle lane, whose output is zero);
    ``writes`` maps the window rows to their slots (padding and idle lanes
    to the sentinel); block_tables [B,mb] int32.  The window's compressed
    streams are scattered into the pool first, as decode does (an int8 pool
    quantizes them there), so row ``w`` attends to the stored window tokens
    up to its own position.  Rejected tokens are later rolled back by
    truncating the chain, never by rewriting pages.  A pool with block
    summaries is refused: sparse decode and speculation are exclusive.
    ``mesh`` runs the attention head-sharded, as in ``apply_decode_paged``.
    → out [B,W,d]; ``pages`` updated in place.
    """
    if _latent_key(pages) + BLOCK_SUMMARY_SUFFIXES[0] in pages:
        raise ValueError("speculative verify over a pool with block summaries: "
                         "sparse decode and speculative decode are exclusive")
    dt = x.dtype
    B, W = x.shape[:2]
    nh, dh, G = cfg.n_heads, cfg.head_dim, cfg.q_group
    pos = q_offsets[:, None] + torch.arange(W, device=x.device)[None, :]   # [B,W]
    q_e, q_ne, *streams = _project(params, cfg, buffers, x, pos)
    q_lat = _absorbed_query(params, cfg, q_ne, dt)
    _scatter_new(pages, *streams, writes)

    C_k, C_v = _page_latents(pages)
    o = ops.elite_verify_paged_tp(q_e.contiguous(), q_lat.contiguous(), pages[HEAD_SPLIT],
                                  C_k, C_v, _page_scales(pages), block_tables, q_offsets,
                                  lengths, G, dh ** -0.5, block_size, mesh)
    return _absorbed_out(params, cfg, o, dt)
