"""Plain PyTorch versions of the hand-written CUDA kernels.

They compute the same functions as the JAX package's ``kernels/ref.py``
oracles and serve two purposes: the kernel wrappers take them for tensors
that lie on the CPU, and tests and ``chip_smoke.py`` hold each CUDA kernel
against them on the card.  Rows with no visible key output exact zeros.

On the CPU the decode and verify versions make the kv head a batch axis
of every product (the head-shared latent broadcast over it), so each head's
rows are computed by the same batched product whatever the number of heads
in the call: a head shard's call (``ops.*_tp``) gives the unsharded call's
bits.  On the card they fold the heads into one product per lane
(``_per_head``).
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import dequantize

NEG_INF = -1e30


def _decode_masked(q_e, q_lat, k_e, c_k, c_v, valid, q_group: int,
                   scale: float, return_lse: bool = False):
    """Decode-attention core with an explicit key-validity mask
    ``valid [B, 1, S]``; ``return_lse`` also gives each row's log-sum-exp
    of its valid scaled scores [B, nh] (-inf for a row with none)."""
    B, nh, r2 = q_e.shape
    S, nkv = k_e.shape[1], k_e.shape[2]
    s_e = _per_head(q_e.reshape(B, nkv, q_group, r2), k_e.permute(0, 2, 3, 1))
    s_lat = _per_head(q_lat.reshape(B, nkv, q_group, -1), c_k.transpose(1, 2))
    s = ((s_e + s_lat) * scale).reshape(B, nh, S)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # rows with no visible key (empty serving slots) attend to nothing
    seen = valid.any(dim=-1, keepdim=True)
    p = torch.where(seen, p, torch.zeros_like(p))
    o = _per_head(p.to(c_v.dtype).reshape(B, nkv, q_group, S), c_v).reshape(B, nh, -1)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1)
    return o, torch.where(seen[..., 0], lse, torch.full_like(lse, -torch.inf))


def _per_head(x, y):
    """``x [B, nkv, M, K] @ y`` → ``[B, nkv, M, N]``, ``y`` per kv head
    ``[B, nkv, K, N]`` or head-shared ``[B, K, N]``.  A head-shared ``y``
    is multiplied in one of two forms with the same math.  On the CPU,
    where the plain version is the computation, one product per (lane, kv
    head), both operands contiguous, so a head's bits do not depend on how
    many heads the call holds (with one head the broadcast is a view, and a
    strided operand would take another product routine).  On the card,
    where it is the kernels' yardstick, the heads fold into the rows of one
    product per lane: a per-head product of one row runs as a GEMV whose
    rounding parts from the kernels' by more than their checks allow
    (PERF.md, the tensor-parallel attention entry)."""
    if y.dim() == 4:
        return x.contiguous() @ y.contiguous()
    if x.is_cuda:
        B, nkv, M, K = x.shape
        return (x.reshape(B, nkv * M, K) @ y).reshape(B, nkv, M, -1)
    return x.contiguous() @ y.contiguous()[:, None]


def elite_decode_ref(q_e, q_lat, k_e, c_k, c_v, lengths, q_group: int,
                     scale: float, return_lse: bool = False):
    """Absorbed EliteKV decode attention over a contiguous cache.

    q_e [B,nh,2r], q_lat [B,nh,dc], k_e [B,S,nkv,2r], c_k/c_v [B,S,dc],
    lengths [B] int32 → [B,nh,dc]; ``return_lse`` → (that, lse [B,nh]):
    each row's natural log-sum-exp of its scaled scores over rows
    ``< lengths``, -inf for a lane with none.
    """
    S = k_e.shape[1]
    valid = torch.arange(S, device=k_e.device)[None, None, :] < lengths[:, None, None]
    return _decode_masked(q_e, q_lat, k_e, c_k, c_v, valid, q_group, scale, return_lse)


def merge_weights(lse, top):
    """A piece's weight in the merge: ``e^(lse - top)``, ``top`` the largest
    lse over the pieces, and 0 where the piece's lse is -inf (so a row no
    piece saw weighs 0 everywhere)."""
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lse - top)
    return torch.where(torch.isfinite(lse), w, torch.zeros_like(w))


def merge_lse(os, lses) -> torch.Tensor:
    """Merge decode outputs of pieces of one cache, each attended apart
    with its log-sum-exp (``elite_decode(..., return_lse=True)`` on a
    slice of the rows): ``o = sum_p o_p w_p / max(sum_p w_p, 1e-30)`` with
    ``merge_weights``' ``w_p``.  ``os`` [P or a list of P] of [B, nh, dc],
    ``lses`` of [B, nh] → [B, nh, dc]; rows no piece saw give 0.  The
    sequence-sharded decode (``kernels/ops.py``) computes the same sums
    with two all-reduces."""
    os, lses = torch.stack(list(os)), torch.stack(list(lses))
    w = merge_weights(lses, lses.max(dim=0).values)[..., None]
    return (os * w).sum(dim=0) / w.sum(dim=0).clamp(min=1e-30)


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


def select_topk_blocks(q_lat, blk_mean, blk_max, block_tables, lengths,
                       block_size: int, num_sel: int, recent: int):
    """Score each lane's resident blocks in latent space and pick the top
    ``num_sel`` (the ``recent`` newest forced in).  Plain torch ops on either
    device: the reference runs this selection as plain jnp, not as a kernel.

    q_lat [B,nh,dc] (all heads); blk_mean/blk_max [n_blocks,dc] f32 block
    summaries; block_tables [B,mb] int32; lengths [B] int32.
    score_j = Σ_h q_lat·mean_j + |q_lat|·absmax_j; resident blocks outside the
    tail keep it, the tail scores 1e30 and non-resident entries -1e30.  Ties
    go to the lower logical index, as ``jax.lax.top_k`` breaks them: a
    stable descending sort, then the winners sorted ascending so the kernels
    walk them in chain order.  Each block's score is its own row reduction,
    so blocks with equal summaries score exactly equal.
    → (sel_tables [B,W] int32 physical block ids, sel_counts [B,W] int32
    valid rows per block), W = min(num_sel, mb).  With W >= the chain the
    selection is the whole table and the count mask the dense length mask.
    """
    B, mb = block_tables.shape
    bs = block_size
    bt = block_tables.long()
    n_chain = (lengths.long() + bs - 1) // bs                 # [B]
    j = torch.arange(mb, device=bt.device)[None, :]           # logical index
    q = q_lat.float()
    score = ((blk_mean[bt] * q.sum(1)[:, None, :]).sum(-1)
             + (blk_max[bt] * q.abs().sum(1)[:, None, :]).sum(-1))   # [B, mb]
    resident = j < n_chain[:, None]
    tail = resident & (j >= n_chain[:, None] - recent)
    score = torch.where(resident, score, torch.full_like(score, NEG_INF))
    score = torch.where(tail, torch.full_like(score, -NEG_INF), score)
    order = torch.sort(score, dim=-1, descending=True, stable=True)[1]
    sel = torch.sort(order[:, :min(num_sel, mb)], dim=-1)[0]
    sel_tables = torch.gather(bt, 1, sel).to(torch.int32)
    sel_counts = (lengths.long()[:, None] - sel * bs).clamp(0, bs).to(torch.int32)
    return sel_tables, sel_counts


def _sparse_valid(sel_counts, block_size: int):
    """[B, W] per-block counts → [B, 1, W·bs] row-validity mask; for the full
    chain it equals the dense ``pos < length`` mask elementwise."""
    offs = torch.arange(block_size, device=sel_counts.device).repeat(sel_counts.shape[1])
    counts = sel_counts.repeat_interleave(block_size, dim=1)     # [B, W·bs]
    return (offs[None, :] < counts)[:, None, :]


def elite_decode_sparse_paged_ref(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                                  sel_tables, sel_counts, q_group: int,
                                  scale: float, block_size: int) -> torch.Tensor:
    """Sparse paged decode: gather only the selected blocks, then the masked
    core.  sel_tables/sel_counts [B,W] from ``select_topk_blocks``; a count
    of 0 contributes nothing.  A full-width selection gathers the same arrays
    under the same mask as ``elite_decode_paged_ref``: the same bits."""
    return _decode_masked(q_e, q_lat,
                          gather_pages(k_e_pages, sel_tables, block_size),
                          gather_pages(c_k_pages, sel_tables, block_size),
                          gather_pages(c_v_pages, sel_tables, block_size),
                          _sparse_valid(sel_counts, block_size), q_group, scale)


def dequantize_pages(k_e_pages, c_k_pages, c_v_pages, k_e_scale, c_k_scale,
                     c_v_scale):
    """An int8 pool's streams as f32: each row times its slot's scale."""
    return (dequantize(k_e_pages, k_e_scale), dequantize(c_k_pages, c_k_scale),
            dequantize(c_v_pages, c_v_scale))


def elite_decode_paged_q8_ref(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                              k_e_scale, c_k_scale, c_v_scale, block_tables,
                              lengths, q_group: int, scale: float,
                              block_size: int) -> torch.Tensor:
    """Int8-pool decode: dequantize every slot, then the f32 paged version.
    Pages int8, scales [n_slots] f32; the output is f32."""
    return elite_decode_paged_ref(
        q_e, q_lat, *dequantize_pages(k_e_pages, c_k_pages, c_v_pages, k_e_scale,
                                      c_k_scale, c_v_scale),
        block_tables, lengths, q_group, scale, block_size)


def elite_decode_sparse_paged_q8_ref(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                                     k_e_scale, c_k_scale, c_v_scale, sel_tables,
                                     sel_counts, q_group: int, scale: float,
                                     block_size: int) -> torch.Tensor:
    """Int8-pool sparse decode: dequantize, then the f32 sparse version."""
    return elite_decode_sparse_paged_ref(
        q_e, q_lat, *dequantize_pages(k_e_pages, c_k_pages, c_v_pages, k_e_scale,
                                      c_k_scale, c_v_scale),
        sel_tables, sel_counts, q_group, scale, block_size)


def elite_verify_ref(q_e, q_lat, k_e, c_k, c_v, q_offsets, lengths,
                     q_group: int, scale: float) -> torch.Tensor:
    """Multi-query absorbed verify attention (speculative decode) over a
    contiguous cache.

    Query row ``w`` of lane ``b`` sits at position ``q_offsets[b] + w`` and
    sees key ``j`` iff ``j <= q_offsets[b] + w`` and ``j < lengths[b]``.
    q_e [B,W,nh,2r], q_lat [B,W,nh,dc], k_e [B,S,nkv,2r], c_k/c_v [B,S,dc],
    q_offsets/lengths [B] int32 → [B,W,nh,dc].  ``W == 1`` with
    ``q_offsets == lengths - 1`` is ``elite_decode_ref``; rows with no
    visible key (``lengths == 0`` lanes) give exact zeros.
    """
    B, W, nh, r2 = q_e.shape
    S, nkv = k_e.shape[1], k_e.shape[2]
    G = q_group
    rows = lambda t: t.reshape(B, W, nkv, G, -1).permute(0, 2, 3, 1, 4).reshape(
        B, nkv, G * W, -1)
    s_e = _per_head(rows(q_e), k_e.permute(0, 2, 3, 1))
    s_lat = _per_head(rows(q_lat), c_k.transpose(1, 2))
    s = ((s_e + s_lat) * scale).reshape(B, nkv, G, W, S)
    kpos = torch.arange(S, device=k_e.device)[None, None, :]
    wpos = torch.arange(W, device=k_e.device)[None, :, None]
    mask = ((kpos <= wpos + q_offsets[:, None, None])
            & (kpos < lengths[:, None, None]))[:, None, None]   # [B,1,1,W,S]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    o = _per_head(p.to(c_v.dtype).reshape(B, nkv, G * W, S), c_v)
    return o.reshape(B, nkv, G, W, -1).permute(0, 3, 1, 2, 4).reshape(B, W, nh, -1)


def elite_verify_paged_ref(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                           block_tables, q_offsets, lengths, q_group: int,
                           scale: float, block_size: int) -> torch.Tensor:
    """Paged verify attention: gather each lane's chain, then the contiguous
    version.  Pages as in ``elite_decode_paged_ref``; q_e/q_lat
    [B,W,nh,*], q_offsets/lengths [B] int32 → [B,W,nh,dc]."""
    return elite_verify_ref(q_e, q_lat,
                            gather_pages(k_e_pages, block_tables, block_size),
                            gather_pages(c_k_pages, block_tables, block_size),
                            gather_pages(c_v_pages, block_tables, block_size),
                            q_offsets, lengths, q_group, scale)


def elite_verify_paged_q8_ref(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                              k_e_scale, c_k_scale, c_v_scale, block_tables,
                              q_offsets, lengths, q_group: int, scale: float,
                              block_size: int) -> torch.Tensor:
    """Int8-pool verify: dequantize every slot, then the f32 paged verify."""
    return elite_verify_paged_ref(
        q_e, q_lat, *dequantize_pages(k_e_pages, c_k_pages, c_v_pages, k_e_scale,
                                      c_k_scale, c_v_scale),
        block_tables, q_offsets, lengths, q_group, scale, block_size)


def split_merge_ref(q_e, q_lat, k_e, c_k, c_v, valid, q_group: int, scale: float,
                    tile: int, tiles_per_split: int) -> torch.Tensor:
    """Absorbed attention cut as the split-KV kernel cuts it: each range of
    ``tiles_per_split`` tiles of ``tile`` positions gives a partial
    (m, l, acc) per query row, and the partials merge in ascending order:
    ``M = max m_i``, ``l = Σ l_i·e^(m_i−M)``, ``o = Σ acc_i·e^(m_i−M) /
    max(l, 1e-30)``, a partial with ``l_i = 0`` adding nothing.

    q_e [B,W,nh,2r], q_lat [B,W,nh,dc]; per-lane rows k_e [B,P,nkv,2r],
    c_k/c_v [B,P,dc]; valid [B,W,P] bool → [B,W,nh,dc]; rows with no
    visible key give exact zeros."""
    B, W, nh, r2 = q_e.shape
    P, nkv = k_e.shape[1], k_e.shape[2]
    span = tile * tiles_per_split
    heads = lambda t: t.reshape(B, W, nkv, q_group, -1).transpose(1, 2).reshape(
        B, nkv, W * q_group, -1)
    qe_h, ql_h = heads(q_e), heads(q_lat)
    parts = []
    for start in range(0, P, span):
        # each range scored on its own rows, padded to the full span, so a
        # range's arithmetic does not depend on the walk's width
        sl = slice(start, start + span)
        pad = span - k_e[:, sl].shape[1]
        rows = [torch.cat([t[:, sl], t.new_zeros((B, pad) + t.shape[2:])], 1)
                for t in (k_e, c_k, c_v)]
        v = torch.cat([valid[:, :, sl], valid.new_zeros(B, W, pad)], 2)[:, :, None, :]
        s_e = _per_head(qe_h, rows[0].permute(0, 2, 3, 1))        # [B,nkv,W·G,span]
        s_lat = _per_head(ql_h, rows[1].transpose(1, 2))
        sv = _heads_last((s_e + s_lat) * scale, W)
        v = v.expand_as(sv)
        m = torch.where(v, sv, torch.full_like(sv, NEG_INF)).amax(-1)
        p = torch.where(v, torch.exp(sv - m[..., None]), torch.zeros_like(sv))
        p_h = p.reshape(B, W, nkv, q_group, span).transpose(1, 2)
        acc = _per_head(p_h.reshape(B, nkv, W * q_group, span), rows[2])
        parts.append((m, p.sum(-1), _heads_last(acc, W)))
    M = torch.full_like(parts[0][0], NEG_INF)
    for m, l, _ in parts:
        M = torch.where(l > 0, torch.maximum(M, m), M)
    lsum = torch.zeros_like(M)
    o = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp(m - M), torch.zeros_like(m))
        lsum = lsum + l * w
        o = o + acc * w[..., None]
    return o / torch.clamp(lsum, min=1e-30)[..., None]


def _heads_last(x, W: int):
    """``[B, nkv, W·G, N]`` (window-major rows) → ``[B, W, nkv·G, N]``."""
    B, nkv, R, N = x.shape
    return x.reshape(B, nkv, W, R // W, N).transpose(1, 2).reshape(B, W, -1, N)


def split_call_ref(name: str, args, tiles_per_split: int, tile: int = 16,
                   part: int = 0) -> torch.Tensor:
    """The call ``ops.<name>(*args)`` of a decode or verify entry, split by a
    plan of ``tiles_per_split`` tiles and merged as the kernel merges:
    each lane's walk gathered to contiguous rows (a chain block, a selected
    block or ``tile`` rows of a contiguous cache per tile), int8 pages
    dequantized first.  ``part`` cuts a verify window into parts of that
    many positions, each scored on its own with its offsets shifted, as the
    kernel's CTAs of a cut window score them."""
    if name.endswith("_q8"):
        args = (*args[:2], *dequantize_pages(*args[2:8]), *args[8:])
        name = name[:-3]
    q_e, q_lat, k_e, c_k, c_v = args[:5]
    dev = k_e.device
    if name == "elite_decode":
        lengths, G, scale = args[5:8]
        S = k_e.shape[1]
        valid = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None]
        return split_merge_ref(q_e[:, None], q_lat[:, None], k_e, c_k, c_v, valid, G,
                               scale, tile, tiles_per_split)[:, 0]
    bs = args[-1]
    G, scale = args[-3], args[-2]
    table = args[5]
    rows = [gather_pages(p, table, bs) for p in (k_e, c_k, c_v)]
    P = rows[0].shape[1]
    pos = torch.arange(P, device=dev)[None, None, :]
    if name == "elite_decode_paged":
        valid = pos < args[6][:, None, None]
    elif name == "elite_decode_sparse_paged":
        valid = _sparse_valid(args[6], bs)
    elif name == "elite_verify_paged":
        offs, lengths = args[6], args[7]
        W = q_e.shape[1]
        outs = []
        for w0 in range(0, W, part or W):
            w = torch.arange(w0, min(w0 + (part or W), W), device=dev)[None, :, None]
            valid = (pos <= offs[:, None, None] + w) & (pos < lengths[:, None, None])
            sl = slice(w0, w0 + w.shape[1])
            outs.append(split_merge_ref(q_e[:, sl], q_lat[:, sl], *rows, valid, G, scale,
                                        bs, tiles_per_split))
        return torch.cat(outs, 1)
    else:
        raise ValueError(f"no split reference for {name}")
    return split_merge_ref(q_e[:, None], q_lat[:, None], *rows, valid, G, scale, bs,
                           tiles_per_split)[:, 0]


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


def flash_split_ref(q, k, v, q_group: int, scale: float, q_offsets, kv_lens,
                    range_keys: int = 128) -> torch.Tensor:
    """``flash_prefill_ref`` cut as the kernel's decode body cuts it: each
    range of ``range_keys`` keys gives a partial (m, l, acc) per query row,
    and the partials merge in ascending order: ``M = max m_i`` over ranges
    with ``l_i > 0``, ``o = Σ acc_i·e^(m_i−M) / max(Σ l_i·e^(m_i−M), 1e-30)``,
    a range with ``l_i = 0`` skipped.  Same arguments and result."""
    B, Sq, nh, dh = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, nkv, q_group, dh)
    if Sk == 0:
        return torch.zeros_like(q)
    qpos = torch.arange(Sq, device=q.device)[None, :, None]
    parts = []
    for start in range(0, Sk, range_keys):
        kpos = torch.arange(start, min(start + range_keys, Sk), device=q.device)[None, None, :]
        vis = (kpos <= qpos + q_offsets[:, None, None]) & (kpos < kv_lens[:, None, None])
        vis = vis[:, None, None]                              # [B,1,1,Sq,n]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k[:, start:start + range_keys]) * scale
        m = torch.where(vis, s, torch.full_like(s, NEG_INF)).amax(-1)
        p = torch.where(vis, torch.exp(s - m[..., None]), torch.zeros_like(s))
        acc = torch.einsum("bhgqk,bkhd->bhgqd", p, v[:, start:start + range_keys])
        parts.append((m, p.sum(-1), acc))
    M = torch.full_like(parts[0][0], NEG_INF)
    for m, l, _ in parts:
        M = torch.where(l > 0, torch.maximum(M, m), M)
    lsum = torch.zeros_like(M)
    o = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp(m - M), torch.zeros_like(m))
        lsum = lsum + l * w
        o = o + acc * w[..., None]
    o = o / torch.clamp(lsum, min=1e-30)[..., None]          # [B,nkv,G,Sq,dh]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, nh, dh)


def cos_sin(positions: torch.Tensor, freqs: torch.Tensor):
    """cos/sin tables: positions [...P] (int or float), freqs [...F] →
    cos, sin [...P, ...F] (outer product over the trailing freq axes), the
    angles taken in f32."""
    ang = positions.reshape(positions.shape + (1,) * freqs.dim()).float() * freqs
    return torch.cos(ang), torch.sin(ang)


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


def rope_elite_ref(x, positions, freqs, transpose: bool = False) -> torch.Tensor:
    """Per-head rotary on packed elite dims.

    x [B,S,H,2r], positions [S] or [B,S], freqs [H,r] → rotated x.
    ``transpose`` rotates by the negated angles (sin negated): the
    rotation's transpose, which maps the output's gradient to the input's.
    """
    B, S, H, r2 = x.shape
    assert tuple(freqs.shape) == (H, r2 // 2), (tuple(freqs.shape), (H, r2 // 2))
    cos, sin = cos_sin(positions, freqs)       # [S,H,r] or [B,S,H,r]
    return rotate(x, cos, -sin if transpose else sin)


def rope_elite_qk_ref(q, k, positions, freqs, q_per_row: int, k_per_row: int,
                      transpose: bool = False):
    """q and k rotated at the same positions: query head h with freqs row
    ``h // q_per_row``, key head h with row ``h // k_per_row``.

    q [B,S,Hq,2r], k [B,S,Hk,2r], positions [S] or [B,S], freqs [R,r] with
    Hq = R·q_per_row and Hk = R·k_per_row → (q_rot, k_rot); ``transpose``
    as in ``rope_elite_ref`` (the kernel's backward mode).
    """
    return (rope_elite_ref(q, positions, freqs.repeat_interleave(q_per_row, 0), transpose),
            rope_elite_ref(k, positions, freqs.repeat_interleave(k_per_row, 0), transpose))
