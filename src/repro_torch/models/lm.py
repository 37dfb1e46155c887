"""Decoder-only LM (attention + SwiGLU MLP; EliteKV or baseline GQA
attention).

Counterpart of the JAX package's ``models/lm.py`` for attention-only
stacks.  Parameters are nested dicts of tensors; the JAX package's stacked
``n_super`` layer axis becomes a list of per-layer dicts, driven by a Python
loop where JAX uses ``lax.scan``:

    params  = {"embed": {"table"}, "lm_head": {"w"}, "final_norm": {"scale"},
               "layers": [{"attn_norm", "attn", "ffn_norm", "ffn"}, ...]}
    buffers = {"layers": [{"elite_freqs"}, ...]}   ({} per layer for GQA)

(no ``lm_head`` when ``cfg.tie_embeddings``: the logits are then
``h @ embed.table^T``).

Entry points over the block-paged pool (EliteKV only):
  * ``apply_prefill_paged`` — prefill prompts (or per-lane chunks) into the pool.
  * ``apply_decode_paged``  — one token per serving lane against the pool.
  * ``apply_verify_paged``  — a speculative window of ``W`` tokens per lane
    against the pool, in one forward.
Entry points over a contiguous cache (EliteKV or baseline, lockstep):
  * ``init_cache``    — the f32 cache ``{"index", "blocks": {"p0": ...}}``.
  * ``apply_prefill`` — prompts from position 0, filling the cache.
  * ``apply_decode``  — one token per lane at position ``cache["index"]``.
  * ``apply_train``   — the whole-sequence forward without a cache: the
    training forward (differentiable on either device) and the oracle of
    cache-on == cache-off.
  * ``loss_fn``       — mean next-token cross-entropy of ``apply_train``
    (sequence-chunked at ``cfg.loss_chunk``), what training differentiates.
  * ``capture_attn_inputs`` — each layer's normed attention input of a
    baseline forward, which the RoPElite search reads.
All return f32 logits over the padded vocab (padding columns = -1e30) and
write the pool pages or the cache in place.  ``make_draft_params`` derives
the rank-truncated draft model of self-speculative decode.

Under grad the training forward recomputes its layers in the backward as
``cfg.remat``/``cfg.remat_policy`` say (the reference's ``jax.checkpoint``
of a layer): "full" keeps only each layer's input, "dots" also the matmul
outputs (a selective checkpoint), "none" keeps everything.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core import elite_attention, lrd
from repro_torch.models import attention
from repro_torch.models.layers import (cross_entropy, dense_init, embed, mlp, mlp_init,
                                       rmsnorm, rmsnorm_init, unembed)

# what the "dots" remat policy saves (the reference's dots_saveable)
_MATMULS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def init(cfg, seed: int = 0, device="cuda") -> Tuple[Dict, Dict]:
    """Random (params, buffers) from a seeded ``torch.Generator`` on
    ``device``: EliteKV attention when ``cfg.elitekv.enabled``, else the
    baseline GQA attention (no buffers)."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    d, Vp = cfg.d_model, cfg.padded_vocab
    params = {"embed": {"table": dense_init((Vp, d), g, device, scale=0.02)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init((d, Vp), g, device, scale=0.02)}
    params.update(final_norm=rmsnorm_init(d, device), layers=[])
    buffers = {"layers": []}
    for _ in range(cfg.num_layers):
        if cfg.elitekv.enabled:
            attn, buf = elite_attention.init(cfg, g, device)
        else:
            attn, buf = attention.init(cfg, g, device), {}
        params["layers"].append({
            "attn_norm": rmsnorm_init(d, device), "attn": attn,
            "ffn_norm": rmsnorm_init(d, device),
            "ffn": mlp_init(d, cfg.d_ff, g, device)})
        buffers["layers"].append(buf)
    return params, buffers


def _logits(params, cfg, h):
    if cfg.tie_embeddings:
        out = unembed(params["embed"], h)
    else:
        out = h.float() @ params["lm_head"]["w"].float()
    if cfg.padded_vocab != cfg.vocab_size:   # mask the vocab padding
        pad = torch.arange(out.shape[-1], device=out.device) >= cfg.vocab_size
        out = out.masked_fill(pad, -1e30)
    return out


def _layer_pages(pages, i: int):
    """Layer ``i``'s views ``{name: [...]}`` of the stacked pool pages (or
    cache leaves)."""
    return {name: arr[i] for name, arr in pages["p0"].items()}


def _n_slots(pages) -> int:
    return pages["p0"]["k_e"].shape[1]


def _run_layer(p, cfg, h, attend):
    """One pre-norm attention + SwiGLU layer; ``attend(attn_params, hn)`` is
    the mode's attention."""
    h = h + attend(p["attn"], rmsnorm(p["attn_norm"], h, cfg.norm_eps))
    return h + mlp(p["ffn"], rmsnorm(p["ffn_norm"], h, cfg.norm_eps))


# ---------------------------------------------------------------------------
# contiguous cache: lockstep batches from position 0
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """Contiguous f32 cache: ``{"index": 0, "blocks": {"p0": {name:
    [n_layers, batch, max_len, ...]}}}`` with the reference's leaf names
    (``k_e`` and ``c`` or ``c_k``/``c_v`` for EliteKV, ``k``/``v`` for the
    baseline).  ``index`` is the next position to decode, a Python int."""
    mod = elite_attention if cfg.elitekv.enabled else attention
    one = mod.init_cache(cfg, batch, max_len, device="meta")
    leaves = {name: torch.zeros((cfg.num_layers,) + tuple(t.shape), device=device)
              for name, t in one.items()}
    return {"index": 0, "blocks": {"p0": leaves}}


def _contiguous_attention(cfg, buffers, mode: str, positions, cache, index):
    """One layer's ``attend(attn_params, hn)`` in a contiguous mode
    ("train", "prefill" or "decode"): EliteKV or baseline attention, as the
    reference's ``_run_layer`` dispatches."""
    if cfg.elitekv.enabled:
        if mode == "train":
            return lambda pa, hn: elite_attention.apply_full(pa, cfg, buffers, hn, positions)
        if mode == "prefill":
            return lambda pa, hn: elite_attention.apply_prefill(pa, cfg, buffers, hn,
                                                                positions, cache)
        return lambda pa, hn: elite_attention.apply_decode(pa, cfg, buffers, hn, index, cache)
    if mode == "train":
        return lambda pa, hn: attention.apply_full(pa, cfg, hn, positions)
    if mode == "prefill":
        return lambda pa, hn: attention.apply_prefill(pa, cfg, hn, positions, cache)
    return lambda pa, hn: attention.apply_decode(pa, cfg, hn, index, cache)


def _save_matmuls(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg):
    """How a training layer runs under grad: ``fn(*args)`` wrapped in a
    checkpoint per ``cfg.remat_policy``, or None (no recompute)."""
    if not (cfg.remat and torch.is_grad_enabled()) or cfg.remat_policy == "none":
        return None
    if cfg.remat_policy == "full":
        return functools.partial(checkpoint, use_reentrant=False)
    if cfg.remat_policy == "dots":
        return functools.partial(checkpoint, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls))
    raise ValueError(f"remat_policy {cfg.remat_policy!r}: expected full, dots or none")


def _forward_contiguous(params, buffers, cfg, tokens, mode: str, cache=None,
                        captures=None, return_hidden=False):
    device = params["embed"]["table"].device
    h = embed(params["embed"], tokens, cfg.dtype)
    # decode takes its position from the cache index
    positions = None if mode == "decode" else torch.arange(tokens.shape[1], device=device)
    index = cache["index"] if cache is not None else 0
    wrap = _remat(cfg) if mode == "train" and captures is None else None
    for i, (p, b) in enumerate(zip(params["layers"], buffers["layers"])):
        layer_cache = None if cache is None else _layer_pages(cache["blocks"], i)
        attend = _contiguous_attention(cfg, b, mode, positions, layer_cache, index)
        if captures is not None:
            attend = _capturing(attend, captures)
        h = _run_layer(p, cfg, h, attend) if wrap is None else wrap(_run_layer, p, cfg, h,
                                                                    attend)
    if captures is not None:
        return None
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return h if return_hidden else _logits(params, cfg, h)


def _capturing(attend, captures: list):
    """``attend`` that first appends its normed input to ``captures``."""
    def run(pa, hn):
        captures.append(hn)
        return attend(pa, hn)
    return run


def apply_train(params, buffers, cfg, tokens, return_hidden: bool = False):
    """Whole-sequence forward, no cache: tokens [B,S] → logits [B,S,Vp] f32
    (the final normed hidden states [B,S,d] if ``return_hidden``).
    Differentiable: on the card the rotation's backward is its kernel's
    transpose mode; layers recompute in the backward per ``cfg.remat``."""
    return _forward_contiguous(params, buffers, cfg, tokens, "train",
                               return_hidden=return_hidden)


def _chunk_nll(params, cfg, h, labels, mask):
    """(Σ masked nll, Σ mask) of one sequence chunk's hidden states."""
    logits = _logits(params, cfg, h).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def loss_fn(params, buffers, cfg, batch, aux_weight: float = 0.01):
    """Training loss of ``batch`` {"tokens" [B,S], "labels" [B,S] int64,
    optional "loss_mask" [B,S] f32}: mean next-token cross-entropy in f32
    plus ``aux_weight`` times the MoE balance loss (0 for these dense
    stacks).  Where ``cfg.loss_chunk`` divides S the CE goes chunk by chunk
    of the sequence, each chunk's logits recomputed in the backward under
    grad, so the whole [B,S,V] logits never exist.  → (loss, {"ce", "aux"})."""
    tokens, labels = batch["tokens"], batch["labels"]
    mask = batch.get("loss_mask")
    ck = cfg.loss_chunk
    if ck and labels.shape[1] % ck == 0:
        h = apply_train(params, buffers, cfg, tokens, return_hidden=True)
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
        nll = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        remat = torch.is_grad_enabled()
        for i in range(0, labels.shape[1], ck):
            args = (params, cfg, h[:, i:i + ck], labels[:, i:i + ck], mask[:, i:i + ck])
            n_c, c_c = (checkpoint(_chunk_nll, *args, use_reentrant=False) if remat
                        else _chunk_nll(*args))
            nll, cnt = nll + n_c, cnt + c_c
        ce = nll / torch.clamp(cnt, min=1.0)
    else:
        ce = cross_entropy(apply_train(params, buffers, cfg, tokens), labels, mask)
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def capture_attn_inputs(params, buffers, cfg, tokens):
    """The normed attention input of every layer of the whole-sequence
    forward of ``tokens`` [B,S] (what the RoPElite search projects to q and
    k): a list over layers of [B,S,d].  The reference returns the same
    arrays stacked as ``{"p0": [n_layers, B, S, d]}``."""
    captures: list = []
    _forward_contiguous(params, buffers, cfg, tokens, "train", captures=captures)
    return captures


def apply_prefill(params, buffers, cfg, tokens, cache):
    """Prefill prompts tokens [B,S] from position 0: writes cache rows
    [0, S) of every layer in place and sets ``cache["index"] = S``.
    → logits [B,S,Vp] f32."""
    logits = _forward_contiguous(params, buffers, cfg, tokens, "prefill", cache)
    cache["index"] = tokens.shape[1]
    return logits


def apply_decode(params, buffers, cfg, tokens, cache):
    """One token per lane, tokens [B,1] at position ``cache["index"]``:
    writes that cache row of every layer in place and advances the index.
    → logits [B,1,Vp] f32."""
    logits = _forward_contiguous(params, buffers, cfg, tokens, "decode", cache)
    cache["index"] += 1
    return logits


def apply_prefill_paged(params, buffers, cfg, tokens, pages, slot_mapping,
                        chunk_start=None, block_tables=None, prefix_lens=None,
                        block_size: int = 0):
    """Prefill sequences (or chunks of them) into the paged pool.

    ``tokens`` [B,S]; ``pages`` the pool's page dict (``PagedKVPool.pages``);
    ``slot_mapping`` [B,S] flat pool slots per token, with trailing padding
    mapped to the pool's out-of-range sentinel (never written).

    One-shot mode (``chunk_start is None``): prompts start at position 0 and
    attend causally to themselves.

    Chunked mode: ``chunk_start`` [B] per-lane start positions; lane ``b``'s
    tokens sit at ``chunk_start[b] + i`` and attend to the lane's own cached
    prefix, located by ``block_tables`` [B,mb] / ``prefix_lens`` [B] /
    ``block_size``, plus the chunk causally.  A lane with no valid token (all
    sentinel) gets ``kv_lens = 0`` and a zero attention output; padding rows
    are never read.
    → logits [B,S,Vp] f32; ``pages`` written in place.
    """
    device = params["embed"]["table"].device
    n_slots = _n_slots(pages)
    h = embed(params["embed"], tokens, cfg.dtype)
    B, S = tokens.shape
    writes = elite_attention.write_index(slot_mapping, n_slots, device)
    positions = torch.arange(S, device=device)
    kw = {}
    if chunk_start is not None:
        i32 = dict(dtype=torch.int32, device=device)
        starts = torch.as_tensor(chunk_start, **i32)
        positions = positions[None, :] + starts[:, None]
        n_valid = (torch.as_tensor(slot_mapping) < n_slots).sum(dim=1)
        kw = dict(block_tables=torch.as_tensor(block_tables, **i32),
                  prefix_lens=torch.as_tensor(prefix_lens, **i32),
                  kv_lens=torch.as_tensor(prefix_lens, **i32) + n_valid.to(**i32),
                  block_size=block_size)
    for i, (p, b) in enumerate(zip(params["layers"], buffers["layers"])):
        h = _run_layer(p, cfg, h, lambda pa, hn: elite_attention.apply_prefill_paged(
            pa, cfg, b, hn, positions, _layer_pages(pages, i), writes, **kw))
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _logits(params, cfg, h)


def apply_decode_paged(params, buffers, cfg, tokens, pages, slot_mapping,
                       block_tables, lengths, block_size: int,
                       sparse_topk: int = 0, sparse_recent: int = 0):
    """One decode step for every serving lane, reading and writing the pool.

    ``tokens`` [B,1]; ``lengths`` [B] int32, the live length *including*
    this token (0 = idle lane); ``slot_mapping`` [B] the write slot of the
    new token (sentinel for idle lanes); ``block_tables`` [B,mb].
    ``sparse_topk > 0`` attends only the block-top-k selection plus the
    ``sparse_recent`` newest blocks in every layer (the pool needs block
    summaries).
    → logits [B,1,Vp] f32; ``pages`` written in place.
    """
    device = params["embed"]["table"].device
    i32 = dict(dtype=torch.int32, device=device)
    h = embed(params["embed"], tokens, cfg.dtype)
    writes = elite_attention.write_index(slot_mapping, _n_slots(pages), device)
    block_tables = torch.as_tensor(block_tables, **i32)
    lengths = torch.as_tensor(lengths, **i32)
    for i, (p, b) in enumerate(zip(params["layers"], buffers["layers"])):
        h = _run_layer(p, cfg, h, lambda pa, hn: elite_attention.apply_decode_paged(
            pa, cfg, b, hn, _layer_pages(pages, i), writes, block_tables, lengths,
            block_size, sparse_topk, sparse_recent))
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _logits(params, cfg, h)


def apply_verify_paged(params, buffers, cfg, tokens, pages, slot_mapping,
                       block_tables, q_offsets, lengths, block_size: int):
    """Speculative-verify forward: score a window of ``W = k+1`` tokens per
    lane (the pending token and ``k`` draft proposals) against its paged
    prefix in one call, writing the window's full-model streams to the pool.

    ``tokens`` [B,W]; ``q_offsets`` [B] the position of each lane's window
    row 0 (its cached prefix length); ``lengths`` [B] its live length
    including the window's valid tokens (0 = idle lane); ``slot_mapping``
    [B,W] flat write slots (padding → the pool's sentinel);
    ``block_tables`` [B,mb].  Logits row ``w`` is the full model's
    next-token distribution after window token ``w``: rows ``0..k-1`` judge
    the proposals, row ``k`` gives the bonus token.
    → logits [B,W,Vp] f32; ``pages`` written in place.
    """
    device = params["embed"]["table"].device
    i32 = dict(dtype=torch.int32, device=device)
    h = embed(params["embed"], tokens, cfg.dtype)
    writes = elite_attention.write_index(slot_mapping, _n_slots(pages), device)
    block_tables = torch.as_tensor(block_tables, **i32)
    q_offsets = torch.as_tensor(q_offsets, **i32)
    lengths = torch.as_tensor(lengths, **i32)
    for i, (p, b) in enumerate(zip(params["layers"], buffers["layers"])):
        h = _run_layer(p, cfg, h, lambda pa, hn: elite_attention.apply_verify_paged(
            pa, cfg, b, hn, _layer_pages(pages, i), writes, block_tables, q_offsets,
            lengths, block_size))
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _logits(params, cfg, h)


def make_draft_params(params, cfg, draft_rank: int):
    """Draft weights for self-speculative decode: every layer's joint
    up-projections ``bk``/``bv`` projected onto their top ``draft_rank``
    singular directions (``lrd.truncate_joint_rank``), in their full shapes,
    so the draft runs the same decode path over the same pool.
    ``draft_rank <= 0`` or ``>= d_ckv`` returns ``params`` itself (the
    full-rank draft).  Otherwise a shallow copy in which only each layer's
    ``attn.bk``/``attn.bv`` are new tensors on the params' device; every
    other tensor is shared."""
    assert cfg.elitekv.enabled, "speculative decode requires an EliteKV cache"
    if draft_rank <= 0 or draft_rank >= cfg.elitekv.d_ckv:
        return params
    assert cfg.elitekv.lrd == "joint", \
        "draft truncation targets the joint low-rank factors"
    layers = []
    for layer in params["layers"]:
        attn = dict(layer["attn"])
        bk, bv = lrd.truncate_joint_rank(attn["bk"].detach().cpu().numpy(),
                                         attn["bv"].detach().cpu().numpy(), draft_rank)
        attn["bk"] = torch.from_numpy(bk).to(layer["attn"]["bk"].device)
        attn["bv"] = torch.from_numpy(bv).to(layer["attn"]["bv"].device)
        layers.append({**layer, "attn": attn})
    return {**params, "layers": layers}
