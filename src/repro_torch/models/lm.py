"""Decoder-only LM: EliteKV or baseline GQA attention, or Mamba, as each
layer's mixer; a SwiGLU MLP, a mixture of experts, or nothing as its FFN.

Counterpart of the JAX package's ``models/lm.py``.  Parameters are nested
dicts of tensors; the JAX package's superblocks (``block_period`` layer
positions ``p0, p1, ...``, each stacked over ``n_super`` superblocks) become
one list of per-layer dicts in absolute layer order, driven by a Python
loop where JAX uses ``lax.scan``:

    params  = {"embed": {"table"}, "lm_head": {"w"}, "final_norm": {"scale"},
               "layers": [{"attn_norm", "attn", "ffn_norm", "ffn"}, ...]}
    buffers = {"layers": [{"elite_freqs"}, ...]}   ({} per GQA or Mamba layer)

Layer ``i``'s ``attn`` holds its mixer's params (attention, or Mamba where
``cfg.layer_kind(i) == "ssm"``); ``ffn``/``ffn_norm`` are absent where
``cfg.ffn_kind(i) == "none"`` (Falcon-Mamba) and hold a ``models/moe.py``
FFN where it is "moe".  No ``lm_head`` when ``cfg.tie_embeddings``: the
logits are then ``h @ embed.table^T``.  MoE layers dispatch as every entry
point's ``moe_impl`` says (``models/moe.py``): "ragged" (the default) or the
"dense" oracle.

Every entry point takes the reference's ``batch`` dict (a bare id tensor
stands for ``{"tokens": t}``): ``tokens`` [B,S] int64 for a text model; for
a vision model (``cfg.frontend == "vision"``) optionally ``patch_embeds``
[B,nv,d], which the whole-sequence entries put before the embedded text
(positions run over all ``nv + S`` rows; decode and verify take tokens
only); for an audio model ``frames`` [B,S,d], fed as they are: it has no
``embed`` and always an ``lm_head``.

Entry points over the block-paged pool (EliteKV, attention-only stacks:
dense or MoE; a stack with Mamba layers raises ``ValueError``):
  * ``apply_prefill_paged`` — prefill prompts (or per-lane chunks) into the pool.
  * ``apply_decode_paged``  — one token per serving lane against the pool.
  * ``apply_verify_paged``  — a speculative window of ``W`` tokens per lane
    against the pool, in one forward.
Entry points over a contiguous cache (EliteKV or baseline, lockstep):
  * ``init_cache``    — the f32 cache ``{"index", "blocks": {"p0": ...}}``:
    attention rows and Mamba ``(conv, ssm)`` states.
  * ``apply_prefill`` — prompts from position 0, filling the cache.
  * ``apply_decode``  — one token per lane at position ``cache["index"]``.
  * ``apply_train``   — the whole-sequence forward without a cache: the
    training forward (differentiable on either device) and the oracle of
    cache-on == cache-off; ``return_aux`` adds the summed MoE balance loss.
  * ``loss_fn``       — mean next-token cross-entropy of ``apply_train``
    (sequence-chunked at ``cfg.loss_chunk``), what training differentiates.
  * ``capture_attn_inputs`` — each attention layer's normed input of a
    baseline forward, keyed by absolute layer index, which the RoPElite
    search reads.
All return f32 logits over the padded vocab (padding columns = -1e30) and
write the pool pages or the cache in place.  ``make_draft_params`` derives
the rank-truncated draft model of self-speculative decode.

Under grad the training forward recomputes its layers in the backward as
``cfg.remat``/``cfg.remat_policy`` say (the reference's ``jax.checkpoint``
of a layer): "full" keeps only each layer's input, "dots" also the matmul
outputs (a selective checkpoint), "none" keeps everything.

Sharded steps.  ``apply_train``, ``loss_fn``, ``apply_prefill`` and
``apply_decode`` take the
reference's ``constrain(name, x)`` hook (``distributed.sharding.
make_constrain``), called at its points with its names: ``embed`` on the
embedded inputs, ``attn_in_sharded`` then ``attn_in`` on each sublayer's
normed input, ``attn_out``/``ffn_out`` on a sublayer's output and
``residual`` on the sum, ``logits`` on the logits, and inside the mixers
and the MLP.  With parameters, buffers, inputs and cache placed as
``DTensor``s the same code is the sharded step; the tensors it makes
itself (positions, masks, zeros) join as replicated ``DTensor``s on the
inputs' mesh (``sharding.replicated_like``).  Without a hook, or on plain
tensors, nothing changes.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core import elite_attention, lrd
from repro_torch.core.cache import first
from repro_torch.distributed.sharding import is_dtensor, matmul, replicated_like, settled
from repro_torch.models import attention, mamba, moe
from repro_torch.models.layers import (cross_entropy, dense_init, embed, mlp, mlp_init, nll,
                                       rmsnorm, rmsnorm_init, unembed)

#: the constrain hook that constrains nothing
_NOOP = lambda name, x: x

# what the "dots" remat policy saves (the reference's dots_saveable)
_MATMULS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def init(cfg, seed: int = 0, device="cuda") -> Tuple[Dict, Dict]:
    """Random (params, buffers) from a seeded ``torch.Generator`` on
    ``device``: per layer EliteKV attention when ``cfg.elitekv.enabled``,
    else the baseline GQA attention (no buffers), or Mamba; then its MLP or
    MoE FFN, if any.  On ``device="meta"`` the same tree of shape-only
    ``torch.empty`` leaves, with nothing drawn (the reference's
    ``jax.eval_shape(lm.init)``)."""
    if cfg.num_layers % cfg.block_period:
        raise ValueError(f"{cfg.num_layers} layers are not whole periods of "
                         f"{cfg.block_period}")
    device = torch.device(device)
    g = None
    if device.type != "meta":
        g = torch.Generator(device=device)
        g.manual_seed(seed)
    d, Vp = cfg.d_model, cfg.padded_vocab
    audio = cfg.frontend == "audio"
    params = {} if audio else {"embed": {"table": dense_init((Vp, d), g, device, scale=0.02)}}
    if audio or not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init((d, Vp), g, device, scale=0.02)}
    params.update(final_norm=rmsnorm_init(d, device), layers=[])
    buffers = {"layers": []}
    for i in range(cfg.num_layers):
        buf = {}
        if cfg.layer_kind(i) == "ssm":
            attn = mamba.init(cfg, g, device)
        elif cfg.elitekv.enabled:
            attn, buf = elite_attention.init(cfg, g, device)
        else:
            attn = attention.init(cfg, g, device)
        layer = {"attn_norm": rmsnorm_init(d, device), "attn": attn}
        ffn = cfg.ffn_kind(i)
        if ffn != "none":
            layer["ffn_norm"] = rmsnorm_init(d, device)
            layer["ffn"] = (moe.init(cfg, g, device) if ffn == "moe"
                            else mlp_init(d, cfg.d_ff, g, device))
        params["layers"].append(layer)
        buffers["layers"].append(buf)
    return params, buffers


def _as_batch(batch) -> Dict:
    """The reference's batch dict; a bare id tensor is ``{"tokens": t}``."""
    return batch if isinstance(batch, dict) else {"tokens": batch}


def params_device(params) -> torch.device:
    """The params' device, from a leaf every model has."""
    return params["final_norm"]["scale"].device


def _embed_step(params, cfg, batch):
    """Frames as they are for an audio model, else the embedded tokens
    (every entry point; the reference's ``_embed_step``)."""
    if cfg.frontend == "audio":
        return batch["frames"].to(cfg.dtype)
    return embed(params["embed"], batch["tokens"], cfg.dtype)


def _embed_inputs(params, cfg, batch, constrain=_NOOP):
    """``_embed_step``, with a vision batch's ``patch_embeds`` put before
    the embedded text (the whole-sequence entries), constrained as
    ``embed``."""
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        txt = embed(params["embed"], batch["tokens"], cfg.dtype)
        return constrain("embed", torch.cat([batch["patch_embeds"].to(cfg.dtype), txt],
                                            dim=1))
    return constrain("embed", _embed_step(params, cfg, batch))


def _n_patches(cfg, batch) -> int:
    """The patch rows a vision batch puts before its text (0 otherwise)."""
    return (batch["patch_embeds"].shape[1]
            if cfg.frontend == "vision" and "patch_embeds" in batch else 0)


def _logits(params, cfg, h, constrain=_NOOP):
    if cfg.tie_embeddings and cfg.frontend != "audio":
        out = unembed(params["embed"], h)
    else:
        out = matmul(h.float(), params["lm_head"]["w"].float())
    if cfg.padded_vocab != cfg.vocab_size:   # mask the vocab padding
        pad = torch.arange(out.shape[-1], device=out.device) >= cfg.vocab_size
        out = out.masked_fill(replicated_like(out, pad), -1e30)
    return constrain("logits", out)


def _layer_pages(pages, cfg, i: int):
    """Layer ``i``'s views ``{name: [...]}`` of the stacked pool pages (or
    cache leaves): position ``p{i % P}``, superblock ``i // P``.  A leaf of
    a tensor-parallel pool (a tuple, one tensor per shard) gives a tuple of
    views, one object wherever the shards share a tensor."""
    P = cfg.block_period
    return {name: _layer_view(arr, i // P) for name, arr in pages[f"p{i % P}"].items()}


def _layer_view(leaf, s: int):
    if torch.is_tensor(leaf):
        return leaf[s]
    views = {}
    return tuple(views.setdefault(id(t), t[s]) for t in leaf)


def _n_slots(pages) -> int:
    return first(pages["p0"]["k_e"]).shape[1]


def _check_mesh(pages, mesh) -> None:
    """The pool's pages must be placed over ``mesh``: as many ``k_e`` head
    shards as its ``tp`` (a plain tensor at tp 1)."""
    k_e = pages["p0"]["k_e"]
    shards = 1 if torch.is_tensor(k_e) else len(k_e)
    tp = 1 if mesh is None else mesh.tp
    if shards != tp:
        raise ValueError(f"pool pages in {shards} head shard(s) for a mesh of tp={tp}: "
                         f"build the pool with PagedKVPool(..., mesh=) of the same mesh")


def _run_layer(p, cfg, i: int, h, mix, moe_impl: str, constrain=_NOOP):
    """Layer ``i``: pre-norm mixer, then its FFN (MLP, MoE or none);
    ``mix(mixer_params, hn)`` is the mode's attention or Mamba; ``constrain``
    at the reference's points.  → (h, the MoE balance loss or None)."""
    c = constrain
    hn = c("attn_in", c("attn_in_sharded", rmsnorm(p["attn_norm"], h, cfg.norm_eps)))
    h = c("residual", h + c("attn_out", mix(p["attn"], hn)))
    kind = cfg.ffn_kind(i)
    if kind == "none":
        return h, None
    hn = c("attn_in", c("attn_in_sharded", rmsnorm(p["ffn_norm"], h, cfg.norm_eps)))
    if kind == "moe":
        f, aux = moe.apply(p["ffn"], cfg, hn, impl=moe_impl)
        return c("residual", h + c("ffn_out", f)), aux
    return c("residual", h + c("ffn_out", mlp(p["ffn"], hn, c))), None


def _check_paged(cfg) -> None:
    if cfg.n_attn_layers != cfg.num_layers:
        raise ValueError("paged serving supports attention-only stacks: "
                         f"{cfg.name} has Mamba layers (serve it with generate)")


# ---------------------------------------------------------------------------
# contiguous cache: lockstep batches from position 0
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """Contiguous f32 cache ``{"index": 0, "blocks": {"p{pos}": {name:
    [n_super, ...]}}}`` with the reference's keys and leaf names: per
    attention position ``[n_super, batch, max_len, ...]`` rows (``k_e`` and
    ``c`` or ``c_k``/``c_v`` for EliteKV, ``k``/``v`` for the baseline), per
    Mamba position ``conv`` [n_super, batch, K-1, d_inner] and ``ssm``
    [n_super, batch, d_inner, N].  ``index`` is the next position to
    decode, a Python int."""
    P = cfg.block_period
    mod = elite_attention if cfg.elitekv.enabled else attention
    blocks = {}
    for pos in range(P):
        one = (mod.init_cache(cfg, batch, max_len, device="meta")
               if cfg.layer_kind(pos) == "attn" else mamba.init_state(cfg, batch, "meta"))
        blocks[f"p{pos}"] = {
            name: torch.zeros((cfg.num_layers // P,) + tuple(t.shape), dtype=t.dtype,
                              device=device)
            for name, t in one.items()}
    return {"index": 0, "blocks": blocks}


def _mamba_mixer(cfg, mode: str, state, constrain=_NOOP):
    """A Mamba layer's ``mix(params, hn)``: prefill writes the final
    ``(conv, ssm)`` state into ``state``'s views, decode advances it in
    place."""
    if mode == "train":
        return lambda pm, hn: mamba.apply_full(pm, cfg, hn, constrain=constrain)

    def run(pm, hn):
        if mode == "prefill":
            out, (conv, ssm) = mamba.apply_full(pm, cfg, hn, return_state=True,
                                                constrain=constrain)
        else:
            out, new = mamba.apply_decode(pm, cfg, hn, state, constrain=constrain)
            conv, ssm = new["conv"], new["ssm"]
        state["conv"].copy_(conv)
        state["ssm"].copy_(ssm)
        return out
    return run


def _contiguous_attention(cfg, buffers, mode: str, positions, cache, index, constrain=_NOOP):
    """One attention layer's ``attend(attn_params, hn)`` in a contiguous
    mode ("train", "prefill" or "decode"): EliteKV or baseline attention, as
    the reference's ``_run_layer`` dispatches."""
    c = constrain
    if cfg.elitekv.enabled:
        if mode == "train":
            return lambda pa, hn: elite_attention.apply_full(pa, cfg, buffers, hn, positions,
                                                             constrain=c)
        if mode == "prefill":
            return lambda pa, hn: elite_attention.apply_prefill(pa, cfg, buffers, hn,
                                                                positions, cache, constrain=c)
        return lambda pa, hn: elite_attention.apply_decode(pa, cfg, buffers, hn, index, cache,
                                                           constrain=c)
    if mode == "train":
        return lambda pa, hn: attention.apply_full(pa, cfg, hn, positions, constrain=c)
    if mode == "prefill":
        return lambda pa, hn: attention.apply_prefill(pa, cfg, hn, positions, cache,
                                                      constrain=c)
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


def _forward_contiguous(params, buffers, cfg, batch, mode: str, cache=None,
                        captures=None, return_hidden=False, moe_impl="ragged",
                        constrain=None):
    """→ (logits or final hidden states, summed MoE balance loss or None).
    ``constrain``: the sharding hook."""
    c = constrain or _NOOP
    # a decode step's lookup (vocabulary-parallel on a placed table) summed once
    h = (settled(_embed_step(params, cfg, batch)) if mode == "decode"
         else _embed_inputs(params, cfg, batch, c))
    # decode takes its position from the cache index
    positions = (None if mode == "decode" else replicated_like(
        h, torch.arange(h.shape[1], device=params_device(params))))
    index = cache["index"] if cache is not None else 0
    wrap = _remat(cfg) if mode == "train" and captures is None else None
    aux_sum = None
    for i, (p, b) in enumerate(zip(params["layers"], buffers["layers"])):
        layer_cache = None if cache is None else _layer_pages(cache["blocks"], cfg, i)
        if cfg.layer_kind(i) == "ssm":
            mix = _mamba_mixer(cfg, mode, layer_cache, c)
        else:
            mix = _contiguous_attention(cfg, b, mode, positions, layer_cache, index, c)
            if captures is not None:
                mix = _capturing(mix, captures, i)
        h, aux = (_run_layer(p, cfg, i, h, mix, moe_impl, c) if wrap is None
                  else wrap(_run_layer, p, cfg, i, h, mix, moe_impl, c))
        if aux is not None:
            aux_sum = aux if aux_sum is None else aux_sum + aux
    if captures is not None:
        return None, None
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return (h if return_hidden else _logits(params, cfg, h, c)), aux_sum


def _capturing(attend, captures: dict, i: int):
    """``attend`` that first keeps its normed input in ``captures[i]``."""
    def run(pa, hn):
        captures[i] = hn
        return attend(pa, hn)
    return run


def apply_train(params, buffers, cfg, batch, return_hidden: bool = False,
                moe_impl: str = "ragged", return_aux: bool = False, constrain=None):
    """Whole-sequence forward, no cache: ``batch`` (tokens [B,S], with a
    vision model's patches before them, or an audio model's frames) →
    logits [B,nv+S,Vp] f32 over every position, patches included (the final
    normed hidden states [B,nv+S,d] if ``return_hidden``); with
    ``return_aux`` the pair (that, the MoE balance loss summed over the MoE
    layers, a f32 scalar, 0 without any), as the reference's
    ``apply_train`` returns.  Differentiable: on the card the rotation's
    backward is its kernel's transpose mode; layers recompute in the
    backward per ``cfg.remat``.  ``constrain``: the sharding hook."""
    out, aux = _forward_contiguous(params, buffers, cfg, _as_batch(batch), "train",
                                   return_hidden=return_hidden, moe_impl=moe_impl,
                                   constrain=constrain)
    if not return_aux:
        return out
    return out, (replicated_like(out, torch.zeros((), dtype=torch.float32, device=out.device))
                 if aux is None else aux)


def _chunk_nll(params, cfg, h, labels, mask, constrain=_NOOP):
    """(Σ masked nll, Σ mask) of one sequence chunk's hidden states."""
    return torch.sum(nll(_logits(params, cfg, h, constrain), labels) * mask), torch.sum(mask)


def loss_fn(params, buffers, cfg, batch, moe_impl: str = "ragged",
            aux_weight: float = 0.01, constrain=None):
    """Training loss of ``batch`` {"tokens" [B,S] (a vision model's
    "patch_embeds" [B,nv,d] before them, or an audio model's "frames"
    [B,S,d] instead), "labels" [B,S] int64, optional "loss_mask" [B,S]
    f32}: mean next-token cross-entropy in f32 over the text (or frame)
    positions, the first ``nv`` logits rows dropped, plus ``aux_weight``
    times the MoE balance loss (0 for a stack without MoE layers); MoE
    layers dispatch by ``moe_impl``.  Where
    ``cfg.loss_chunk`` divides S and no patches lead, the CE goes chunk by
    chunk of the sequence, each chunk's logits recomputed in the backward
    under grad, so the whole [B,S,V] logits never exist.  ``constrain``:
    the sharding hook (a sharded stream is gathered once, as ``attn_in``,
    before the chunks are cut).  → (loss, {"ce", "aux"})."""
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    nv = _n_patches(cfg, batch)
    ck = cfg.loss_chunk
    c = constrain or _NOOP
    if ck and labels.shape[1] % ck == 0 and nv == 0:
        h, aux = apply_train(params, buffers, cfg, batch, return_hidden=True,
                             moe_impl=moe_impl, return_aux=True, constrain=constrain)
        if is_dtensor(h):
            h = c("attn_in", h)
        if mask is None:
            mask = torch.ones_like(labels, dtype=torch.float32)
        nll = cnt = replicated_like(h, torch.zeros((), dtype=torch.float32, device=h.device))
        remat = torch.is_grad_enabled()
        for i in range(0, labels.shape[1], ck):
            args = (params, cfg, h[:, i:i + ck], labels[:, i:i + ck], mask[:, i:i + ck], c)
            n_c, c_c = (checkpoint(_chunk_nll, *args, use_reentrant=False) if remat
                        else _chunk_nll(*args))
            nll, cnt = nll + n_c, cnt + c_c
        ce = nll / torch.clamp(cnt, min=1.0)
    else:
        logits, aux = apply_train(params, buffers, cfg, batch, moe_impl=moe_impl,
                                  return_aux=True, constrain=constrain)
        ce = cross_entropy(logits[:, nv:], labels, mask)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def capture_attn_inputs(params, buffers, cfg, batch, moe_impl: str = "ragged"):
    """The normed attention input of every attention layer of the
    whole-sequence forward of ``batch`` (tokens [B,S]; a vision model's
    patches before them, or an audio model's frames), through Mamba and MoE
    layers (dispatched by ``moe_impl``) alike — what the RoPElite search
    projects to q and k: ``{absolute layer index: [B,nv+S,d]}`` over the
    attention layers, in layer order.  The reference returns the same
    arrays stacked per attention position, ``{"p{pos}": [n_super, B, S,
    d]}``: its entry ``s`` of ``p{pos}`` is layer ``s·P + pos`` here."""
    captures: dict = {}
    _forward_contiguous(params, buffers, cfg, _as_batch(batch), "train", captures=captures,
                        moe_impl=moe_impl)
    return captures


def apply_prefill(params, buffers, cfg, batch, cache, moe_impl: str = "ragged",
                  constrain=None):
    """Prefill prompts (``batch``: tokens [B,S], a vision model's patches
    before them, or an audio model's frames) from position 0: writes cache
    rows [0, nv+S) of every attention layer and every Mamba layer's final
    state in place and sets ``cache["index"] = nv+S``; MoE layers dispatch
    by ``moe_impl``.  ``constrain``: the sharding hook; a placed cache keeps
    its placements.  → logits [B,nv+S,Vp] f32."""
    batch = _as_batch(batch)
    logits, _ = _forward_contiguous(params, buffers, cfg, batch, "prefill", cache,
                                    moe_impl=moe_impl, constrain=constrain)
    cache["index"] = logits.shape[1]
    return logits


def apply_decode(params, buffers, cfg, batch, cache, moe_impl: str = "ragged",
                 constrain=None):
    """One token (or an audio model's frame) per lane, tokens [B,1] (frames
    [B,1,d]) at position ``cache["index"]`` (a host int): writes that cache
    row of every attention layer and advances every Mamba state in place,
    and advances the index.  ``constrain``: the sharding hook (the decode
    plan's, ``make_constrain(decode=True)``); a placed cache keeps its
    placements, its sequence possibly sharded (the rank holding the row
    writes it).  → logits [B,1,Vp] f32."""
    logits, _ = _forward_contiguous(params, buffers, cfg, _as_batch(batch), "decode", cache,
                                    moe_impl=moe_impl, constrain=constrain)
    cache["index"] += 1
    return logits


def apply_prefill_paged(params, buffers, cfg, batch, pages, slot_mapping,
                        chunk_start=None, block_tables=None, prefix_lens=None,
                        block_size: int = 0, moe_impl: str = "ragged", mesh=None):
    """Prefill sequences (or chunks of them) into the paged pool.

    ``batch``: tokens [B,S] (a vision model's patches [B,nv,d] before them,
    which take the first ``nv`` positions, or an audio model's frames
    [B,S,d]); ``pages`` the pool's page dict (``PagedKVPool.pages``);
    ``slot_mapping`` [B,nv+S] flat pool slots per position, with trailing
    padding mapped to the pool's out-of-range sentinel (never written).

    One-shot mode (``chunk_start is None``): prompts start at position 0 and
    attend causally to themselves.

    Chunked mode: ``chunk_start`` [B] per-lane start positions; lane ``b``'s
    tokens sit at ``chunk_start[b] + i`` and attend to the lane's own cached
    prefix, located by ``block_tables`` [B,mb] / ``prefix_lens`` [B] /
    ``block_size``, plus the chunk causally.  A lane with no valid token (all
    sentinel) gets ``kv_lens = 0`` and a zero attention output; padding rows
    are never read.  MoE layers dispatch by ``moe_impl``.

    ``mesh`` (a ``launch.mesh.TPMesh``, None for one device): the pool's
    pages are placed over it (``PagedKVPool(..., mesh=)``).  Prefill
    computes replicated, full-head, on the params' device (the mesh's
    first): only the pool's ``k_e`` is sharded, and the scatter writes each
    shard its heads (the reference's ``mesh=`` prefill).
    → logits [B,nv+S,Vp] f32; ``pages`` written in place.
    """
    _check_paged(cfg)
    _check_mesh(pages, mesh)
    device = params_device(params)
    n_slots = _n_slots(pages)
    h = _embed_inputs(params, cfg, _as_batch(batch))
    S = h.shape[1]
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
        h, _ = _run_layer(p, cfg, i, h, lambda pa, hn: elite_attention.apply_prefill_paged(
            pa, cfg, b, hn, positions, _layer_pages(pages, cfg, i), writes, **kw), moe_impl)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _logits(params, cfg, h)


def apply_decode_paged(params, buffers, cfg, batch, pages, slot_mapping,
                       block_tables, lengths, block_size: int,
                       sparse_topk: int = 0, sparse_recent: int = 0,
                       moe_impl: str = "ragged", mesh=None):
    """One decode step for every serving lane, reading and writing the pool.

    ``batch``: tokens [B,1] (an audio model's frames [B,1,d]); ``lengths``
    [B] int32, the live length *including* this token (0 = idle lane);
    ``slot_mapping`` [B] the write slot of the new token (sentinel for idle
    lanes); ``block_tables`` [B,mb].
    ``sparse_topk > 0`` attends only the block-top-k selection plus the
    ``sparse_recent`` newest blocks in every layer (the pool needs block
    summaries).  MoE layers dispatch by ``moe_impl``.  ``mesh``: the
    attention runs head-sharded over it (``kernels/ops.py``'s ``*_tp``
    wrappers), every other op full-head on its first device.
    → logits [B,1,Vp] f32; ``pages`` written in place.
    """
    _check_paged(cfg)
    _check_mesh(pages, mesh)
    device = params_device(params)
    i32 = dict(dtype=torch.int32, device=device)
    h = _embed_step(params, cfg, _as_batch(batch))
    writes = elite_attention.write_index(slot_mapping, _n_slots(pages), device)
    block_tables = torch.as_tensor(block_tables, **i32)
    lengths = torch.as_tensor(lengths, **i32)
    for i, (p, b) in enumerate(zip(params["layers"], buffers["layers"])):
        h, _ = _run_layer(p, cfg, i, h, lambda pa, hn: elite_attention.apply_decode_paged(
            pa, cfg, b, hn, _layer_pages(pages, cfg, i), writes, block_tables, lengths,
            block_size, sparse_topk, sparse_recent, mesh), moe_impl)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _logits(params, cfg, h)


def apply_verify_paged(params, buffers, cfg, batch, pages, slot_mapping,
                       block_tables, q_offsets, lengths, block_size: int,
                       moe_impl: str = "ragged", mesh=None):
    """Speculative-verify forward: score a window of ``W = k+1`` tokens per
    lane (the pending token and ``k`` draft proposals) against its paged
    prefix in one call, writing the window's full-model streams to the pool.

    ``batch``: tokens [B,W] (an audio model's frames [B,W,d]);
    ``q_offsets`` [B] the position of each lane's window row 0 (its cached
    prefix length); ``lengths`` [B] its live length
    including the window's valid tokens (0 = idle lane); ``slot_mapping``
    [B,W] flat write slots (padding → the pool's sentinel);
    ``block_tables`` [B,mb].  Logits row ``w`` is the full model's
    next-token distribution after window token ``w``: rows ``0..k-1`` judge
    the proposals, row ``k`` gives the bonus token.  MoE layers dispatch
    by ``moe_impl``; ``mesh`` as in ``apply_decode_paged``.
    → logits [B,W,Vp] f32; ``pages`` written in place.
    """
    _check_paged(cfg)
    _check_mesh(pages, mesh)
    device = params_device(params)
    i32 = dict(dtype=torch.int32, device=device)
    h = _embed_step(params, cfg, _as_batch(batch))
    writes = elite_attention.write_index(slot_mapping, _n_slots(pages), device)
    block_tables = torch.as_tensor(block_tables, **i32)
    q_offsets = torch.as_tensor(q_offsets, **i32)
    lengths = torch.as_tensor(lengths, **i32)
    for i, (p, b) in enumerate(zip(params["layers"], buffers["layers"])):
        h, _ = _run_layer(p, cfg, i, h, lambda pa, hn: elite_attention.apply_verify_paged(
            pa, cfg, b, hn, _layer_pages(pages, cfg, i), writes, block_tables, q_offsets,
            lengths, block_size, mesh), moe_impl)
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
    other tensor is shared (Mamba layers whole)."""
    assert cfg.elitekv.enabled, "speculative decode requires an EliteKV cache"
    if draft_rank <= 0 or draft_rank >= cfg.elitekv.d_ckv:
        return params
    assert cfg.elitekv.lrd == "joint", \
        "draft truncation targets the joint low-rank factors"
    layers = []
    for layer in params["layers"]:
        if "bk" not in layer["attn"]:           # a Mamba layer
            layers.append(layer)
            continue
        attn = dict(layer["attn"])
        bk, bv = lrd.truncate_joint_rank(attn["bk"].detach().cpu().numpy(),
                                         attn["bv"].detach().cpu().numpy(), draft_rank)
        attn["bk"] = torch.from_numpy(bk).to(layer["attn"]["bk"].device)
        attn["bv"] = torch.from_numpy(bv).to(layer["attn"]["bv"].device)
        layers.append({**layer, "attn": attn})
    return {**params, "layers": layers}
