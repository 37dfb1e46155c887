"""RoPElite (paper Alg. 1): greedy per-head search for elite RoPE chunks.

For each attention head, find the ``r`` 2-D frequency chunks whose rotation
the head's attention scores depend on most: at every greedy step, add the
chunk ``j`` minimizing  ||s(full RoPE) − s(RoPE on selected ∪ {j})||₁.

Identity used for an O(r·C) search (paper App. B: one forward pass, all
heads in parallel):  with  D_c = s_rot(c) − s_plain(c)  the per-chunk score
delta, s(M) − s(full) = −Σ_{c∉M} D_c =: −G(M).  The candidate distance is
then ||G − D_j||₁ and the update after picking j* is  G ← G − D_{j*}.

GQA generalization: elite sets live per **KV head**; candidate distances are
summed over the query heads of the group (keys are shared, so the chunk
choice must be, too).

Counterpart of the JAX package's ``core/ropelite.py``.  The scores are
[B, nh, S, S] f32 in plain PyTorch on the inputs' device (the reference has
no kernel here).  The per-chunk deltas are built once per layer, with the
causal mask applied, as a stack [nh, C, B·S·S]; every greedy step then
takes all C candidate distances of every head in one L1 ``cdist`` over it.
The search's full RoPE runs through ``rope_elite_qk`` and
``score_distance``'s masked one through ``rope_elite`` (``core/rope.py``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import rope as rope_lib
from repro_torch.models import lm


def _chunked(x: torch.Tensor) -> torch.Tensor:
    """[..., D] → [..., C, 2] interleaved-pair view."""
    return x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2))


def _pair_scores(qc: torch.Tensor, kc: torch.Tensor, q_group: int) -> torch.Tensor:
    """qc [B,S,nh,2], kc [B,S,nkv,2] → scores [B,nh,S,S]."""
    B, S, nh, _ = qc.shape
    nkv = kc.shape[2]
    qg = qc.reshape(B, S, nkv, q_group, 2)
    return torch.einsum("bqhgt,bkht->bhgqk", qg, kc).reshape(B, nh, S, S)


def _causal(S: int, causal: bool, device) -> torch.Tensor:
    ones = torch.ones((S, S), dtype=torch.float32, device=device)
    return torch.tril(ones) if causal else ones


def greedy_search_layer(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                        theta: float, q_group: int, r: int,
                        causal: bool = True) -> torch.Tensor:
    """Greedy elite-chunk search for one layer.

    q [B,S,nh,dh] / k [B,S,nkv,dh] — PRE-rotation projections (f32).
    Returns elite chunk indices in selection order: [nkv, r] int32.
    """
    B, S, nh, dh = q.shape
    nkv, C = k.shape[2], dh // 2
    q, k = q.float().contiguous(), k.float().contiguous()
    q_rot, k_rot = rope_lib.apply_rope_qk(q, k, positions, theta)
    qch, kch, qch_rot, kch_rot = map(_chunked, (q, k, q_rot, k_rot))
    w = _causal(S, causal, q.device)
    # D_c for every chunk, masked, laid out [nh, C, B·S·S]; G = Σ_c D_c in
    # chunk order
    deltas = torch.empty((nh, C, B * S * S), dtype=torch.float32, device=q.device)
    G = torch.zeros((B, nh, S, S), dtype=torch.float32, device=q.device)
    for c in range(C):
        d = (_pair_scores(qch_rot[..., c, :], kch_rot[..., c, :], q_group)
             - _pair_scores(qch[..., c, :], kch[..., c, :], q_group)) * w
        G += d
        deltas[:, c] = d.transpose(0, 1).reshape(nh, -1)
    G = G.transpose(0, 1).reshape(nh, 1, -1).contiguous()           # [nh, 1, N]
    selected = torch.zeros((nkv, C), dtype=torch.bool, device=q.device)
    order = torch.zeros((nkv, r), dtype=torch.int32, device=q.device)
    heads = torch.arange(nh, device=q.device)
    for i in range(r):
        dist = torch.cdist(G, deltas, p=1)[:, 0]                    # [nh, C]
        dist = dist.reshape(nkv, q_group, C).sum(1)                 # [nkv, C]
        dist = torch.where(selected, torch.full_like(dist, float("inf")), dist)
        j_star = torch.argmin(dist, dim=1)                          # [nkv]
        G -= deltas[heads, j_star.repeat_interleave(q_group)][:, None]
        selected[torch.arange(nkv, device=q.device), j_star] = True
        order[:, i] = j_star.int()
    return order


# ---------------------------------------------------------------------------
# baseline selection methods (paper §4.3.1)
# ---------------------------------------------------------------------------

def uniform_selection(C: int, r: int, nkv: int, device="cpu") -> torch.Tensor:
    """Evenly spaced chunks across the frequency range, same for all heads."""
    idx = np.unique(np.round(np.linspace(0, C - 1, r)).astype(np.int32))
    while len(idx) < r:  # de-dup fallback for tiny C
        extra = [i for i in range(C) if i not in idx][: r - len(idx)]
        idx = np.sort(np.concatenate([idx, np.array(extra, np.int32)]))
    return torch.from_numpy(idx).to(device)[None].repeat(nkv, 1)


def contribution_selection(q: torch.Tensor, k: torch.Tensor, q_group: int,
                           r: int) -> torch.Tensor:
    """Hong et al. style: rank chunks by L2 contribution ‖q_c‖·‖k_c‖ per head."""
    qch, kch = _chunked(q.float()), _chunked(k.float())                  # [B,S,H,C,2]
    qn = torch.sqrt(torch.mean(torch.sum(qch ** 2, -1), (0, 1)))         # [nh,C]
    kn = torch.sqrt(torch.mean(torch.sum(kch ** 2, -1), (0, 1)))         # [nkv,C]
    nkv = kn.shape[0]
    contrib = qn.reshape(nkv, q_group, -1).sum(1) * kn                    # [nkv,C]
    return torch.topk(contrib, r, dim=-1).indices.int()


# ---------------------------------------------------------------------------
# whole-model search
# ---------------------------------------------------------------------------

def layer_qk(layer_params, x: torch.Tensor):
    """Projections q [B,S,nh,dh] and k [B,S,nkv,dh] of one attention layer
    from its captured normed input x [B,S,d]."""
    dt = x.dtype
    q = torch.einsum("bsd,dhe->bshe", x, layer_params["wq"].to(dt))
    k = torch.einsum("bsd,dhe->bshe", x, layer_params["wk"].to(dt))
    return q, k


def search_model(params, buffers, cfg, batch, r: int, method: str = "greedy",
                 moe_impl: str = "dense", causal: bool = True) -> Dict[int, torch.Tensor]:
    """Elite chunks for every attention layer of a *baseline* (non-elite)
    model — dense, MoE, hybrid or pure Mamba — from the calibration
    ``batch`` (the reference's batch dict: tokens [B,S], with a vision
    model's patches before them or an audio model's frames; a bare id
    tensor is the tokens), captured through MoE layers dispatched by
    ``moe_impl`` (the exact "dense" oracle by default, as the reference).
    Positions run over every row of the embedded sequence, patches
    included.

    Returns {absolute layer index: [n_kv, r] int32} over the attention
    layers only ({} for a stack without any), greedy order preserved, on
    the params' device.
    """
    assert not cfg.elitekv.enabled, "search runs on the baseline model"
    if method not in ("greedy", "uniform", "contribution"):
        raise ValueError(method)
    caps = lm.capture_attn_inputs(params, buffers, cfg, batch, moe_impl=moe_impl)
    out: Dict[int, torch.Tensor] = {}
    positions = None
    for li, x in caps.items():
        if method == "uniform":
            out[li] = uniform_selection(cfg.head_dim // 2, r, cfg.n_kv_heads, x.device)
            continue
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        q, k = layer_qk(params["layers"][li]["attn"], x)
        if method == "greedy":
            out[li] = greedy_search_layer(q, k, positions, cfg.rope_theta, cfg.q_group,
                                          r, causal)
        else:
            out[li] = contribution_selection(q, k, cfg.q_group, r)
    return out


def chunk_masks(elite_idx: torch.Tensor, C: int, q_group: int):
    """(per-query-head mask [nh, C], per-kv-head mask [nkv, C]) of the
    chunks in ``elite_idx`` [nkv, r]."""
    nkv = elite_idx.shape[0]
    mask_kv = torch.zeros((nkv, C), dtype=torch.bool, device=elite_idx.device)
    mask_kv[torch.arange(nkv, device=elite_idx.device)[:, None], elite_idx.long()] = True
    return mask_kv.repeat_interleave(q_group, 0), mask_kv


def score_distance(q, k, positions, theta: float, q_group: int, elite_idx,
                   causal: bool = True) -> torch.Tensor:
    """‖s(full) − s(elite set)‖₁ per query head [nh] — the diagnostic the
    tests and the card's check compare the selection methods by."""
    C = q.shape[-1] // 2
    mask_q, mask_kv = chunk_masks(torch.as_tensor(elite_idx, device=q.device), C, q_group)
    q_sub = rope_lib.apply_rope_subset(q, positions, theta, mask_q)
    k_sub = rope_lib.apply_rope_subset(k, positions, theta, mask_kv)
    q_rot, k_rot = rope_lib.apply_rope_qk(q.contiguous(), k.contiguous(), positions, theta)

    def scores(qq, kk):
        kk = torch.repeat_interleave(kk, q_group, dim=2) if q_group > 1 else kk
        return torch.einsum("bqhd,bkhd->bhqk", qq, kk)

    w = _causal(q.shape[1], causal, q.device)[None, None]
    return torch.sum(torch.abs(scores(q_rot, k_rot) - scores(q_sub, k_sub)) * w,
                     dim=(0, 2, 3))
