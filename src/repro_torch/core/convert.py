"""Model surgery: baseline GQA/MHA checkpoint → EliteKV checkpoint.

Steps per attention layer (paper §3 pipeline):
  1. RoPElite search gives elite chunk indices per KV head (greedy order;
     ``core/ropelite.py``).
  2. Permute W^q / W^k columns per head so elite chunks occupy dims [0, 2r)
     — query heads use their KV group's elite order (keys are shared).
  3. Slice W^k into the elite part (kept dense, rotated at runtime) and the
     non-elite remainder; J-LRD (or S-LRD) factorize [W^k_ne , W^v]
     (``core/lrd.py``, a float64 SVD on the weights' device).
  4. Store the elite theta values as the buffer ``elite_freqs`` [n_kv, r],
     which the serving paths rotate by.

Also the *GQA mean-pool* conversion (Ainslie et al. 2023) — the paper's
comparison baseline — and EliteKV dimension selection (paper App. C).

Counterpart of the JAX package's ``core/convert.py`` on the port's layout:
one dict per layer (``params["layers"][i]["attn"]``) where the reference
stacks layers under ``params["blocks"]["p{pos}"]``; layers are keyed by
absolute index, so a hybrid stack converts its attention layers and keeps
its Mamba layers.  Weights stay on the
baseline's device, the factorizations included (``core/lrd.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import EliteKVConfig, ModelConfig
from repro_torch.core import lrd as lrd_lib
from repro_torch.core import rope as rope_lib


def _perm_for(elite_idx, C: int) -> np.ndarray:
    """Dim permutation [d_h] putting elite chunk pairs first (greedy order)."""
    elite = [int(c) for c in elite_idx]
    rest = [c for c in range(C) if c not in elite]
    dims = []
    for c in elite + rest:
        dims += [2 * c, 2 * c + 1]
    return np.asarray(dims, np.int64)


def convert_layer(attn_params: Dict, cfg: ModelConfig, e: EliteKVConfig,
                  elite_idx) -> Tuple[Dict, Dict]:
    """One baseline attention layer (``wq``, ``wk``, ``wv``, ``wo``) →
    (EliteKV attention params, buffers), on the weights' device."""
    dh, nkv = cfg.head_dim, cfg.n_kv_heads
    C, r2, G = dh // 2, 2 * e.elite_r, cfg.q_group
    wq, wk, wv = attn_params["wq"], attn_params["wk"], attn_params["wv"]
    dev = wq.device
    elite_idx = np.asarray(torch.as_tensor(elite_idx).cpu())
    assert elite_idx.shape == (nkv, e.elite_r), elite_idx.shape
    perms = torch.from_numpy(np.stack([_perm_for(elite_idx[h], C) for h in range(nkv)]))
    perms = perms.to(dev)                                               # [nkv, dh]
    wk_p = torch.gather(wk, 2, perms[None].expand(wk.shape[0], -1, -1))
    pq = perms.repeat_interleave(G, 0)                                  # [nh, dh]
    wq_p = torch.gather(wq, 2, pq[None].expand(wq.shape[0], -1, -1))
    wk_ne = wk_p[:, :, r2:]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    params = {"wq": wq_p.float().contiguous(), "wk_e": wk_p[:, :, :r2].float().contiguous(),
              "wo": attn_params["wo"].float()}
    if e.lrd == "joint":
        a_kv, bk, bv = lrd_lib.jlrd(wk_ne, wv, e.d_ckv)
        params.update(a_kv=t(a_kv), bk=t(bk), bv=t(bv))
    else:
        a_k, a_v, bk, bv = lrd_lib.slrd(wk_ne, wv, e.d_ck, e.d_cv)
        params.update(a_k=t(a_k), a_v=t(a_v), bk=t(bk), bv=t(bv))
    freqs = rope_lib.chunk_freqs(dh, cfg.rope_theta, device="cpu").numpy()
    return params, {"elite_freqs": t(freqs[elite_idx].astype(np.float32))}


def convert_model(params: Dict, buffers: Dict, cfg: ModelConfig, elite_sets: Dict,
                  elitekv: EliteKVConfig) -> Tuple[Dict, Dict, ModelConfig]:
    """Whole-model conversion of a baseline (dense, MoE, hybrid or pure
    Mamba).  ``elite_sets``: {absolute layer index: [nkv, r]} for every
    attention layer.  → (params, buffers, config) of the EliteKV model:
    each attention layer converted, every Mamba layer and every FFN (MoE
    experts included), the embedding, LM head and norms the baseline's
    tensors (shared, not copied)."""
    assert not cfg.elitekv.enabled
    new_cfg = dataclasses.replace(cfg, elitekv=dataclasses.replace(elitekv, enabled=True))
    layers, bufs = [], []
    for li, layer in enumerate(params["layers"]):
        if cfg.layer_kind(li) != "attn":
            layers.append(layer)
            bufs.append(buffers["layers"][li])
            continue
        pe, be = convert_layer(layer["attn"], cfg, elitekv, elite_sets[li])
        layers.append({**layer, "attn": pe})
        bufs.append(be)
    return {**params, "layers": layers}, {"layers": bufs}, new_cfg


def elitekv_from_baseline(params, buffers, cfg, calib_batch, elitekv: EliteKVConfig,
                          method: str = "greedy", moe_impl: str = "dense"):
    """Search + convert in one call (the paper's full §3 pipeline) on a
    calibration batch (``ropelite.search_model``'s, captured through MoE
    layers by ``moe_impl``)."""
    from repro_torch.core import ropelite
    sets = ropelite.search_model(params, buffers, cfg, calib_batch, elitekv.elite_r,
                                 method=method, moe_impl=moe_impl)
    return convert_model(params, buffers, cfg, sets, elitekv)


# ---------------------------------------------------------------------------
# GQA mean-pool baseline (Ainslie et al.) — the paper's comparison point
# ---------------------------------------------------------------------------

def to_gqa(params: Dict, cfg: ModelConfig, new_n_kv: int) -> Tuple[Dict, ModelConfig]:
    """Mean-pool groups of ``n_kv_heads / new_n_kv`` kv heads of every
    baseline layer's ``wk``/``wv`` into one."""
    assert cfg.n_kv_heads % new_n_kv == 0
    m = cfg.n_kv_heads // new_n_kv
    new_cfg = dataclasses.replace(cfg, n_kv_heads=new_n_kv)

    def pool(w):  # [d, nkv, dh] → mean over groups of m kv heads
        d, _, dh = w.shape
        return w.reshape(d, new_n_kv, m, dh).mean(dim=2)

    layers = []
    for layer in params["layers"]:
        if "wk" not in layer["attn"]:
            layers.append(layer)
            continue
        attn = dict(layer["attn"], wk=pool(layer["attn"]["wk"]), wv=pool(layer["attn"]["wv"]))
        layers.append({**layer, "attn": attn})
    return {**params, "layers": layers}, new_cfg


# ---------------------------------------------------------------------------
# dimension selection (paper App. C)
# ---------------------------------------------------------------------------


def pick_dims(cfg: ModelConfig, target_cache_ratio: float, align: int = 128,
              r_candidates=(2, 4, 8, 16, 32)) -> EliteKVConfig:
    """Choose (r, d_ckv) hitting a target cache ratio.

    Rules (App. C): d_ckv aligned (128 preferred; falls back 64/32/16 for
    GQA archs whose whole cache budget is below 128); no parameter increase
    vs baseline; among valid configs prefer the closest ratio, then the
    largest r (more rotary signal).
    """
    dh, nkv, d = cfg.head_dim, cfg.n_kv_heads, cfg.d_model
    full = 2 * nkv * dh
    base_params = d * dh * 2 * nkv          # W^k + W^v
    best = None
    for r in sorted(r_candidates, reverse=True):
        if 2 * r >= dh:
            continue
        budget = int(target_cache_ratio * full) - 2 * r * nkv
        d_ckv = 0
        for a in (align, 64, 32, 16):
            if (budget // a) * a >= a:
                d_ckv = (budget // a) * a
                break
        if d_ckv <= 0:
            continue
        d_nope = dh - 2 * r
        new_params = (d * 2 * r * nkv                       # W^k elite
                      + d * d_ckv                           # A^kv
                      + d_ckv * (nkv * d_nope + nkv * dh))  # B^k, B^v
        if new_params > base_params:
            continue
        got = (2 * r * nkv + d_ckv) / full
        cand = EliteKVConfig(enabled=True, elite_r=r, d_ckv=d_ckv, lrd="joint")
        if best is None or abs(got - target_cache_ratio) < best[0] - 1e-9:
            best = (abs(got - target_cache_ratio), cand)
    if best is None:
        raise ValueError(f"no valid EliteKV dims for ratio {target_cache_ratio}")
    return best[1]
