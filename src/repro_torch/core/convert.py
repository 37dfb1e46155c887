"""EliteKV dimension selection (paper App. C).

Only ``pick_dims`` is ported so far: the RoPElite search and the J-LRD
factorization of a baseline checkpoint come with the conversion slice.
"""
from __future__ import annotations

from repro_torch.configs.base import EliteKVConfig, ModelConfig


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
