"""The checks' arithmetic for the port's conversion, used by
``tests/test_torch_convert.py`` and ``chip_smoke.py`` (phase 3i).  No
conversion path uses it.

* ``set_distances64``: RoPElite's score distance of given elite sets,
  recomputed in float64 with its own rotation (no kernel, no plain version
  of the port), which decides whether two searches' differing picks are a
  tie.
* ``compare_sets``: two searches' sets, equal apart from such ties.
* ``subset_rope_logits``: the baseline forward with RoPE restricted to the
  elite sets, which an exact-rank conversion must reproduce.
"""
import torch

#: two searches' picks may differ only where the candidates' float64
#: distances are this close, relatively (a tie that f32 sums decide)
TIE_REL = 1e-6


def set_distances64(q, k, theta: float, q_group: int, sets) -> torch.Tensor:
    """‖s(full) − s(elite set)‖₁ per kv head in float64 on q's device,
    causal, positions 0..S-1; q [B,S,nh,dh], k [B,S,nkv,dh]; ``sets`` [nkv]
    lists of chunk indices.  → [nkv]."""
    q, k = q.double(), k.double()
    B, S, nh, dh = q.shape
    nkv, C = k.shape[2], dh // 2
    f = theta ** (-2.0 * torch.arange(C, dtype=torch.float64, device=q.device) / dh)
    ang = torch.arange(S, dtype=torch.float64, device=q.device)[:, None] * f

    def rot(x, mask):                                  # mask [H, C]
        a = ang[None, :, None, :] * mask[None, None]
        c, s = torch.cos(a), torch.sin(a)
        x0, x1 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], -1).flatten(-2)

    m = torch.zeros((nkv, C), dtype=torch.float64, device=q.device)
    for h, cs in enumerate(sets):
        m[h, list(cs)] = 1.0

    def scores(mk):
        qq = rot(q, mk.repeat_interleave(q_group, 0))
        kk = rot(k, mk).repeat_interleave(q_group, 2)
        return torch.einsum("bqhd,bkhd->bhqk", qq, kk)

    w = torch.tril(torch.ones((S, S), dtype=torch.float64, device=q.device))
    d = (torch.abs(scores(torch.ones_like(m)) - scores(m)) * w).sum((0, 2, 3))
    return d.reshape(nkv, q_group).sum(-1)


def compare_sets(label: str, got, want, q, k, theta: float, q_group: int,
                 report=print) -> int:
    """Search sets [nkv, r] against another search's: per kv head the picks
    must be equal in order; at the first pick that differs, the two sets
    (the common picks plus either candidate) must be a float64 tie within
    TIE_REL, and that head is compared no further.  Each tie is passed to
    ``report``.  → the number of ties; raises AssertionError otherwise."""
    got = torch.as_tensor(got).cpu().tolist()
    want = torch.as_tensor(want).cpu().tolist()
    assert len(got) == len(want), (len(got), len(want))
    ties = 0
    for h, (a, b) in enumerate(zip(got, want)):
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        if not diff:
            continue
        i = diff[0]
        both = []
        for pick in (a[i], b[i]):
            sets = [row[:i + 1] for row in want]
            sets[h] = b[:i] + [pick]
            both.append(float(set_distances64(q, k, theta, q_group, sets)[h]))
        rel = abs(both[0] - both[1]) / max(abs(both[0]), abs(both[1]))
        report(f"{label} kv head {h}: pick {i} is {a[i]} against {b[i]}; float64 "
               f"distances {both[0]:.9e} vs {both[1]:.9e} (relative {rel:.2e})")
        if not rel <= TIE_REL:
            raise AssertionError(f"{label} kv head {h}: pick {i} differs and is no tie")
        ties += 1
    return ties


def subset_rope_logits(params, cfg, sets, tokens):
    """The port's baseline forward of ``tokens`` [B,S] with every layer's
    RoPE restricted to its elite sets ({layer: [nkv, r]}), plain attention:
    what an exact-rank conversion must give.  → logits [B,S,Vp]."""
    from repro_torch.core import rope, ropelite
    from repro_torch.models import attention, lm
    from repro_torch.models.layers import mlp, rmsnorm
    C = cfg.head_dim // 2
    h = params["embed"]["table"][tokens]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for li, layer in enumerate(params["layers"]):
        p = layer["attn"]
        hn = rmsnorm(layer["attn_norm"], h, cfg.norm_eps)
        q, k, v = (torch.einsum("bsd,dhe->bshe", hn, p[w]) for w in ("wq", "wk", "wv"))
        mq, mkv = ropelite.chunk_masks(torch.as_tensor(sets[li], device=h.device), C,
                                       cfg.q_group)
        q = rope.apply_rope_subset(q, pos, cfg.rope_theta, mq)
        k = rope.apply_rope_subset(k, pos, cfg.rope_theta, mkv)
        o = attention._attend(q, k, v, cfg.q_group, cfg.head_dim ** -0.5)
        h = h + torch.einsum("bshe,hed->bsd", o, p["wo"])
        h = h + mlp(layer["ffn"], rmsnorm(layer["ffn_norm"], h, cfg.norm_eps))
    return lm._logits(params, cfg, rmsnorm(params["final_norm"], h, cfg.norm_eps))
