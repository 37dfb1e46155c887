"""AdamW with selectable moment precision: f32, bf16 or int8.

The port's own copy of the JAX package's ``optim/adamw.py``, formula for
formula: the same clip by the global norm, the same bias corrections
``1 - b ** step`` taken in f32 tensors, weight decay inside the step
(``p - lr * (m̂ / (√v̂ + eps) + wd * p)``), and the same int8 moments (per
trailing-row absmax / 127, rounded half to even, clipped to ±127).  It is
not ``torch.optim.AdamW``, which decays the weights before the step and
rounds its corrections in f64.

Trees are the port's nested dicts and lists, walked in JAX's order
(``repro_torch.tree``); an int8 moment leaf is ``{"q": int8, "s": f32}``.
``update`` is functional, as the reference's: it returns new parameter and
moment tensors and leaves its inputs as they were.  The port's layers are
one leaf each, so a leaf's f32 transients are one layer's already;
``update_chunk`` still cuts a leaf of three or more axes into slices of
that many rows of its first axis, which gives the same values.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.tree import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95          # paper §4.1 training setup
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"   # float32 | bfloat16 | int8
    update_chunk: int = 0           # 0 = whole-leaf update


# --- int8 block quantization (per trailing-row absmax) ----------------------

def _quant(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    if x.dim():
        scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0
    else:
        scale = torch.abs(x) / 127.0
    scale = torch.clamp(scale, min=1e-20)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.float()}


def _dequant(qs: Dict[str, torch.Tensor]) -> torch.Tensor:
    return qs["q"].float() * qs["s"]


def _encode(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _quant(x)
    if dtype == "bfloat16":
        return x.to(torch.bfloat16)
    return x.float()


def _decode(x, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _dequant(x)
    return x.float()


# ---------------------------------------------------------------------------

def _meta_moment(shape, dtype: str):
    """What ``_encode`` makes of a leaf of ``shape``, shape-only on meta."""
    empty = lambda s, dt: torch.empty(s, dtype=dt, device="meta")
    if dtype == "int8":
        return {"q": empty(shape, torch.int8),
                "s": empty(tuple(shape[:-1]) + (1,) if len(shape) else (), torch.float32)}
    return empty(shape, torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def init(params, cfg: AdamWConfig):
    """Zero moments in ``cfg.moment_dtype`` and step 0 (int32, on the
    device of the first leaf); on meta the same tree, shape-only."""
    dev = next(leaves(params)).device
    zeros = lambda p: _encode(torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                              cfg.moment_dtype)
    if dev.type == "meta":
        zeros = lambda p: _meta_moment(tuple(p.shape), cfg.moment_dtype)
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": map_tree(zeros, params), "v": map_tree(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    """√ of the sum of every leaf's sum of squares (f32), leaves summed in
    JAX's order."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@torch.no_grad()
def update(grads, state, params, lr, cfg: AdamWConfig):
    """One AdamW step.  ``lr`` an f32 scalar tensor (or float).  Returns
    (new_params, new_state, {"grad_norm": the norm before clipping})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    if cfg.clip_norm is not None:
        scale = torch.clamp(torch.div(_f32(cfg.clip_norm, gnorm),
                                      torch.clamp(gnorm, min=1e-12)), max=1.0)
        grads = map_tree(lambda g: g * scale, grads)
    b1, b2, md = cfg.b1, cfg.b2, cfg.moment_dtype
    stepf = step.float()
    c1 = 1.0 - torch.pow(_f32(b1, stepf), stepf)
    c2 = 1.0 - torch.pow(_f32(b2, stepf), stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)

    def upd_one(p, g, m_enc, v_enc):
        g = g.float()
        m = _decode(m_enc, md) * b1 + (1 - b1) * g
        v = _decode(v_enc, md) * b2 + (1 - b2) * g * g
        mh = m / c1
        vh = v / c2
        pf = p.float()
        newp = pf - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf)
        return newp.to(p.dtype), _encode(m, md), _encode(v, md)

    def upd(p, g, m_enc, v_enc):
        ck = cfg.update_chunk
        if ck and p.dim() >= 3 and p.shape[0] > ck and p.shape[0] % ck == 0:
            sl = lambda t, i: map_tree(lambda x: x[i:i + ck], t)
            outs = [upd_one(p[i:i + ck], g[i:i + ck], sl(m_enc, i), sl(v_enc, i))
                    for i in range(0, p.shape[0], ck)]
            cat = lambda *xs: torch.cat(xs, dim=0)
            return (cat(*(o[0] for o in outs)), map_tree(cat, *(o[1] for o in outs)),
                    map_tree(cat, *(o[2] for o in outs)))
        return upd_one(p, g, m_enc, v_enc)

    outs = map_tree(upd, params, grads, state["m"], state["v"])
    pick = lambda j: map_tree(lambda o: o[j], outs)
    new_state = {"step": step, "m": pick(1), "v": pick(2)}
    return pick(0), new_state, {"grad_norm": gnorm}
