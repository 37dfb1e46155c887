"""Shared layers: RMSNorm, SwiGLU MLP, embeddings (and the tied LM head),
the cross-entropy loss, init helpers."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import is_dtensor, matmul, settled


def dense_init(shape: Sequence[int], generator: torch.Generator, device,
               scale: Optional[float] = None, in_axis: int = 0) -> torch.Tensor:
    """Truncated-normal (±3σ) fan-in init (LLaMA-style), drawn from
    ``generator`` on ``device``; on the meta device a shape-only
    ``torch.empty`` that draws nothing (``generator`` may be None)."""
    fan_in = shape[in_axis]
    if scale is None:
        scale = fan_in ** -0.5
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if t.is_meta:
        return t
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return t.mul_(scale)


def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * params["scale"]).to(dt)


def mlp_init(d_model: int, d_ff: int, generator: torch.Generator, device) -> dict:
    return {
        "w_gate": dense_init((d_model, d_ff), generator, device),
        "w_up": dense_init((d_model, d_ff), generator, device),
        "w_down": dense_init((d_ff, d_model), generator, device),
    }


def mlp(params, x: torch.Tensor, constrain=lambda n, t: t) -> torch.Tensor:
    """SwiGLU feed-forward; the hidden activation constrained as ``mlp_h``."""
    h = F.silu(matmul(x, params["w_gate"].to(x.dtype))) * matmul(x, params["w_up"].to(x.dtype))
    return matmul(constrain("mlp_h", h), params["w_down"].to(x.dtype))


def embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The rows of the embedding table (on ``DTensor``s, ``_sharded_embed``)."""
    if is_dtensor(tokens):
        return _sharded_embed(params["table"].to(dtype), tokens)
    return params["table"].to(dtype)[tokens]


def _sharded_embed(table, tokens):
    """Megatron's vocabulary-parallel lookup on ``DTensor``s: the table is
    gathered over the mesh dims that shard its model dim (FSDP), each rank
    looks its tokens up in its own vocabulary rows (zero for the others),
    and the rows are a ``Partial`` sum over the dim that shards the
    vocabulary, which the ``embed`` constraint then reduces."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    t_pl, k_pl, out_pl, t_grad, offset = [], [], [], [], 0
    for i, (pt, pk) in enumerate(zip(table.placements, tokens.placements)):
        if pt == Shard(0):                   # vocabulary rows on this dim
            t_pl.append(pt)
            k_pl.append(Replicate())
            out_pl.append(Partial())
            t_grad.append(pt)
            offset += mesh.get_coordinate()[i] * (table.shape[0] // mesh.size(i))
            continue
        t_pl.append(Replicate())             # gather the model dim (FSDP)
        k_pl.append(pk if pk.is_shard() else Replicate())
        out_pl.append(pk if pk.is_shard() else Replicate())
        t_grad.append(Partial() if pk.is_shard() else Replicate())

    def local(tab, tok):
        idx = tok - offset
        inside = (idx >= 0) & (idx < tab.shape[0])
        rows = tab[torch.where(inside, idx, 0)]
        return torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                 device=rows.device))

    fn = local_map(local, out_placements=out_pl, in_placements=(t_pl, k_pl),
                   in_grad_placements=(t_grad, k_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(table, tokens)


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """The tied LM head: x @ table^T, logits in f32."""
    return matmul(x.float(), params["table"].float().T)


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position negative log-likelihood in f32: logits [..., V], labels
    [...] int64.  On ``DTensor`` logits whose vocabulary is sharded it is
    the vocabulary-parallel form (Megatron's): the row max, the sum of
    exponentials and the gold logit each reduced across the shards, so the
    whole vocabulary never meets on one device, in either pass."""
    logits = logits.float()
    if not is_dtensor(logits):
        logz = torch.logsumexp(logits, dim=-1)
        return logz - torch.gather(logits, -1, labels[..., None])[..., 0]
    m = settled(torch.amax(logits.detach(), dim=-1, keepdim=True))
    z = settled(torch.sum(torch.exp(logits - m), dim=-1))
    return torch.log(z) + m[..., 0] - settled(_gold(logits, labels))


def _gold(logits, labels):
    """The labels' logits of ``DTensor`` logits: each rank picks those of
    its own vocabulary rows (``local_map``), a ``Partial`` sum over the
    mesh dim that shards the vocabulary (so the gather's gradient is only
    ever the local rows)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    vdim = logits.dim() - 1
    mesh = logits.device_mesh
    out_pl, lab_pl, offset = [], [], 0
    for i, p in enumerate(logits.placements):
        if p == Shard(vdim):
            out_pl.append(Partial())
            lab_pl.append(Replicate())
            offset += mesh.get_coordinate()[i] * (logits.shape[vdim] // mesh.size(i))
        else:
            out_pl.append(p if p.is_shard() else Replicate())
            lab_pl.append(p if p.is_shard() else Replicate())

    def local(lg, lab):
        idx = lab - offset
        inside = (idx >= 0) & (idx < lg.shape[-1])
        g = torch.gather(lg, -1, torch.where(inside, idx, 0)[..., None])[..., 0]
        return torch.where(inside, g, torch.zeros((), dtype=g.dtype, device=g.device))

    fn = local_map(local, out_placements=out_pl,
                   in_placements=(list(logits.placements), lab_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(logits, labels)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in f32.  logits [B,S,V], labels [B,S]
    (int64), mask [B,S] (the mean is over its sum, at least 1)."""
    nll_ = nll(logits, labels)
    if mask is not None:
        return torch.sum(nll_ * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll_)
