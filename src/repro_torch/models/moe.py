"""Mixture-of-experts FFN: top-k router and two dispatch implementations.

Counterpart of the JAX package's ``models/moe.py``:

  * ``dense``  — the oracle: every expert computes every token, combined by
                 the gates (exact, E times the work); for tests.
  * ``ragged`` — the tokens' k assignments sorted by expert (stable), then
                 three ``torch.matmul``s per expert that received any rows,
                 on its contiguous slice of the sorted rows; the reference
                 runs ``jax.lax.ragged_dot`` here.  Splitting the rows needs
                 the group sizes on the host: one device-to-host read per
                 MoE layer and forward, counted in ``group_size_syncs``
                 (under the layer remat a training step reads them twice:
                 forward and recompute).  Each expert weight is split
                 once per call, so its gradient is one ``stack``.  A meta
                 input (the dry run's shape-only trace) holds no ids to
                 read: it takes the group sizes of balanced routing
                 (``even_group_sizes``), so the matmuls' shapes and FLOPs
                 are those of k experts per token, not E.

The reference's third implementation, ``ep`` (expert parallelism over a
mesh), is not ported: ``impl="ep"`` raises.

Router: softmax → top-k → renormalise over the k gates (Qwen/Mixtral
style), with the Switch load-balance auxiliary loss.  The top-k is a stable
descending sort, so equal probabilities go to the lower expert index first,
as ``lax.top_k`` orders them.  Both implementations compute in plain
PyTorch: the reference reaches no Pallas kernel here either.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, mlp, mlp_init

#: device-to-host reads of the expert group sizes (``apply_ragged``: one per
#: call); set it to 0 before a run and read it after
group_size_syncs = 0


def init(cfg, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Random params for one MoE FFN (with the reference's fan-in rules):
    ``router`` [d,E], ``w_gate``/``w_up`` [E,d,f], ``w_down`` [E,f,d], and
    Arctic's parallel ``dense`` MLP when ``cfg.dense_residual``."""
    d, E = cfg.d_model, cfg.n_experts
    f = cfg.moe_dff or cfg.d_ff
    g = generator
    p = {
        "router": dense_init((d, E), g, device, scale=0.02),
        "w_gate": dense_init((E, d, f), g, device),
        "w_up": dense_init((E, d, f), g, device),
        "w_down": dense_init((E, f, d), g, device, in_axis=1),
    }
    if cfg.dense_residual:
        p["dense"] = mlp_init(d, cfg.d_ff, g, device)
    return p


def _route(params, cfg, xf):
    """xf [T,d] → (gates [T,k] in xf's dtype, idx [T,k] int64, aux scalar f32)."""
    logits = (xf @ params["router"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                       # [T,E]
    top_p, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, idx = top_p[:, :cfg.top_k], idx[:, :cfg.top_k]
    gates = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    E = cfg.n_experts
    me = probs.mean(dim=0)                                       # [E]
    ce = F.one_hot(idx, E).float().sum(1).mean(dim=0)
    aux = E * torch.sum(me * ce)
    return gates.to(xf.dtype), idx, aux


def _maybe_dense_residual(params, cfg, xf, y):
    if cfg.dense_residual and "dense" in params:
        y = y + mlp(params["dense"], xf)
    return y


def apply_dense(params, cfg, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle: all experts on all tokens, combined by the gates."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    gates, idx, aux = _route(params, cfg, xf)
    dt = x.dtype
    g = torch.einsum("td,edf->etf", xf, params["w_gate"].to(dt))
    u = torch.einsum("td,edf->etf", xf, params["w_up"].to(dt))
    y_all = torch.einsum("etf,efd->etd", F.silu(g) * u, params["w_down"].to(dt))
    comb = torch.zeros((xf.shape[0], cfg.n_experts), dtype=dt, device=x.device)
    comb.scatter_(1, idx, gates)
    y = torch.einsum("te,etd->td", comb, y_all)
    y = _maybe_dense_residual(params, cfg, xf, y)
    return y.reshape(B, S, d), aux


def even_group_sizes(rows: int, n_experts: int) -> list:
    """The group sizes of balanced routing: each expert takes
    ``ceil(rows / n_experts)`` rows, the last ones trimmed so the sizes sum
    to ``rows``."""
    q = -(-rows // n_experts)
    return [max(0, min(q, rows - e * q)) for e in range(n_experts)]


def apply_ragged(params, cfg, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted grouped dispatch: each expert's rows in one contiguous slice,
    three matmuls per expert that has rows."""
    global group_size_syncs
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    gates, idx, aux = _route(params, cfg, xf)
    flat = idx.reshape(-1)                                       # [T*k]
    order = torch.argsort(flat, stable=True)
    xs = xf[order // k]                                          # [T*k, d]
    if x.is_meta:                   # the dry run: no ids to read, balanced groups
        sizes = even_group_sizes(T * k, E)
    else:
        sizes = torch.bincount(flat, minlength=E).tolist()       # the one host read
        group_size_syncs += 1
    dt = x.dtype
    # each weight split once: under autograd one ``stack`` gathers its
    # experts' gradients, where a ``select`` per expert would add a zero
    # tensor of the whole [E, d, f] into the gradient for each expert
    w_gate, w_up, w_down = (torch.unbind(params[k].to(dt), 0)
                            for k in ("w_gate", "w_up", "w_down"))
    ys, start = [], 0
    for e, n in enumerate(sizes):
        if n:
            xe = xs[start:start + n]
            h = F.silu(xe @ w_gate[e]) * (xe @ w_up[e])
            ys.append(h @ w_down[e])
            start += n
    y = torch.empty_like(xs)
    y[order] = torch.cat(ys)                                     # unsort
    y = (y * gates.reshape(-1, 1)).reshape(T, k, d).sum(dim=1)
    y = _maybe_dense_residual(params, cfg, xf, y)
    return y.reshape(B, S, d), aux


def check_impl(impl: str) -> None:
    """Raise ``ValueError`` unless ``impl`` is "dense" or "ragged" ("ep" is
    not ported)."""
    if impl == "ep":
        raise ValueError("moe impl 'ep' (expert parallelism over a device mesh) is not "
                         "ported: ROADMAP Queue 1 item 15d (training across cards)")
    if impl not in ("dense", "ragged"):
        raise ValueError(f"unknown moe impl {impl!r}: expected dense or ragged")


def apply(params, cfg, x, impl: str = "ragged") -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] → (y [B,S,d], aux scalar f32)."""
    check_impl(impl)
    return (apply_dense if impl == "dense" else apply_ragged)(params, cfg, x)
