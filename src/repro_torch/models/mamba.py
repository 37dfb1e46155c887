"""Mamba-1 block (selective SSM): Falcon-Mamba's and Jamba's mixer.

Counterpart of the JAX package's ``models/mamba.py``.  The scan is chunked
as the reference's is: ``cfg.ssm_chunk`` steps at a time (the tail chunk
zero-padded), the state carried from chunk to chunk, so at most
``B × chunk × d_inner × d_state`` f32 of the state expansion is live.
Inside a chunk the linear recurrence ``h_t = a_t · h_{t-1} + b_t`` runs as a
Hillis–Steele scan over the ``(a, b)`` pairs: ``log2(chunk)`` out-of-place
rounds, each combining every element with the one ``2^j`` before it, where
a per-step loop would issue ``chunk`` rounds of small kernels (128 per chunk
and layer; 64 layers × 8 chunks of a 1024-token prefill is ~10^5 launches
on the card).  The products of ``a = exp(Δ·A)`` stay in (0, 1] and at worst
underflow to 0; no log-space cumulative sum is taken, which would overflow
f32 within a chunk.  The scan is plain PyTorch: the reference computes it
outside any Pallas kernel too.

Under autograd each chunk's step is recomputed in the backward (a
non-reentrant ``torch.utils.checkpoint`` per chunk, the reference's
``jax.checkpoint(step)``), unless ``cfg.ssm_unroll``: only the chunks'
inputs and the ``[B, d_inner, N]`` carries are kept, where the rounds'
``[B, chunk, d_inner, N]`` pairs of every chunk would be (about 17 such
tensors per chunk; at Falcon-Mamba's width and B 8 × S 512, ~9 GB per
chunk).  The recompute changes no bits, and it nests inside the layer's
own checkpoint (``lm._remat``).

Decode is the reference's one-token recurrence over ``(conv, ssm)``, term
for term: the conv window's last ``K-1`` pre-activation inputs and the f32
``[B, d_inner, N]`` state.  There is no KV cache, which is why EliteKV does
not apply to these layers.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import is_dtensor, matmul, settled
from repro_torch.models.layers import dense_init


def _dt_rank(cfg) -> int:
    return cfg.dt_rank or -(-cfg.d_model // 16)


def init(cfg, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Random params for one layer: S4D-real ``A``, the Δ bias the inverse
    softplus of a log-uniform Δ in [1e-3, 1e-1]."""
    d, di, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    dtr = _dt_rank(cfg)
    g = generator
    A = torch.arange(1, N + 1, dtype=torch.float32, device=device)[None, :].repeat(di, 1)
    params = {
        "in_proj": dense_init((d, 2 * di), g, device),
        "conv_w": dense_init((K, di), g, device, scale=K ** -0.5),
        "conv_b": torch.zeros(di, device=device),
        "x_proj": dense_init((di, dtr + 2 * N), g, device),
        "dt_w": dense_init((dtr, di), g, device, scale=dtr ** -0.5),
    }
    u = torch.rand(di, generator=g, device=device)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    params.update(dt_b=dt_init + torch.log(-torch.expm1(-dt_init)), A_log=torch.log(A),
                  D=torch.ones(di, device=device),
                  out_proj=dense_init((di, d), g, device))
    return params


def _channelwise(fn, xs, *per_channel):
    """``fn(xs, *per_channel)`` of a ``DTensor`` xs [B,S,di] and weights
    whose last dim is di, run on each rank's lanes and channels
    (``local_map``): the weights cut to xs's channel shards, their
    gradients ``Partial`` over the mesh dims that shard the lanes.  → its
    output placed as xs."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    w_pl = [[Shard(t.dim() - 1) if p == Shard(2) else Replicate() for p in xs.placements]
            for t in per_channel]
    w_grad = [[Partial() if p == Shard(0) else q for p, q in zip(xs.placements, pl)]
              for pl in w_pl]
    f = local_map(fn, out_placements=list(xs.placements),
                  in_placements=(list(xs.placements), *w_pl),
                  in_grad_placements=(list(xs.placements), *w_grad),
                  device_mesh=xs.device_mesh, redistribute_inputs=True)
    return f(xs, *per_channel)


def _conv_causal(xs: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, unrolled over the K taps.  xs [B,S,di],
    w [K,di] (per rank's lanes and channels on ``DTensor``s)."""
    if is_dtensor(xs):
        return _channelwise(_conv_causal, xs, w, b)
    K, S = w.shape[0], xs.shape[1]
    pad = F.pad(xs, (0, 0, K - 1, 0))
    out = torch.zeros_like(xs)
    for t in range(K):
        out = out + pad[:, t:t + S, :] * w[t][None, None, :]
    return out + b.to(xs.dtype)[None, None, :]


def _ssm_params(params, cfg, xs):
    """Per-token Δ, B, C from the conv output xs [B,S,di] (after silu), and
    A = -exp(A_log) [di,N] f32."""
    dt_ = xs.dtype
    dtr, N = _dt_rank(cfg), cfg.ssm_state
    # a Partial sum over the channel shards on DTensors: reduced once here
    proj = settled(matmul(xs, params["x_proj"].to(dt_)))              # [B,S,dtr+2N]
    dt_low, Bm, Cm = torch.split(proj, [dtr, N, N], dim=-1)
    dt = F.softplus(matmul(dt_low, params["dt_w"].to(dt_)) + params["dt_b"].to(dt_))
    A = -torch.exp(params["A_log"].float())
    return dt, Bm, Cm, A


def _scan_chunk(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``(a, b)`` pairs along axis 1 under the reference's
    combine ``(a1, b1), (a2, b2) → (a2·a1, a2·b1 + b2)``: element ``t``
    becomes ``(Π_{s<=t} a_s, h_t from h = 0)``.  Hillis–Steele rounds, each
    out of place from the previous round's values."""
    L, s = a.shape[1], 1
    while s < L:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return a, b


def _chunk_step(h, dtk, xk, Bk, Ck, A, D):
    """One chunk of the scan from the carry h [B,di,N] f32: → (y [B,ck,di]
    f32, the carry after the chunk, a tensor of its own)."""
    dtk, xk = dtk.float(), xk.float()
    dA = torch.exp(dtk[..., None] * A[None, None])                         # [B,ck,di,N]
    dBx = (dtk * xk)[..., None] * Bk.float()[:, :, None, :]
    aprod, bacc = _scan_chunk(dA, dBx)
    h_ts = aprod * h[:, None] + bacc                                       # [B,ck,di,N]
    y = torch.einsum("bsdn,bsn->bsd", h_ts, Ck.float())
    # a copy: a view would keep the chunk's whole h_ts alive as the carry
    return y + D[None, None] * xk, h_ts[:, -1].clone()


def ssm_scan(dt, xs, Bm, Cm, A, D, h0=None, chunk: int = 128, unroll: bool = False):
    """Selective scan.  dt, xs [B,S,di]; Bm, Cm [B,S,N]; A [di,N]; D [di].
    → y [B,S,di] (xs's dtype) and the final state h [B,di,N] f32.  Where
    autograd records (grad mode on and an input that requires grad), each
    chunk is recomputed in the backward unless ``unroll``."""
    B, S, di = xs.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    n_pad = (-S) % chunk
    if n_pad:
        dt, xs, Bm, Cm = (F.pad(t, (0, 0, 0, n_pad)) for t in (dt, xs, Bm, Cm))
    h = (torch.zeros((B, di, N), dtype=torch.float32, device=xs.device) if h0 is None
         else h0.float())
    A, D = A.float(), D.float()
    recompute = (not unroll and torch.is_grad_enabled()
                 and any(t.requires_grad for t in (dt, xs, Bm, Cm, A, D, h)))
    ys = []
    for i in range(0, S + n_pad, chunk):
        args = (h, dt[:, i:i + chunk], xs[:, i:i + chunk], Bm[:, i:i + chunk],
                Cm[:, i:i + chunk], A, D)
        y, h = (checkpoint(_chunk_step, *args, use_reentrant=False) if recompute
                else _chunk_step(*args))
        ys.append(y.to(xs.dtype))
    return torch.cat(ys, dim=1)[:, :S], h


def _local_scan(dt, xs, Bm, Cm, A, D, chunk: int, unroll: bool):
    """``ssm_scan`` on ``DTensor``s: the recurrence runs per lane and
    channel, so each rank scans its own lanes and channels (``local_map``,
    the reference's GSPMD keeps it sharded too).  B and C, replicated over
    the channel shards, get ``Partial`` gradients there; A and D over the
    lane shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    lane = [Shard(0) if p == Shard(0) else Replicate() for p in xs.placements]
    chan = [Shard(0) if p == Shard(2) else Replicate() for p in xs.placements]
    state = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2) else Replicate()
             for p in xs.placements]
    lane_grad = [Partial() if p == Shard(2) else q for p, q in zip(xs.placements, lane)]
    chan_grad = [Partial() if p == Shard(0) else q for p, q in zip(xs.placements, chan)]
    xp = list(xs.placements)
    fn = local_map(lambda *a: ssm_scan(*a, chunk=chunk, unroll=unroll),
                   out_placements=(xp, state),
                   in_placements=(xp, xp, lane, lane, chan, chan),
                   in_grad_placements=(xp, xp, lane_grad, lane_grad, chan_grad, chan_grad),
                   device_mesh=xs.device_mesh, redistribute_inputs=True)
    return fn(dt, xs, Bm, Cm, A, D)


def apply_full(params, cfg, x, return_state: bool = False, constrain=lambda n, t: t):
    """x [B,S,d] → y [B,S,d]; with ``return_state`` also (conv_state
    [B,K-1,di], ssm_state [B,di,N] f32) for a prefill: the last K-1 conv
    inputs (zero rows before the sequence when S < K-1) and the final
    state.  The two halves of the input projection are constrained as
    ``ssm_h``."""
    dt_ = x.dtype
    xs, z = (constrain("ssm_h", t) for t in _in_halves(params, x))
    xs_act = F.silu(_conv_causal(xs, params["conv_w"].to(dt_), params["conv_b"]))
    dt, Bm, Cm, A = _ssm_params(params, cfg, xs_act)
    scan = _local_scan if is_dtensor(xs_act) else ssm_scan
    y, h_fin = scan(dt, xs_act, Bm, Cm, A, params["D"], chunk=cfg.ssm_chunk,
                    unroll=cfg.ssm_unroll)
    out = matmul(y * F.silu(z), params["out_proj"].to(dt_))
    if not return_state:
        return out
    return out, (_conv_state(xs, cfg.ssm_conv), h_fin)


def _conv_state(xs, K: int):
    """The last K-1 conv inputs of xs [B,S,di] (zero rows before the
    sequence when S < K-1): a prefill's conv state."""
    if is_dtensor(xs):
        return _channelwise(lambda x: _conv_state(x, K), xs)
    return F.pad(xs, (0, 0, K - 1, 0))[:, xs.shape[1]:] if K > 1 else xs[:, :0]


def init_state(cfg, batch: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """One layer's decode state: ``conv`` [B,K-1,di] and ``ssm`` [B,di,N] f32."""
    K, di, N = cfg.ssm_conv, cfg.d_inner, cfg.ssm_state
    return {"conv": torch.zeros((batch, K - 1, di), dtype=dtype, device=device),
            "ssm": torch.zeros((batch, di, N), dtype=torch.float32, device=device)}


def _in_halves(params, x):
    """The input projection's two halves (xs, z) [B,S,di] of x [B,S,d].  On
    ``DTensor``s the smaller of two gathers: with fewer rows than the weight
    (a decode step) the channel-sharded product is gathered and chunked;
    else each half is a planned product of its own, placed as the whole (a
    gather of the weight, where chunking the output would gather it)."""
    w = params["in_proj"].to(x.dtype)
    if not is_dtensor(x):
        return torch.chunk(x @ w, 2, dim=-1)
    if x.numel() // x.shape[-1] < w.shape[0]:
        from torch.distributed.tensor import Replicate, Shard
        y = matmul(x, w)
        y = y.redistribute(y.device_mesh, [Replicate() if p == Shard(y.dim() - 1) else p
                                           for p in y.placements])
        return torch.chunk(y, 2, dim=-1)
    di = w.shape[1] // 2
    return tuple(matmul(x, w[:, i:i + di].redistribute(w.device_mesh, w.placements))
                 for i in (0, di))


def _conv_step(window, w, b):
    """The conv's output at the newest position, [B,1,di], of the window
    [B,K,di] (per rank's lanes and channels on ``DTensor``s)."""
    if is_dtensor(window):
        return _channelwise(_conv_step, window, w, b)
    return (torch.einsum("bkd,kd->bd", window, w) + b.to(window.dtype))[:, None, :]


def _recur(xc, dt, Bm, Cm, h, A, D):
    """One step of the recurrence from the state h [B,di,N] f32: → (y
    [B,1,di] f32 before the gate, the new state)."""
    dt32 = dt[:, 0].float()                                           # [B,di]
    dA = torch.exp(dt32[..., None] * A[None])                         # [B,di,N]
    dBx = (dt32 * xc[:, 0].float())[..., None] * Bm[:, 0].float()[:, None, :]
    h = dA * h + dBx
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].float())
    return (y + D.float()[None] * xc[:, 0].float())[:, None, :], h


def _local_recur(xc, dt, Bm, Cm, h, A, D):
    """``_recur`` on ``DTensor``s: per lane and channel, each rank on its
    own (``local_map``, as ``_local_scan``)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    xp = list(xc.placements)
    lane = [Shard(0) if p == Shard(0) else Replicate() for p in xp]
    chan = [Shard(0) if p == Shard(2) else Replicate() for p in xp]
    state = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2) else Replicate()
             for p in xp]
    fn = local_map(_recur, out_placements=(xp, state),
                   in_placements=(xp, xp, lane, lane, state, chan, chan),
                   device_mesh=xc.device_mesh, redistribute_inputs=True)
    return fn(xc, dt, Bm, Cm, h, A, D)


def apply_decode(params, cfg, x, state,
                 constrain=lambda n, t: t) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step, x [B,1,d] → (y [B,1,d], new state).  The
    two halves of the input projection are constrained as ``ssm_h``; on
    ``DTensor``s the conv window and the recurrence run per lane and channel
    on each rank's shard of the state (channels over "model", as
    ``cache_pspecs`` places them)."""
    dt_ = x.dtype
    xs, z = (constrain("ssm_h", t) for t in _in_halves(params, x))   # [B,1,di]
    window = torch.cat([state["conv"].to(dt_), xs], dim=1)            # [B,K,di]
    xc = F.silu(_conv_step(window, params["conv_w"].to(dt_), params["conv_b"]))  # [B,1,di]
    dt, Bm, Cm, A = _ssm_params(params, cfg, xc)
    recur = _local_recur if is_dtensor(xc) else _recur
    y, h = recur(xc, dt, Bm, Cm, state["ssm"], A, params["D"])
    y = y.to(dt_) * F.silu(z)
    out = matmul(y, params["out_proj"].to(dt_))
    return out, {"conv": window[:, 1:, :].to(state["conv"].dtype), "ssm": h}
