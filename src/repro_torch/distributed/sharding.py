"""The reference's placement rules: which mesh axes shard each parameter,
optimizer moment, input and cache leaf.

The port's own copy of the JAX package's ``distributed/sharding.py`` rules,
as plain functions of a leaf's path and shape.  Mesh axes (``launch/mesh.py``):

  single-pod  (16, 16)        →  ("data", "model")
  multi-pod   (2, 16, 16)     →  ("pod", "data", "model")

  * TP   — attention heads / FFN hidden / vocab over "model".
  * FSDP — the non-TP dim of every large matrix also over ("pod",)+("data",)
           (ZeRO-3).
  * EP   — MoE experts over "model", the expert hidden dim over the data axes.
  * DP   — batch over the data axes; a batch that does not divide them
           shards the cache sequence over them instead (context parallelism).

A ``MeshPlan`` holds axis names and sizes, not devices.  A spec is a tuple
with one entry per tensor dim: None (replicated), an axis name, or a tuple
of axis names (sharded over their product); ``()`` is a replicated scalar
or a replicated leaf of any rank, as the reference's ``P()``.  The port's
parameter tree is a list of layers (``layers/{i}/attn/wq``), not the
reference's stacked ``blocks/p{pos}``, so a port spec is the reference's
without the leading stack axis; cache leaves keep their ``[n_super, ...]``
stack in both.  ``shard_shape`` gives a leaf's per-device shape, and the
sizes-only functions need no mesh (``launch/dryrun.py``'s resident bytes).

The executor places tensors by the rules on a ``torch.distributed``
``DeviceMesh`` (``launch/mesh.py``), the counterpart of GSPMD's
``NamedSharding``: ``plan_for_mesh(device_mesh)`` keeps the mesh,
``placements`` turns a spec into the mesh's ``Shard``/``Replicate``
placements, ``param_shardings``/``opt_shardings``/``cache_shardings``/
``input_shardings``/``serving_page_shardings`` give a ``Sharding`` per leaf,
and ``distribute`` makes the ``DTensor``s (each rank keeps its own shard).
``make_constrain`` is the reference's activation hook: at 13 named points
of the forward it redistributes a ``DTensor`` to the reference's spec (the
counterpart of ``with_sharding_constraint``), and hands a plain tensor back
as it is, so every one-device path keeps its bits.

Head padding: archs whose head count does not divide the TP size (Arctic
56, MiniCPM 36 at TP 16) are padded with extra heads (56 → 64, 36 → 48) by
``pad_cfg_for_tp``, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.tree import leaves, map_tree

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Axis names and sizes of a mesh (in order) and how the rules use
    them: ``tp_axis`` for tensor parallelism, ``dp_axes`` for data
    parallelism (and FSDP where ``fsdp``)."""
    axes: Tuple[Tuple[str, int], ...]
    tp_axis: str = "model"
    dp_axes: Tuple[str, ...] = ("data",)
    fsdp: bool = True
    seq_parallel: bool = True
    #: the ``DeviceMesh`` the executor places tensors on (None: sizes only)
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def tp(self) -> int:
        return self.sizes[self.tp_axis]

    @property
    def n_dp(self) -> int:
        return math.prod(self.sizes[a] for a in self.dp_axes)

    @property
    def chips(self) -> int:
        return math.prod(n for _, n in self.axes)

    @property
    def dp(self):
        if not self.dp_axes:                 # tp-only serving submesh
            return None
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    @property
    def tag(self) -> str:
        return "x".join(str(n) for _, n in self.axes)


def plan_for_mesh(axes, fsdp: bool = True, seq_parallel: bool = True) -> MeshPlan:
    """The plan of a mesh given as ``{axis name: size}`` in mesh order, or
    as a ``DeviceMesh`` (which the plan then keeps for the executor): every
    axis but "model" is a data axis."""
    mesh = None
    if not isinstance(axes, Mapping):
        mesh = axes
        axes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    dp_axes = tuple(a for a in axes if a != "model")
    return MeshPlan(axes=tuple((a, int(n)) for a, n in axes.items()), dp_axes=dp_axes,
                    fsdp=fsdp, seq_parallel=seq_parallel, mesh=mesh)


def pad_cfg_for_tp(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Pad head counts up to the next TP multiple (zero-init extra heads)."""
    nh = cfg.n_heads
    nkv = cfg.n_kv_heads
    if nh % tp == 0:
        return cfg
    new_nh = -(-nh // tp) * tp
    if cfg.q_group == 1:
        new_nkv = new_nh                 # MHA: pad kv heads along
    else:
        new_nkv = nkv                    # GQA: keep kv heads, grow the group
        while new_nh % new_nkv:          # (arctic 56→64: group 7→8)
            new_nh += tp
    return dataclasses.replace(cfg, n_heads=new_nh, n_kv_heads=new_nkv,
                               d_head=cfg.head_dim)


# ---------------------------------------------------------------------------
# parameter specs (path-rule based)
# ---------------------------------------------------------------------------

def _spec_for(path: str, shape: Tuple[int, ...], cfg: ModelConfig,
              plan: MeshPlan) -> Spec:
    """The spec of the parameter at ``path`` ("/"-joined keys and layer
    indices, e.g. ``layers/3/ffn/w_gate``) of ``shape``."""
    tp = plan.tp_axis
    fsdp = plan.dp if plan.fsdp else None
    name = path.split("/")[-1]
    n_dp, ntp = plan.n_dp, plan.tp
    fs = lambda dim: fsdp if (fsdp and dim % n_dp == 0) else None
    tps = lambda dim: tp if dim % ntp == 0 else None

    if name == "table":                       # [V, d]
        return (tps(shape[0]), fs(shape[1]))
    if path.startswith("lm_head"):            # [d, V]
        return (fs(shape[0]), tps(shape[1]))
    if name in ("conv_b", "dt_b", "D"):       # [di]
        return (tps(shape[0]),)
    if name == "scale":
        return (None,)
    if "ffn/dense" in path:                   # arctic parallel MLP
        if name in ("w_gate", "w_up"):
            return (None, tps(shape[1]))
        return (tps(shape[0]), None)
    if "ffn" in path and name == "router":    # [d, E] (replicated)
        return (None, None)
    if "ffn" in path and len(shape) == 3 and name in ("w_gate", "w_up"):
        # MoE experts [E, d, f]: EP over model, ZeRO-3 over data on f
        return (tps(shape[0]), None, fs(shape[2]))
    if "ffn" in path and len(shape) == 3 and name == "w_down":   # [E, f, d]
        return (tps(shape[0]), fs(shape[1]), None)
    if name in ("w_gate", "w_up"):            # dense MLP [d, f]
        return (fs(shape[0]), tps(shape[1]))
    if name == "w_down":                      # [f, d]
        return (tps(shape[0]), fs(shape[1]))
    if name == "wq":                          # [d, nh, dh]
        return (fs(shape[0]), tps(shape[1]), None)
    if name in ("wk", "wv", "wk_e"):          # [d, nkv, *]
        return (fs(shape[0]), tps(shape[1]), None)
    if name == "wo":                          # [nh, dh, d]
        return (tps(shape[0]), None, fs(shape[2]))
    if name in ("a_kv", "a_k", "a_v"):        # [d, d_c]
        return (fs(shape[0]), None)
    if name in ("bk", "bv"):                  # [d_c, nkv, *]
        return (None, tps(shape[1]), None)
    # --- mamba ---
    if name == "in_proj":                     # [d, 2di]
        return (fs(shape[0]), tps(shape[1]))
    if name == "conv_w":                      # [K, di]
        return (None, tps(shape[1]))
    if name == "x_proj":                      # [di, dtr+2N]
        return (tps(shape[0]), None)
    if name == "dt_w":                        # [dtr, di]
        return (None, tps(shape[1]))
    if name == "A_log":                       # [di, N]
        return (tps(shape[0]), None)
    if name == "out_proj":                    # [di, d]
        return (tps(shape[0]), fs(shape[1]))
    if name == "elite_freqs":                 # [nkv, r] buffer
        return (None, None)
    return (None,) * len(shape)


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists; a path joins the
    keys and list indices with "/"."""
    join = lambda k: f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, join(i)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def param_pspecs(params, cfg: ModelConfig, plan: MeshPlan):
    """A spec per leaf of ``params`` (or of ``buffers``), in its structure."""
    return _map_with_path(lambda path, leaf: _spec_for(path, tuple(leaf.shape), cfg, plan),
                          params)


def opt_pspecs(opt_state, params, cfg: ModelConfig, plan: MeshPlan, moment_dtype: str):
    """Specs of the AdamW state: the moments take their parameter's spec;
    an int8 moment's per-row scales ``s`` (last dim 1) leave the last dim
    unsharded."""
    pspecs = param_pspecs(params, cfg, plan)
    if moment_dtype == "int8":
        m = map_tree(lambda spec: {"q": spec, "s": tuple(spec)[:-1] + (None,)}, pspecs)
    else:
        m = pspecs
    return {"step": (), "m": m, "v": m}


# ---------------------------------------------------------------------------
# serving pool pages
# ---------------------------------------------------------------------------

def serving_page_pspecs(cfg: ModelConfig, plan: MeshPlan) -> Dict[str, Spec]:
    """Specs of the paged serving pool's per-stream page arrays
    (``core/cache.py``): ``k_e [n_super, n_slots, nkv, 2r]`` shards its kv
    heads over the TP axis where they divide it; the head-shared latent
    ``c``/``c_k``/``c_v``, the per-token int8 scales and the sparse block
    summaries replicate, which keeps block ids, prefix hashes, copies, swap
    and scales the same on every shard."""
    head = plan.tp_axis if (plan.tp > 1 and cfg.n_kv_heads % plan.tp == 0) else None
    specs: Dict[str, Spec] = {"k_e": (None, None, head, None)}
    for name in ("c", "c_k", "c_v", "k_e_scale", "c_scale", "c_k_scale", "c_v_scale",
                 "c_blkmean", "c_blkmax", "c_k_blkmean", "c_k_blkmax"):
        specs[name] = ()
    return specs


# ---------------------------------------------------------------------------
# inputs / cache
# ---------------------------------------------------------------------------

def input_pspecs(cfg: ModelConfig, shape: ShapeConfig, plan: MeshPlan) -> Dict[str, Spec]:
    """Inputs shard their batch over the data axes where it divides them."""
    dp = plan.dp if shape.global_batch % plan.n_dp == 0 else None
    names = {"tokens": 2, "labels": 2, "frames": 3, "patch_embeds": 3}
    return {name: (dp,) + (None,) * (nd - 1) for name, nd in names.items()}


def cache_pspecs(cache, cfg: ModelConfig, plan: MeshPlan, batch: int,
                 seq_over_tp: bool = False):
    """Specs of ``lm.init_cache``'s tree: batch over DP where it divides,
    else the cache sequence over the data axes (context parallelism for
    the batch-1 ``long_500k`` cell).  ``seq_over_tp`` also shards the
    cache sequence over the model axis (the reference's decode-v2).  The
    index (a host int here) is ``()``."""
    bshard = batch % plan.n_dp == 0

    def spec(path, leaf):
        if "index" in path or not hasattr(leaf, "shape"):
            return ()
        nd = leaf.dim()
        s = [None] * nd
        if "conv" in path or "ssm" in path:
            # [L, B, K-1, di] / [L, B, di, N]
            di_axis = 3 if "conv" in path else 2
            if bshard:
                s[1] = plan.dp
            if leaf.shape[di_axis] % plan.tp == 0:
                s[di_axis] = plan.tp_axis
            return tuple(s)
        # attention caches: [L, B, S, ...]
        if bshard:
            s[1] = plan.dp
            if seq_over_tp and leaf.shape[2] % plan.tp == 0:
                s[2] = plan.tp_axis
        elif leaf.shape[2] % plan.n_dp == 0:
            s[2] = plan.dp
        # kv-head dim over model when divisible (k_e/k/v: dim 3)
        if s[2] is None and nd >= 4 and leaf.shape[3] % plan.tp == 0:
            s[3] = plan.tp_axis
        return tuple(s)

    return _map_with_path(spec, cache)


# ---------------------------------------------------------------------------
# per-device sizes
# ---------------------------------------------------------------------------

def axis_size(entry, plan: MeshPlan) -> int:
    """How many shards a spec entry cuts its dim into."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(plan.sizes[a] for a in names)


def shard_shape(shape, spec: Spec, plan: MeshPlan) -> Tuple[int, ...]:
    """A leaf's per-device shape under ``spec`` (a dim that does not divide
    takes the ceiling, as JAX pads it)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-n // axis_size(e, plan)) for n, e in zip(shape, spec))


def per_device(tree, specs, plan: MeshPlan) -> Dict[str, int]:
    """{"elements", "bytes"} one device holds of ``tree``'s tensor leaves
    under ``specs`` (a tree of its structure down to them)."""
    elements = nbytes = 0
    for leaf, spec in zip(leaves(tree), leaves(specs)):
        if not hasattr(leaf, "shape"):
            continue
        n = math.prod(shard_shape(tuple(leaf.shape), spec, plan))
        elements += n
        nbytes += n * leaf.element_size()
    return {"elements": elements, "bytes": nbytes}


# ---------------------------------------------------------------------------
# the executor: placements on a DeviceMesh
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (without importing the module where
    nothing has: then nothing can be one)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def settled(x):
    """``x`` with any pending reduction (a ``Partial`` placement, as a
    gather from a vocabulary-sharded row leaves) carried out, so that later
    indexing sees whole values; ``x`` itself where nothing is pending."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh,
                          [Replicate() if p.is_partial() else p for p in x.placements])


def einsum(eq: str, x, w):
    """``torch.einsum(eq, x, w)`` of an activation ``x`` and a weight ``w``.

    On ``DTensor``s the contraction is planned here, per mesh dim, as GSPMD
    partitions a dot, rather than left to the propagator's choice among
    strategies of equal cost.  Where the two shard different letters over
    the same mesh dim, the weight is gathered (FSDP's all-gather over a
    data axis; its gradient reduce-scattered), except over "model" where
    the weight shards an output letter: there the activation is gathered
    (Megatron's column-parallel input), so the output keeps the weight's
    tensor-parallel sharding; a
    letter both shard is kept (sharded output) or contracted (a
    ``Partial`` sum); a letter only one side shards is cut from the other
    side's replica where both have it, else it shards the output, and the
    replicated side's gradient is then ``Partial``.  Each rank contracts
    its local pieces (``local_map``)."""
    if not is_dtensor(x):
        return torch.einsum(eq, x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    x, w = settled(x), settled(w)
    ins, out = eq.replace(" ", "").split("->")
    lx, lw = ins.split(",")
    xpl, wpl = list(x.placements), list(w.placements)
    xg, wg, opl = [None] * len(xpl), [None] * len(wpl), []
    letter = lambda p, ls: ls[p.dim] if isinstance(p, Shard) else None
    names = x.device_mesh.mesh_dim_names or ()
    for i in range(len(xpl)):
        a, b = letter(xpl[i], lx), letter(wpl[i], lw)
        if a is not None and b is not None and a != b:
            if b in out and names[i] == "model":
                xpl[i], a = Replicate(), None             # gather the activation here
            else:
                wpl[i], b = Replicate(), None             # gather the weight here
        if a is None and b is not None:
            if b not in lx:                               # w shards an output letter
                opl.append(Shard(out.index(b)))
                xg[i] = Partial()
                continue
            xpl[i], a = Shard(lx.index(b)), b             # cut x's replica to match
        elif a is not None and b is None:
            if a not in lw:                               # x shards a batch letter
                opl.append(Shard(out.index(a)))
                wg[i] = Partial()
                continue
            wpl[i] = Shard(lw.index(a))                   # cut w's replica to match
        if a is None:
            opl.append(Replicate())
        else:
            opl.append(Shard(out.index(a)) if a in out else Partial())
    xg = [g or p for g, p in zip(xg, xpl)]
    wg = [g or p for g, p in zip(wg, wpl)]
    fn = local_map(lambda xl, wl: torch.einsum(eq, xl, wl), out_placements=opl,
                   in_placements=(xpl, wpl), in_grad_placements=(xg, wg),
                   device_mesh=x.device_mesh, redistribute_inputs=True)
    return fn(x, w)


def matmul(x, w):
    """``x @ w`` of an activation ``x`` [..., d] and a weight ``w`` [d, f]
    (``einsum``'s plan on ``DTensor``s)."""
    if not is_dtensor(x):
        return x @ w
    lead = "abcdefghijklm"[:x.dim() - 1]
    return einsum(f"{lead}y,yz->{lead}z", x, w)


def local_range(x, dim: int) -> Tuple[int, int]:
    """(first global index, length) of this rank's piece of the ``DTensor``
    ``x`` along ``dim``: each mesh dim that shards it cuts the piece left by
    the dims before it into ``torch.chunk`` pieces, in mesh order (as
    ``local_shard`` cuts)."""
    from torch.distributed.tensor import Shard
    coord = x.device_mesh.get_coordinate()
    start, n = 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if p == Shard(dim):
            per = -(-n // x.device_mesh.size(i))
            lo = min(coord[i] * per, n)
            start, n = start + lo, max(0, min(per, n - lo))
    return start, n


def replicated_like(x, t):
    """``t``, a tensor made inside a forward (a mask, positions, a zero),
    as a ``DTensor`` replicated on ``x``'s mesh where ``x`` is one, so that
    the two can meet; else ``t`` itself."""
    if not is_dtensor(x):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's placement: the ``DeviceMesh`` and one placement per mesh
    dim (the counterpart of a ``NamedSharding``)."""
    mesh: Any
    placements: Tuple[Any, ...]


def placements(spec: Spec, plan: MeshPlan) -> Tuple[Any, ...]:
    """``spec``'s placements on the plan's mesh, one per mesh dim: an axis
    name on tensor dim ``d`` is ``Shard(d)`` on that mesh dim, each axis of
    a tuple too (in mesh order, as ``P(("pod", "data"))`` nests: the first
    axis splits the dim, the next splits each piece), every other mesh dim
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in plan.axes]
    index = {name: i for i, (name, _) in enumerate(plan.axes)}
    for d, entry in enumerate(tuple(spec)):
        for name in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            out[index[name]] = Shard(d)
    return tuple(out)


def _need_mesh(plan: MeshPlan):
    if plan.mesh is None:
        raise ValueError("the plan has no DeviceMesh: plan_for_mesh(device_mesh)")
    return plan.mesh


def shardings(specs, plan: MeshPlan):
    """A ``Sharding`` per spec of a spec tree (dicts and lists down to spec
    tuples)."""
    mesh = _need_mesh(plan)
    if isinstance(specs, dict):
        return {k: shardings(v, plan) for k, v in specs.items()}
    if isinstance(specs, list):
        return [shardings(v, plan) for v in specs]
    return Sharding(mesh, placements(specs, plan))


def param_shardings(params, cfg: ModelConfig, plan: MeshPlan):
    """``param_pspecs`` as ``Sharding``s (``buffers`` take it too)."""
    return shardings(param_pspecs(params, cfg, plan), plan)


def opt_shardings(opt_state, params, cfg: ModelConfig, plan: MeshPlan, moment_dtype: str):
    """``opt_pspecs`` as ``Sharding``s."""
    return shardings(opt_pspecs(opt_state, params, cfg, plan, moment_dtype), plan)


def cache_shardings(cache, cfg: ModelConfig, plan: MeshPlan, batch: int,
                    seq_over_tp: bool = False):
    """``cache_pspecs`` as ``Sharding``s; the host ``index`` stays an int."""
    specs = cache_pspecs(cache, cfg, plan, batch, seq_over_tp=seq_over_tp)
    return {k: (shardings(v, plan) if k != "index" else None) for k, v in specs.items()}


def input_shardings(batch: Dict, cfg: ModelConfig, shape: ShapeConfig, plan: MeshPlan):
    """``input_pspecs`` of ``batch``'s inputs as ``Sharding``s."""
    specs = input_pspecs(cfg, shape, plan)
    return {k: shardings(specs.get(k, ()), plan) for k in batch}


def serving_page_shardings(cfg: ModelConfig, plan: MeshPlan) -> Dict[str, Sharding]:
    """``serving_page_pspecs`` as ``Sharding``s."""
    return shardings(serving_page_pspecs(cfg, plan), plan)


def local_shard(t: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's piece of the whole tensor ``t`` under ``sharding``: each
    mesh dim that shards cuts the piece left by the dims before it into
    ``torch.chunk`` pieces (the first ones a row larger where it does not
    divide) and keeps this rank's.  A copy, owning its storage."""
    from torch.distributed.tensor import Shard
    coord = sharding.mesh.get_coordinate()
    for i, p in enumerate(sharding.placements):
        if isinstance(p, Shard):
            n = sharding.mesh.size(i)
            pieces = list(torch.chunk(t, n, dim=p.dim))
            t = (pieces[coord[i]] if coord[i] < len(pieces)
                 else t.narrow(p.dim, 0, 0))
    return t.contiguous().clone() if t.device.type != "meta" else torch.empty_like(
        t, memory_format=torch.contiguous_format)


def distribute(tree, shards, device=None, seed: int = 0, zeros: bool = False):
    """``tree``'s tensor leaves as ``DTensor``s placed by ``shards`` (a
    tree of ``Sharding``s of its structure; a leaf whose sharding is None
    stays as it is).  Each rank keeps its own piece of the whole leaf, so
    ranks that hold the same whole tensors need no communication.  With
    ``device`` a real device and a meta ``tree``, each piece is made on
    ``device`` instead (N(0, 0.02²) floats from ``seed``, or zeros with
    ``zeros``; zero ints): what one rank of a large mesh holds, without the
    whole tensors."""
    from torch.distributed.tensor import DTensor
    g = None
    if device is not None and torch.device(device).type != "meta":
        g = torch.Generator(device=device).manual_seed(seed)

    def one(t, sh):
        if sh is None or not torch.is_tensor(t):
            return t
        local = local_shard(t, sh)
        if g is not None and t.is_meta:
            local = torch.empty(local.shape, dtype=t.dtype, device=device)
            if t.is_floating_point() and not zeros:
                local.normal_(0.0, 0.02, generator=g)
            else:
                local.zero_()
        return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return map_tree(one, tree, shards)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def make_constrain(plan: MeshPlan, cfg: ModelConfig, seq_len: int, batch: int,
                   decode: bool = False, seq_over_tp: bool = False):
    """The activation hook ``constrain(name, x)`` of the model entry
    points, rule for rule the reference's: the residual stream (``embed``,
    ``residual``, ``attn_out``, ``ffn_out``, ``attn_in_sharded``) batch over
    the data axes and sequence over "model" (Megatron sequence parallelism:
    a sublayer's entry gathers it, its exit reduce-scatters), ``attn_in``
    gathered, ``logits`` vocabulary over "model", ``attn_q``/``attn_kv``/
    ``heads4`` heads over "model", ``mlp_h``/``ssm_h`` the hidden dim over
    "model", ``latent`` replicated over "model".  A ``DTensor`` is
    redistributed to that spec; anything else (a plain tensor, a name the
    rules do not know) is returned as it is."""
    from torch.distributed.tensor import DTensor
    mesh = plan.mesh
    bshard = batch % plan.n_dp == 0
    dp = plan.dp if bshard else None
    sp = (plan.tp_axis if (plan.seq_parallel and not decode
                           and seq_len % plan.tp == 0) else None)
    tp, ntp = plan.tp_axis, plan.tp
    # for batch-1 decode the cache sequence dim shards over data instead
    seq_dp = plan.dp if (not bshard and decode and seq_len % plan.n_dp == 0) else None
    if decode and seq_over_tp and bshard and seq_len % ntp == 0:
        seq_dp = tp      # cache-length tensors sequence-sharded over model

    def spec(name: str, x) -> Optional[Spec]:
        if name in ("embed", "residual", "attn_out", "ffn_out", "attn_in_sharded"):
            return (dp, sp, None)
        if name == "attn_in":
            return (dp, None, None)
        if name == "logits":
            return (dp, None, tp if x.shape[-1] % ntp == 0 else None)
        if name in ("attn_q", "heads4", "attn_kv"):          # [B,S,heads,*]
            sdim = seq_dp if x.shape[1] > 1 else None
            hp = tp if (x.shape[2] % ntp == 0 and sdim != tp) else None
            return (dp, sdim, hp, None)
        if name in ("mlp_h", "ssm_h"):                       # [B,S,f|di]
            return (dp, None, tp if x.shape[-1] % ntp == 0 else None)
        if name == "latent":                                 # [B,S,d_c]
            return (dp, seq_dp if x.shape[1] > 1 else None, None)
        return None

    def constrain(name: str, x):
        if mesh is None or not isinstance(x, DTensor):
            return x
        s = spec(name, x)
        if s is None:
            return x
        return x.redistribute(mesh, placements(s, plan))

    return constrain
