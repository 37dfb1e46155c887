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
stack in both.  ``shard_shape`` gives a leaf's per-device shape.

Here the rules only size what a device holds (``launch/dryrun.py``).  The
executor that places tensors by them — ``make_constrain``,
``param_shardings``, ``serving_page_shardings`` — is ROADMAP item 15.

Head padding: archs whose head count does not divide the TP size (Arctic
56, MiniCPM 36 at TP 16) are padded with extra heads (56 → 64, 36 → 48) by
``pad_cfg_for_tp``, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple

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


def plan_for_mesh(axes: Mapping[str, int], fsdp: bool = True,
                  seq_parallel: bool = True) -> MeshPlan:
    """The plan of a mesh given as ``{axis name: size}`` in mesh order:
    every axis but "model" is a data axis."""
    dp_axes = tuple(a for a in axes if a != "model")
    return MeshPlan(axes=tuple(axes.items()), dp_axes=dp_axes, fsdp=fsdp,
                    seq_parallel=seq_parallel)


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
