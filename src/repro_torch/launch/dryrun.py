"""Dry run: what one step of an (arch × shape × mesh) cell holds on a device
and how much it computes, without running it.

The port's counterpart of the JAX package's ``launch/dryrun.py``
(``lower_cell``, ``run_cell``, ``main``).  The reference lowers each cell's
sharded step against ``ShapeDtypeStruct``s and reads XLA's memory and cost
analyses.  Here every tensor is a shape-only meta tensor (``lm.init(...,
device="meta")``, ``configs.input_specs``), and a cell records:

* **resident bytes per device**, by kind — parameters, buffers, optimizer
  state (train), cache (prefill, decode), inputs — the sums over leaves of
  each leaf's per-device shard under the reference's placement rules
  (``distributed/sharding.py``) on the cell's mesh: the reference's
  ``argument_bytes``;
* where a device runs the port's one-device step (a plan with ``tp == 1``,
  at a per-device batch of ``global_batch / n_dp``): the step itself, run on
  meta tensors under ``LiveBytes`` (a ``TorchDispatchMode``) and
  ``FlopCounterMode``.  ``temp_bytes`` is the high-water of the bytes the
  step allocates (each new storage counted once, rounded to the CUDA
  caching allocator's 512-byte blocks, and freed when its storage is);
  the peak is the step's inputs plus that; the largest tensors live at the
  peak are kept with the op that made each.  FLOPs are ``FlopCounterMode``'s
  count over the plain operators plus the kernels' meta versions' own
  (``kernels/build.py::META_CALLS``, which also gives their bytes);
* where ``tp > 1`` (every production mesh), for the train, prefill and
  decode steps of a stack without MoE layers: the sharded step itself, traced as rank 0
  of a ``fake_group`` of the mesh's size (``launch/mesh.py``: collectives
  move no data) on meta ``DTensor``s placed by the rules, with
  ``make_constrain``'s constraints — the counterpart of the reference's
  lowering on 512 placeholder host devices.  ``LocalBytes`` sees the
  operators each rank runs on its local tensors (``DTensor``'s own
  operators pass through it): ``temp_bytes`` is the high-water of the local
  storages rank 0 allocates (a collective's output counted once, rounded
  and freed as ``LiveBytes`` does), the peak is the resident bytes plus
  that, ``flops_per_device`` counts the local shapes rank 0 computes
  (replicated work on every device; ``flops_split`` is null), and
  ``collectives`` gives each kind (the reference's names) its count, from
  ``CommDebugMode``, and its bytes per device from the result shapes, as
  the reference's ``parse_collectives`` reads them.  A decode cell takes
  the reference's decode plan: FSDP only where the bf16 weights do not
  fit the TP shards (``decode_fsdp_default``; ``--decode-fsdp`` keeps
  it), and the cache sequence over "model" (``decode_seq_tp``, the cache
  and the hook placed with ``seq_over_tp``; ``--no-decode-seq-tp`` keeps
  it whole there), where ``elite_decode`` merges the sequence's pieces
  by their log-sum-exp;
* where ``tp > 1`` otherwise — MoE stacks (expert parallelism,
  ``moe_impl="ep"``, ROADMAP item 15d) and the baseline's decode without
  EliteKV (``flash_prefill``'s decode body has no log-sum-exp to merge
  yet, item 15c.3) — the record keeps the resident bytes and
  ``flops_per_device`` as the whole step's FLOPs split evenly over the
  chips (counted on meta at the per-replica batch ``global_batch / n_dp``
  and multiplied by ``n_dp``: every counted FLOP is per sample); ``temp_bytes`` and the peak
  are ``null`` with the reason, and ``collectives`` is ``{}``.

Steps: train = ``train_loop.make_train_step`` (forward, backward, AdamW),
or with ``optimizer=False`` the loss and its gradients only; prefill =
``serve_loop.make_prefill_step`` into a fresh cache; decode =
``serve_loop.make_decode_step`` against a cache whose index is
``seq_len - 1``, so the kernel plans cover the whole walk.  Prefill and
decode run under ``torch.no_grad()``, as serving does.

Differences from the reference, by design: the port computes in f32 where
the reference lowers bf16 (its serving weights and caches are bf16);
collectives are ``DTensor``'s, counted by ``CommDebugMode`` and not read
from partitioned HLO, so they come in other numbers than XLA's; MoE layers
take the ``ragged`` dispatch with the even group sizes of ``models/moe.py``
on meta (the reference uses ``moe_impl="ep"``); XLA's lowering knobs
(``scan_layers``, ``attn_chunk_unroll``, ``ssm_unroll``, ``scan_unroll``)
have no meaning for an eager program and are not set.  Of the reference's
flags, ``--no-seq-parallel``, ``--decode-fsdp`` and ``--no-decode-seq-tp``
are ported; ``--param-dtype`` raises (the port's weights are f32).

Records land in ``build/dryrun/<mesh>/<arch>__<shape>[__variant].json``:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama_1_1b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_moe_235b \
      --shape train_4k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all     # every cell, both meshes
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import sys
import time
import weakref
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, cell_applicable, get_config, input_specs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.convert import pick_dims
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import build
from repro_torch.launch.mesh import fake_group, make_debug_mesh, production_mesh_axes
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import serve_loop, train_loop
from repro_torch.tree import items, leaves, map_tree

#: the CUDA caching allocator's block size: every allocation takes a
#: multiple of it (``torch.cuda.max_memory_allocated`` counts blocks)
BLOCK = 512
#: device memory of the target card, the H100 SXM5 80 GB (NVIDIA H100 Tensor
#: Core GPU Architecture whitepaper)
TARGET_MEMORY = 80 * 10**9
BASELINE_DECODE_REASON = ("the baseline's decode at tp > 1 (no EliteKV) needs "
                          "flash_prefill's decode body to return its log-sum-exp, merged "
                          "across the cache's shards: ROADMAP item 15c.3")
MOE_REASON = ('MoE layers at tp > 1 take expert parallelism (moe_impl="ep"): ROADMAP '
              'item 15d')
#: the reference's collective kinds, by the port's collective operators' names
COLLECTIVE_KINDS = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
                    ("all_reduce", "all-reduce"), ("alltoall", "all-to-all"),
                    ("all_to_all", "all-to-all"), ("broadcast", "collective-permute"))


aten = torch.ops.aten
#: autograd formulas that write into a fresh zeros tensor in place, but take
#: the out-of-place form whenever a dispatch mode is on (PyTorch's
#: ``isTensorSubclassLike``): ``gather``'s backward (``scatter_add``) and
#: ``sort``'s or ``max``'s (``scatter``); inside a backward ``LiveBytes``
#: runs the in-place form, as the card does, so the copy is not counted
_IN_PLACE = {aten.scatter_add.default: aten.scatter_add_.default,
             aten.scatter.src: aten.scatter_.src}


def _as_in_place(func, args, kwargs):
    """The in-place form of such a formula op inside a backward (and of
    ``index_put`` with ``accumulate``, as ``index``'s backward calls it),
    else None."""
    if torch._C._current_autograd_node() is None:
        return None
    if func is aten.index_put.default:
        acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
        return aten.index_put_.default if acc else None
    return _IN_PLACE.get(func)


def _tensors(x):
    """The tensors of an operator's arguments or outputs (tuples, lists and
    dicts of them)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def block_bytes(nbytes: int) -> int:
    """Bytes the caching allocator takes for ``nbytes``."""
    return 0 if nbytes == 0 else -(-nbytes // BLOCK) * BLOCK


class LiveBytes(TorchDispatchMode):
    """Live bytes of the tensors a traced program allocates.

    Every output storage of an operator that is none of its inputs'
    storages is new: its bytes (``block_bytes``) count from then until the
    storage is freed (``weakref.finalize``).  Views and in-place results
    count nothing, and tensors made before the mode was entered count
    nothing.  A mode being on turns some backward formulas out of place
    (``_IN_PLACE``); the tracker runs them in place, as they run without
    it.  ``peak`` is the high-water of ``live``; ``at_peak(n)`` the
    ``n`` largest storages live at that moment, each with the operator that
    made it."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.ops = 0
        self.peak_op, self.peak_name = 0, ""
        self.records = []          # [bytes, op, shape, dtype, born, died]
        self._known: Dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        func = _as_in_place(func, args, kwargs) or func
        return self._count(func, func(*args, **kwargs), args, kwargs)

    def _count(self, func, out, args, kwargs):
        self.ops += 1
        seen = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._known:
                continue
            seen.add(key)
            nb = block_bytes(st.nbytes())
            self._known[key] = len(self.records)
            self.records.append([nb, str(func), tuple(t.shape), str(t.dtype).replace(
                "torch.", ""), self.ops, None])
            weakref.finalize(st, self._free, key)
            self.live += nb
            if self.live > self.peak:
                self.peak, self.peak_op, self.peak_name = self.live, self.ops, str(func)
        return out

    def _free(self, key: int) -> None:
        rec = self.records[self._known.pop(key)]
        rec[5] = self.ops + 0.5            # gone before the next operator
        self.live -= rec[0]

    def at_peak(self, n: int):
        live = [r for r in self.records
                if r[4] <= self.peak_op and (r[5] is None or r[5] > self.peak_op)]
        live.sort(key=lambda r: -r[0])
        return [{"bytes": r[0], "op": r[1], "shape": list(r[2]), "dtype": r[3]}
                for r in live[:n]]


@functools.lru_cache(maxsize=None)
def collective_kind(op) -> Optional[str]:
    """The reference's kind name of a collective operator (or packet),
    None for any other operator (``wait_tensor`` included)."""
    name = str(op)
    if "wait" in name:
        return None
    for key, kind in COLLECTIVE_KINDS:
        if key in name:
            return kind
    return None


def comm_counts(cdm) -> Dict[str, int]:
    """``CommDebugMode``'s counts by kind."""
    out: Dict[str, int] = {}
    for op, n in cdm.get_comm_counts().items():
        kind = collective_kind(op)
        if kind is not None:
            out[kind] = out.get(kind, 0) + n
    return out


@functools.lru_cache(maxsize=None)
def _alias(func) -> bool:
    """The collectives' autograd wrapper of an output: an alias on the card,
    a copy in its meta version."""
    return "_wrap_tensor_autograd" in str(func)


#: operators whose CUDA version holds, for the length of the call, one more
#: buffer of the size of the input at this position than its meta version
#: allocates: the softmax backward, a gradient-sized one (found on the
#: H100 by comparing the caching allocator's peak within each operator of
#: the sharded train step with the traced bytes)
_TRANSIENTS = {aten._softmax_backward_data.default: 0}


def _in_propagation() -> bool:
    """Whether this operator runs inside ``DTensor``'s sharding propagation,
    which infers shapes on fake or meta tensors and allocates no device
    memory."""
    f = sys._getframe(2)
    for _ in range(40):          # the propagator calls its operators a few frames up
        if f is None:
            return False
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


_PROPAGATION = os.path.join("distributed", "tensor", "_sharding_prop.py")


class LocalBytes(LiveBytes):
    """``LiveBytes`` of what one rank runs under ``DTensor``s: the mode
    passes every ``DTensor`` operator through (it returns
    ``NotImplemented`` for them, so ``DTensor`` runs and its local
    operators, collectives included, come back through the mode), and
    counts the local storages as ``LiveBytes`` counts storages, the local
    FLOPs (``FlopCounterMode``'s formulas on local shapes) and each
    collective's result bytes by kind.  The operators of ``DTensor``'s
    sharding propagation (shape inference on fake or meta tensors) allocate
    nothing on a device and count nothing; an operator whose CUDA version
    holds a transient buffer (``_TRANSIENTS``) counts it at its peak.
    Autograd runs at the ``DTensor`` level, where formulas take their
    out-of-place forms whether or not a mode is on, so nothing is turned
    back in place."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.collectives: Dict[str, Dict[str, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _tensors(out)) \
                or _alias(func) or _in_propagation():
            # the propagator's shape inference, and the collectives' autograd
            # wrapper of an output (its meta version copies): no device memory
            return out
        out = self._count(func, out, args, kwargs)
        if func in _TRANSIENTS:
            extra = block_bytes(args[_TRANSIENTS[func]].nbytes)
            if self.live + extra > self.peak:
                self.peak, self.peak_op = self.live + extra, self.ops
                self.peak_name = f"{func} (with its transient buffer)"
        packet = getattr(func, "_overloadpacket", None)
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs, out_val=out))
        kind = collective_kind(func)
        if kind is not None:
            rec = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
            rec["count"] += 1
            rec["bytes"] += sum(t.numel() * t.element_size() for t in _tensors(out))
        return out


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def build_cfg(arch: str, shape: ShapeConfig, plan: shd.MeshPlan, elitekv: bool = True,
              cache_ratio: float = 0.25, overrides=None) -> ModelConfig:
    """The cell's model: heads padded for the plan's TP, f32 (the port's
    kernels take f32), the Mamba scan in chunks of 128, EliteKV at
    ``pick_dims(cfg, cache_ratio, align=128)`` where the stack has
    attention layers."""
    cfg = shd.pad_cfg_for_tp(get_config(arch), plan.tp)
    cfg = dataclasses.replace(cfg, dtype=torch.float32, ssm_chunk=128)
    if elitekv and cfg.n_attn_layers > 0:
        cfg = dataclasses.replace(cfg, elitekv=pick_dims(cfg, cache_ratio, align=128))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def decode_fsdp_default(arch: str, plan: shd.MeshPlan) -> bool:
    """The reference's decode plan keeps FSDP only where the bf16 weights
    do not fit the TP shards (~8 GB a device); the 100B+ MoE stacks keep it."""
    return get_config(arch).param_count() * 2 / plan.tp > 8e9


@dataclasses.dataclass(frozen=True)
class Cell:
    """One step of a cell on one device: ``shape`` at the device's batch.
    ``seq_over_tp``: the decode plan shards the cache sequence over "model"
    (placement and constraints of a sharded decode step)."""
    cfg: ModelConfig
    shape: ShapeConfig
    moment_dtype: str = "float32"
    opt_chunk: int = 0
    optimizer: bool = True
    seq_over_tp: bool = False

    @property
    def kind(self) -> str:
        return self.shape.kind

    def train_config(self) -> train_loop.TrainConfig:
        return train_loop.TrainConfig(optimizer=AdamWConfig(moment_dtype=self.moment_dtype,
                                                            update_chunk=self.opt_chunk))


def _random_batch(specs: Dict[str, torch.Tensor], cfg: ModelConfig, device, seed: int):
    """Values of ``specs``' shapes on ``device``: ids below the vocab,
    embeddings N(0, 0.02²)."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, t in specs.items():
        if t.dtype == torch.int64:
            out[name] = torch.randint(0, cfg.vocab_size, tuple(t.shape), generator=g,
                                      device=device)
        else:
            out[name] = torch.randn(tuple(t.shape), generator=g, device=device) * 0.02
    return out


def cell_state(cell: Cell, device="meta", seed: int = 0) -> Dict:
    """The step's arguments on ``device``: {"params", "buffers", "batch"} and
    "opt_state" (train with the optimizer) or "cache" (prefill, decode,
    the decode cache's index at ``seq_len - 1``).  Shape-only on meta;
    elsewhere seeded random weights and inputs and a zeroed cache."""
    device = torch.device(device)
    cfg, shape = cell.cfg, cell.shape
    params, buffers = lm.init(cfg, seed=seed, device=device)
    specs = input_specs(cfg, shape)
    batch = specs if device.type == "meta" else _random_batch(specs, cfg, device, seed + 1)
    state = {"params": params, "buffers": buffers, "batch": batch}
    if cell.kind == "train":
        if cell.optimizer:
            state["opt_state"] = train_loop.init_opt_state(params, cell.train_config())
    else:
        state["cache"] = lm.init_cache(cfg, shape.global_batch, shape.seq_len, device=device)
        if cell.kind == "decode":
            state["cache"]["index"] = shape.seq_len - 1
    return state


def run_step(cell: Cell, state: Dict, constrain=None):
    """Run the cell's step on ``state`` (``cell_state``'s, or placed by
    ``place_state`` with ``constrain`` the plan's hook) → its outputs."""
    cfg = cell.cfg
    p, b, batch = state["params"], state["buffers"], state["batch"]
    if cell.kind == "train" and cell.optimizer:
        return train_loop.make_train_step(cfg, cell.train_config(), constrain=constrain)(
            p, b, state["opt_state"], batch)
    if cell.kind == "train":        # the loss and its gradients, no update
        p = map_tree(lambda t: t.detach().requires_grad_(True), p)
        names, leaf = zip(*items(p))
        with torch.enable_grad():
            loss, _ = lm.loss_fn(p, b, cfg, batch, constrain=constrain)
            grads = torch.autograd.grad(loss, leaf)
        return loss.detach(), dict(zip(names, grads))
    with torch.no_grad():
        if cell.kind == "prefill":
            return serve_loop.make_prefill_step(cfg, constrain=constrain)(
                p, b, batch, state["cache"])
        return serve_loop.make_decode_step(cfg, constrain=constrain)(
            p, b, batch, state["cache"])


def sharded_plan(plan: shd.MeshPlan, device_type: str = "cuda") -> shd.MeshPlan:
    """``plan`` with its ``DeviceMesh`` over the default process group (of
    ``plan.chips`` ranks)."""
    names, sizes = zip(*plan.axes)
    return dataclasses.replace(plan, mesh=make_debug_mesh(sizes, names, device_type))


def place_state(cell: Cell, plan: shd.MeshPlan, state: Dict, device=None,
                seed: int = 0) -> Dict:
    """``state`` (``cell_state``'s, at the global batch) as ``DTensor``s
    placed by the rules on the plan's mesh: this rank's pieces of the
    whole tensors, or with ``device`` and a meta ``state`` made there
    (``sharding.distribute``: weights and inputs drawn, optimizer state
    and cache zero)."""
    cfg, shape = cell.cfg, cell.shape
    sh = {"params": shd.param_shardings(state["params"], cfg, plan),
          "buffers": shd.param_shardings(state["buffers"], cfg, plan),
          "batch": shd.input_shardings(state["batch"], cfg, shape, plan)}
    if "opt_state" in state:
        sh["opt_state"] = shd.opt_shardings(state["opt_state"], state["params"], cfg, plan,
                                            cell.moment_dtype)
    if "cache" in state:
        sh["cache"] = shd.cache_shardings(state["cache"], cfg, plan, shape.global_batch,
                                          seq_over_tp=cell.seq_over_tp)
    return {k: shd.distribute(v, sh[k], device=device, seed=seed + i,
                              zeros=k in ("opt_state", "cache"))
            for i, (k, v) in enumerate(state.items())}


def local_bytes(tree) -> int:
    """Bytes this rank holds of a tree of ``DTensor``s (and tensors)."""
    return sum(getattr(t, "_local_tensor", t).nbytes for t in leaves(tree)
               if torch.is_tensor(t))


def sharding_constrain(cell: Cell, plan: shd.MeshPlan):
    """The cell's activation hook (the decode plan's for a decode cell)."""
    return shd.make_constrain(plan, cell.cfg, cell.shape.seq_len, cell.shape.global_batch,
                              decode=cell.kind == "decode", seq_over_tp=cell.seq_over_tp)


def trace_sharded(cell: Cell, plan: shd.MeshPlan, top: int = 12,
                  device_type: str = "cuda") -> Dict:
    """The cell's sharded step (at the global batch) traced as rank 0 of a
    ``fake_group`` of ``plan.chips`` ranks on a mesh typed ``device_type``
    ("cuda": ``DTensor`` takes the card's routes, where a "cpu" mesh swaps
    each all-to-all for an all-gather, as gloo has none) over meta
    ``DTensor``s, under ``LocalBytes`` and ``CommDebugMode``.
    → ``trace_step``'s keys, per device, "collectives" and "local_counts"
    (``LocalBytes``' own count of each kind)."""
    from torch.distributed.tensor.debug import CommDebugMode
    meta = torch.device("meta")
    with fake_group(plan.chips, device_type):
        plan = sharded_plan(plan, device_type)
        placed = place_state(cell, plan, cell_state(cell, meta))
        out = {"input_bytes": local_bytes(placed)}
        constrain = sharding_constrain(cell, plan)
        build.free_scratch(meta)
        build.reset_meta_calls()
        live = LocalBytes()
        with CommDebugMode() as cdm, live:
            result = run_step(cell, placed, constrain)
        counts = comm_counts(cdm)
        del result, placed
    kernels = {k: dict(v) for k, v in build.META_CALLS.items()}
    build.free_scratch(meta)
    out.update(flops=live.flops + sum(v["flops"] for v in kernels.values()),
               operator_flops=live.flops, kernels=kernels, temp_bytes=live.peak,
               end_bytes=live.live, peak_op=live.peak_name, largest=live.at_peak(top),
               collectives={kind: {"count": counts.get(kind, 0),
                                   "bytes": live.collectives.get(kind, {}).get("bytes", 0)}
                            for kind in sorted(set(counts) | set(live.collectives))},
               local_counts={k: v["count"] for k, v in live.collectives.items()})
    return out


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree) if torch.is_tensor(t))


def resident(cfg: ModelConfig, shape: ShapeConfig, plan: shd.MeshPlan, state: Dict,
             moment_dtype: str, seq_over_tp: bool) -> Dict[str, Dict[str, int]]:
    """Per-device {"elements", "bytes"} by kind under the plan's specs
    (``state`` at the global batch)."""
    out = {"params": shd.per_device(state["params"],
                                    shd.param_pspecs(state["params"], cfg, plan), plan),
           "buffers": shd.per_device(state["buffers"],
                                     map_tree(lambda t: (None,) * t.dim(), state["buffers"]),
                                     plan)}
    if "opt_state" in state:
        specs = shd.opt_pspecs(state["opt_state"], state["params"], cfg, plan, moment_dtype)
        out["opt_state"] = shd.per_device(state["opt_state"], specs, plan)
    if "cache" in state:
        specs = shd.cache_pspecs(state["cache"], cfg, plan, shape.global_batch,
                                 seq_over_tp=seq_over_tp)
        out["cache"] = shd.per_device(state["cache"], specs, plan)
    ispecs = shd.input_pspecs(cfg, shape, plan)
    out["inputs"] = shd.per_device(state["batch"],
                                   {k: ispecs[k] for k in state["batch"]}, plan)
    return out


def trace_step(cell: Cell, top: int = 12, memory: bool = True) -> Dict:
    """Run the cell's step on meta tensors under ``FlopCounterMode`` (and
    ``LiveBytes`` where ``memory``).  → {"flops", "kernels", "input_bytes",
    and with ``memory``: "temp_bytes", "end_bytes", "peak_op", "largest"}."""
    meta = torch.device("meta")
    state = cell_state(cell, meta)
    out = {"input_bytes": tree_bytes(state)}
    build.free_scratch(meta)
    build.reset_meta_calls()
    live = LiveBytes() if memory else contextlib.nullcontext()
    with FlopCounterMode(display=False) as fc, live:
        result = run_step(cell, state)
    kernels = {k: dict(v) for k, v in build.META_CALLS.items()}
    out["flops"] = fc.get_total_flops() + sum(v["flops"] for v in kernels.values())
    out["operator_flops"] = fc.get_total_flops()
    out["kernels"] = kernels
    if memory:
        out.update(temp_bytes=live.peak, end_bytes=live.live,
                   peak_op=live.peak_name, largest=live.at_peak(top))
    del result, state
    build.free_scratch(meta)
    return out


def _flops(cell: Cell) -> Dict:
    """The step's FLOPs and kernel calls at full depth, from traces (without
    memory) of no layers and of one layer period, as the reference takes
    them from one and two layer-scan bodies: total = f(0) + n_super·(f(1) -
    f(0))."""
    cfg = cell.cfg
    P, n_super = cfg.block_period, cfg.num_layers // cfg.block_period
    none, one = (trace_step(dataclasses.replace(cell, cfg=dataclasses.replace(
        cfg, num_layers=n * P)), memory=False) for n in (0, 1))
    ext = lambda a, b: a + n_super * (b - a)
    zero = {"calls": 0, "bytes": 0, "flops": 0}
    return {"flops": ext(none["flops"], one["flops"]),
            "operator_flops": ext(none["operator_flops"], one["operator_flops"]),
            "kernels": {k: {n: ext(none["kernels"].get(k, zero)[n], one["kernels"][k][n])
                            for n in zero} for k in one["kernels"]}}


def _extrapolated(three: Dict, four: Dict, n_super: int) -> Dict:
    """A sharded trace at ``n_super`` layer periods from traces of three
    and four: every count, byte and FLOP total is affine in the depth from
    three periods on (``tests/test_torch_dryrun.py`` holds this to
    full-depth traces; at two, a shallow step's peak may still sit in the
    embedding's backward rather than the optimizer's), ``f(n) = f(3) + (n -
    3)·(f(4) - f(3))``; the peak's operator and largest tensors are the
    four-period trace's."""
    ext = lambda a, b: a + (n_super - 3) * (b - a)

    def deep(a, b):
        if isinstance(b, dict):
            return {k: deep(a.get(k, 0 if not isinstance(v, dict) else {}), v)
                    for k, v in b.items()}
        return ext(a, b)

    out = dict(four)
    for key in ("flops", "operator_flops", "temp_bytes", "end_bytes", "input_bytes",
                "kernels", "collectives", "local_counts"):
        out[key] = deep(three[key], four[key])
    return out


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
               elitekv: bool = True, cache_ratio: float = 0.25,
               moment_dtype: Optional[str] = None, opt_chunk: int = 0, loss_chunk: int = 0,
               overrides=None, mesh_axes: Optional[Dict[str, int]] = None,
               batch: Optional[int] = None, seq_len: Optional[int] = None,
               optimizer: bool = True, top: int = 12, return_cell: bool = False,
               seq_parallel: bool = True, depth: Optional[str] = None,
               decode_fsdp: Optional[bool] = None, decode_seq_tp: bool = True):
    """The record of one cell: ``shape_name``'s step of ``arch`` on the
    production mesh (``multi_pod``), or on the mesh ``mesh_axes`` ({axis:
    size}, e.g. ``{"data": 1, "model": 1}`` for one card).  ``batch`` and
    ``seq_len`` replace the shape's global batch and length; ``optimizer``
    False makes a train step the loss and its gradients only.
    ``return_cell`` → (record, the ``Cell`` one device runs, or at tp > 1
    the ``Cell`` the sharded step runs at the global batch; None where none
    was traced), so that the same step can be run on a card.
    ``seq_parallel`` False keeps the residual stream whole over "model"
    (the reference's ``--no-seq-parallel``).  ``decode_fsdp`` (a decode
    cell): keep FSDP's weight gathers, None as ``decode_fsdp_default``
    says (the reference's ``--decode-fsdp`` sets it); ``decode_seq_tp``
    False keeps the decode cache's sequence whole over "model", its kv
    heads sharded there where they divide (``--no-decode-seq-tp``).
    ``depth`` (the sharded
    trace): "full" traces every layer; "periods" traces three and four
    layer periods and extrapolates (``_extrapolated``); None takes "periods" for
    a stack with Mamba layers, whose chunked scan makes a full-depth trace
    take minutes, else "full"."""
    t_start = time.perf_counter()
    shape = SHAPES[shape_name]
    shape = dataclasses.replace(shape, global_batch=batch or shape.global_batch,
                                seq_len=seq_len or shape.seq_len)
    axes = dict(mesh_axes) if mesh_axes else production_mesh_axes(multi_pod=multi_pod)
    plan = shd.plan_for_mesh(axes, seq_parallel=seq_parallel)
    decode = shape.kind == "decode"
    if decode and decode_fsdp is None:
        decode_fsdp = decode_fsdp_default(arch, plan)
    if decode and not decode_fsdp:
        plan = shd.plan_for_mesh(axes, fsdp=False, seq_parallel=seq_parallel)
    seq_over_tp = decode and decode_seq_tp
    cfg = build_cfg(arch, shape, plan, elitekv=elitekv, cache_ratio=cache_ratio,
                    overrides=overrides)
    if loss_chunk:
        cfg = dataclasses.replace(cfg, loss_chunk=loss_chunk)
    head = {"arch": arch, "shape": shape_name, "mesh": plan.tag}
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        rec = {**head, "skipped": True, "reason": reason}
        return (rec, None) if return_cell else rec
    md = moment_dtype or ("int8" if cfg.param_count() > 5e10 else "float32")
    train = shape.kind == "train"
    cell = Cell(cfg, shape, md if train else "float32", opt_chunk, optimizer, seq_over_tp)
    state = cell_state(cell, "meta")
    res = resident(cfg, shape, plan, state, md, seq_over_tp=seq_over_tp)
    del state
    resident_bytes = sum(v["bytes"] for v in res.values())
    chips = plan.chips
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    record = {
        **head, "kind": shape.kind, "skipped": False, "chips": chips,
        "mesh_axes": axes, "fsdp": plan.fsdp, "seq_parallel": plan.seq_parallel,
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "step": ("train step (forward, backward, AdamW)" if train and optimizer else
                 "loss and gradients" if train else f"{shape.kind} step"),
        "elitekv": dataclasses.asdict(cfg.elitekv),
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "tokens_per_step": tokens,
        "cache_floats_per_token": (cfg.elitekv.cache_per_token_per_layer(
            cfg.n_kv_heads, cfg.head_dim) * cfg.n_attn_layers),
        "dtype": "float32",
        "moe_impl": "ragged (even groups on meta)" if cfg.n_experts else None,
        "resident": res,
        "collectives": {}, "collective_bytes_per_device": 0,
        "notes": ["f32 throughout (the reference lowers bf16)",
                  "XLA lowering knobs (scan_layers, attn_chunk_unroll, ssm_unroll, "
                  "scan_unroll) have no counterpart in an eager program"],
    }
    if train:
        record["moment_dtype"] = md if optimizer else None
    if decode:
        record["decode_seq_tp"] = seq_over_tp
    baseline_decode = decode and cfg.n_attn_layers > 0 and not cfg.elitekv.enabled
    traced = None
    if plan.tp == 1 and shape.global_batch % plan.n_dp == 0:
        local = dataclasses.replace(shape, global_batch=shape.global_batch // plan.n_dp)
        traced = dataclasses.replace(cell, shape=local)
        tr = trace_step(traced, top=top)
        peak = tr["input_bytes"] + tr["temp_bytes"]
        record.update(
            flops_per_device=float(tr["flops"]), flops_split=None,
            operator_flops_per_device=float(tr["operator_flops"]), kernels=tr["kernels"],
            memory={"argument_bytes": resident_bytes, "temp_bytes": tr["temp_bytes"],
                    "output_bytes": tr["end_bytes"], "step_input_bytes": tr["input_bytes"],
                    "peak_estimate_bytes": peak, "peak_op": tr["peak_op"],
                    "fits_target": peak <= TARGET_MEMORY},
            largest_at_peak=tr["largest"])
        if plan.n_dp > 1:
            record["notes"].append("the traced step is the one-device step at the "
                                   "per-device batch, holding whole parameters and "
                                   "optimizer state (no FSDP without item 15)")
    elif plan.tp > 1 and not cfg.n_experts and not baseline_decode:
        traced = cell
        P, n_super = cfg.block_period, cfg.num_layers // cfg.block_period
        depth = depth or ("periods" if cfg.n_attn_layers < cfg.num_layers else "full")
        if depth == "periods" and n_super > 4:
            at = lambda n: dataclasses.replace(cell, cfg=dataclasses.replace(
                cfg, num_layers=n * P))
            tr = _extrapolated(*(trace_sharded(at(n), plan, top=top) for n in (3, 4)), n_super)
            record["notes"].append(f"the sharded trace is extrapolated to {n_super} layer "
                                   f"periods from traces of 3 and 4")
        else:
            tr = trace_sharded(cell, plan, top=top)
        temp = tr["temp_bytes"]
        record.update(
            flops_per_device=float(tr["flops"]), flops_split=None,
            operator_flops_per_device=float(tr["operator_flops"]), kernels=tr["kernels"],
            memory={"argument_bytes": resident_bytes, "temp_bytes": temp,
                    "output_bytes": tr["end_bytes"], "step_input_bytes": tr["input_bytes"],
                    "peak_estimate_bytes": resident_bytes + temp, "peak_op": tr["peak_op"],
                    "fits_target": resident_bytes + temp <= TARGET_MEMORY},
            largest_at_peak=tr["largest"], collectives=tr["collectives"],
            collective_bytes_per_device=sum(v["bytes"] for v in tr["collectives"].values()))
        record["notes"].append(
            f"the sharded step traced as rank 0 of a fake group of {chips} ranks (no data "
            "moves): per-device local bytes, FLOPs and collectives")
    else:
        why = (MOE_REASON if plan.tp > 1 and cfg.n_experts else
               BASELINE_DECODE_REASON if plan.tp > 1 else
               "the batch does not divide the data axes: context parallelism is item 15")
        # FLOPs are linear in the batch: the whole step is n_dp replicas' steps
        reps = plan.n_dp if shape.global_batch % plan.n_dp == 0 else 1
        tr = _flops(dataclasses.replace(cell, shape=dataclasses.replace(
            shape, global_batch=shape.global_batch // reps)))
        whole = float(tr["flops"]) * reps
        record.update(
            flops_per_device=whole / chips,
            flops_split=(f"even: the whole step's {whole:.6e} FLOPs ({reps} x the step at "
                         f"the per-replica batch) / {chips} chips"),
            operator_flops_per_device=float(tr["operator_flops"]) * reps / chips,
            kernels={k: {n: v * reps for n, v in rec.items()}
                     for k, rec in tr["kernels"].items()},
            memory={"argument_bytes": resident_bytes, "temp_bytes": None,
                    "output_bytes": None, "peak_estimate_bytes": None, "reason": why,
                    "fits_target": resident_bytes <= TARGET_MEMORY},
            largest_at_peak=None, collectives={}, collective_bytes_per_device=None)
    record["trace_s"] = round(time.perf_counter() - t_start, 2)
    return (record, traced) if return_cell else record


def run_cell(arch: str, shape: str, multi_pod: bool, out: str, variant: str = "",
             **kw) -> Dict:
    res = lower_cell(arch, shape, multi_pod, **kw)
    out_dir = Path(out) / res["mesh"]
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{arch}__{shape}" + (f"__{variant}" if variant else "")
    (out_dir / f"{tag}.json").write_text(json.dumps(res, indent=1))
    if res.get("skipped"):
        print(f"[dryrun] {tag} mesh={res['mesh']}: skipped ({res['reason']})",
              file=sys.stderr)
        return res
    mem = res["memory"]
    peak = mem["peak_estimate_bytes"]
    print(f"[dryrun] {tag} mesh={res['mesh']}: resident/device "
          f"{mem['argument_bytes'] / 2**30:.2f} GiB, peak/device "
          + (f"null ({mem['reason'].split(': ')[-1]})" if peak is None
             else f"{peak / 2**30:.2f} GiB")
          + f", flops/dev {res['flops_per_device']:.3e}, {res['trace_s']} s",
          file=sys.stderr)
    return res


_NOT_PORTED = {"param_dtype": "--param-dtype (the port's weights are f32)"}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-elitekv", action="store_true")
    ap.add_argument("--cache-ratio", type=float, default=0.25)
    ap.add_argument("--moment-dtype", default="")
    ap.add_argument("--variant", default="")
    ap.add_argument("--opt-chunk", type=int, default=0)
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--no-seq-parallel", action="store_true",
                    help="keep the residual stream whole over the model axis")
    ap.add_argument("--decode-fsdp", action="store_true",
                    help="keep FSDP's weight gathers at decode (the default drops them "
                         "where the bf16 weights fit the TP shards)")
    ap.add_argument("--no-decode-seq-tp", action="store_true",
                    help="keep the decode cache's sequence whole over the model axis")
    ap.add_argument("--param-dtype", nargs="?", const=True, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for key, what in _NOT_PORTED.items():
        if getattr(args, key) is not None:
            ap.error(f"{what}: not ported")
    kw = dict(elitekv=not args.no_elitekv, cache_ratio=args.cache_ratio,
              moment_dtype=args.moment_dtype or None, opt_chunk=args.opt_chunk,
              loss_chunk=args.loss_chunk, seq_parallel=not args.no_seq_parallel,
              decode_fsdp=args.decode_fsdp or None, decode_seq_tp=not args.no_decode_seq_tp)
    if args.all:
        archs = [a for a in ARCH_IDS if not a.startswith("llama2_13b")]
        for mp in (False, True):
            for arch in archs:
                for shape in SHAPES:
                    run_cell(arch, shape, mp, args.out, args.variant, **kw)
        return 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    res = run_cell(args.arch, args.shape, args.multi_pod, args.out, args.variant, **kw)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
