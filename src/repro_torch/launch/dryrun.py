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
* where ``tp > 1`` (every production mesh) the port has no program to
  trace until ROADMAP item 15: the record keeps the resident bytes and
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
the reference lowers bf16 (its serving weights and caches are bf16); no
collectives are counted; MoE layers take the ``ragged`` dispatch with the
even group sizes of ``models/moe.py`` on meta (the reference uses
``moe_impl="ep"``); XLA's lowering knobs (``scan_layers``,
``attn_chunk_unroll``, ``ssm_unroll``, ``scan_unroll``) have no meaning
for an eager program and are not set.  Of the reference's flags,
``--param-dtype``, ``--no-seq-parallel``, ``--decode-fsdp`` and
``--no-decode-seq-tp`` are not ported and raise: the port's weights are
f32, and activation sharding and the decode plan's switches belong to the
executor (item 15).

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
import json
import sys
import time
import weakref
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, cell_applicable, get_config, input_specs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.convert import pick_dims
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import build
from repro_torch.launch.mesh import production_mesh_axes
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
SHARDED_REASON = "no program to trace at tp > 1: the sharded step is ROADMAP item 15"


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
        out = func(*args, **kwargs)
        self.ops += 1
        seen = {t.untyped_storage()._cdata for t in tree_flatten((args, kwargs))[0]
                if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
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


def decode_fsdp(arch: str, plan: shd.MeshPlan) -> bool:
    """The reference's decode plan keeps FSDP only where the bf16 weights
    do not fit the TP shards (~8 GB a device); the 100B+ MoE stacks keep it."""
    return get_config(arch).param_count() * 2 / plan.tp > 8e9


@dataclasses.dataclass(frozen=True)
class Cell:
    """One step of a cell on one device: ``shape`` at the device's batch."""
    cfg: ModelConfig
    shape: ShapeConfig
    moment_dtype: str = "float32"
    opt_chunk: int = 0
    optimizer: bool = True

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


def run_step(cell: Cell, state: Dict):
    """Run the cell's step on ``state`` (``cell_state``'s) → its outputs."""
    cfg = cell.cfg
    p, b, batch = state["params"], state["buffers"], state["batch"]
    if cell.kind == "train" and cell.optimizer:
        return train_loop.make_train_step(cfg, cell.train_config())(
            p, b, state["opt_state"], batch)
    if cell.kind == "train":        # the loss and its gradients, no update
        p = map_tree(lambda t: t.detach().requires_grad_(True), p)
        names, leaf = zip(*items(p))
        with torch.enable_grad():
            loss, _ = lm.loss_fn(p, b, cfg, batch)
            grads = torch.autograd.grad(loss, leaf)
        return loss.detach(), dict(zip(names, grads))
    with torch.no_grad():
        if cell.kind == "prefill":
            return serve_loop.make_prefill_step(cfg)(p, b, batch, state["cache"])
        return serve_loop.make_decode_step(cfg)(p, b, batch, state["cache"])


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


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
               elitekv: bool = True, cache_ratio: float = 0.25,
               moment_dtype: Optional[str] = None, opt_chunk: int = 0, loss_chunk: int = 0,
               overrides=None, mesh_axes: Optional[Dict[str, int]] = None,
               batch: Optional[int] = None, seq_len: Optional[int] = None,
               optimizer: bool = True, top: int = 12, return_cell: bool = False):
    """The record of one cell: ``shape_name``'s step of ``arch`` on the
    production mesh (``multi_pod``), or on the mesh ``mesh_axes`` ({axis:
    size}, e.g. ``{"data": 1, "model": 1}`` for one card).  ``batch`` and
    ``seq_len`` replace the shape's global batch and length; ``optimizer``
    False makes a train step the loss and its gradients only.
    ``return_cell`` → (record, the ``Cell`` one device runs, None where none
    was traced), so that the same step can be run on a card."""
    t_start = time.perf_counter()
    shape = SHAPES[shape_name]
    shape = dataclasses.replace(shape, global_batch=batch or shape.global_batch,
                                seq_len=seq_len or shape.seq_len)
    axes = dict(mesh_axes) if mesh_axes else production_mesh_axes(multi_pod=multi_pod)
    plan = shd.plan_for_mesh(axes)
    if shape.kind == "decode" and not decode_fsdp(arch, plan):
        plan = shd.plan_for_mesh(axes, fsdp=False)
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
    cell = Cell(cfg, shape, md if train else "float32", opt_chunk, optimizer)
    state = cell_state(cell, "meta")
    res = resident(cfg, shape, plan, state, md, seq_over_tp=shape.kind == "decode")
    del state
    resident_bytes = sum(v["bytes"] for v in res.values())
    chips = plan.chips
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    record = {
        **head, "kind": shape.kind, "skipped": False, "chips": chips,
        "mesh_axes": axes, "fsdp": plan.fsdp,
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
        "collectives": {},
        "notes": ["f32 throughout (the reference lowers bf16)",
                  "XLA lowering knobs (scan_layers, attn_chunk_unroll, ssm_unroll, "
                  "scan_unroll) have no counterpart in an eager program"],
    }
    if train:
        record["moment_dtype"] = md if optimizer else None
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
    else:
        why = SHARDED_REASON if plan.tp > 1 else (
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
            largest_at_peak=None)
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
          + ("null (item 15)" if peak is None else f"{peak / 2**30:.2f} GiB")
          + f", flops/dev {res['flops_per_device']:.3e}, {res['trace_s']} s",
          file=sys.stderr)
    return res


_NOT_PORTED = {"param_dtype": "--param-dtype (the port's weights are f32)",
               "no_seq_parallel": "--no-seq-parallel (activation sharding is item 15)",
               "decode_fsdp": "--decode-fsdp (the decode plan's switches are item 15)",
               "no_decode_seq_tp": "--no-decode-seq-tp (the decode plan's switches are "
                                   "item 15)"}


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
    for flag in ("--param-dtype", "--no-seq-parallel", "--decode-fsdp", "--no-decode-seq-tp"):
        ap.add_argument(flag, nargs="?", const=True, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for key, what in _NOT_PORTED.items():
        if getattr(args, key) is not None:
            ap.error(f"{what}: not ported")
    kw = dict(elitekv=not args.no_elitekv, cache_ratio=args.cache_ratio,
              moment_dtype=args.moment_dtype or None, opt_chunk=args.opt_chunk,
              loss_chunk=args.loss_chunk)
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
