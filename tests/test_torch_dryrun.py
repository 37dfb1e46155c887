"""The port's dry run (``launch/dryrun.py``), its placement rules
(``distributed/sharding.py``) and shape cells, and the kernels' meta
versions, held to the JAX package on the CPU.

* Placement rules: for every arch at full width (shape-only trees on both
  sides: the reference's ``jax.eval_shape(lm.init)``, the port's
  ``lm.init(device="meta")``) on meshes 16 × 16, 2 × 16 × 16, 1 × 8 and
  4 × 2 (the reference's rules on a ``jax.sharding.AbstractMesh``), the
  port's ``param_pspecs``, ``opt_pspecs`` (f32 and int8),
  ``input_pspecs``, ``cache_pspecs`` (with and without ``seq_over_tp``)
  and ``serving_page_pspecs`` equal the reference's: a reference leaf of
  ``blocks/p{pos}`` stacks layer ``s·P + pos`` of the port at its entry
  ``s`` (matched through ``repro_torch.interop``), so its spec is the
  port's with the stack axis in front.  ``pad_cfg_for_tp`` pads alike.
* Resident elements: per device and kind (parameters, buffers, optimizer
  state, cache, inputs) under the port's specs, equal to the reference's
  shard shapes (``NamedSharding.shard_shape``) for every arch × mesh ×
  shape.  The reference's cache index is a device scalar and the port's a
  host int, so caches compare without it.
* Inputs: ``input_specs`` shapes equal the reference's (ids int64 here).
* The trace: each reduced arch's train, prefill and decode steps run on
  meta.  FLOPs: the meta run's operator count equals ``FlopCounterMode``'s
  count of the same step on CPU tensors less what it counted inside the
  kernel entries (their plain versions), and the kernels' meta counts
  equal their cost formulas on the CPU call's own inputs.  Memory: the
  ``LiveBytes`` peak of the meta train step of a reduced TinyLlama is
  within 1% of the same tracker's on the CPU run (where the rotation is
  its plain version with autograd's own saved tensors, not the kernel's
  ``autograd.Function``).
* Kernel meta versions: output shapes and dtypes equal the plain
  versions' over random cases, one meta call counted and no launch; the
  six other decode and verify entries raise on meta.
* Init: ``lm.init`` on the CPU keeps its bits (digests of the tree before
  the meta path existed); on meta it gives the same tree of shapes.

No test imports ``repro.launch.dryrun`` or ``repro.launch.diagnose``: both
set ``XLA_FLAGS`` to 512 host devices on import.
"""
import dataclasses
import functools
import hashlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as jax_base
from repro.configs import get_config as jax_get_config
from repro.core.convert import pick_dims as jax_pick_dims
from repro.distributed import sharding as jax_shd
from repro.models import lm as jax_lm

from repro_torch import interop
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, get_config, input_specs
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import build, ops
from repro_torch.kernels import elite_decode as ed
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import rope_elite as re_k
from repro_torch.launch import diagnose, dryrun
from repro_torch.models import lm, moe
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import train_loop
from repro_torch.tree import items, leaves

MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x8": {"data": 1, "model": 8}, "4x2": {"data": 4, "model": 2}}
META = torch.device("meta")


# ---------------------------------------------------------------------------
# the reference's side (shape-only, memoized)
# ---------------------------------------------------------------------------

def _jax_mesh(axes):
    return AbstractMesh(tuple(axes.values()), tuple(axes))


def _jax_plan(axes, fsdp=True):
    return jax_shd.plan_for_mesh(_jax_mesh(axes), fsdp=fsdp)


@functools.lru_cache(maxsize=None)
def _jax_cfg(arch, tp):
    cfg = jax_shd.pad_cfg_for_tp(jax_get_config(arch), tp)
    if cfg.n_attn_layers:
        cfg = dataclasses.replace(cfg, elitekv=jax_pick_dims(cfg, 0.25, align=128))
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch, tp):
    cfg = _jax_cfg(arch, tp)
    return jax.eval_shape(lambda k: jax_lm.init(k, cfg), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_state(arch, tp):
    plan = shd.plan_for_mesh({"data": 1, "model": tp})
    cfg = dryrun.build_cfg(arch, SHAPES["train_4k"], plan)
    return cfg, lm.init(cfg, device=META)


def _spec_at(tree, path):
    for k in path:
        tree = tree[int(k) if isinstance(tree, list) else k]
    return tree


def _leaf_ids(ref_tree, table, stacked_root="blocks"):
    """A numpy tree of ``ref_tree``'s structure whose leaves are ids: one per
    layer slice of a stacked leaf ([n_super]), one per other leaf (0-d);
    ``table[id] = (reference path, stacked)``."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        stacked = path[0] == stacked_root
        n = t.shape[0] if stacked else 1
        ids = np.arange(len(table), len(table) + n, dtype=np.int64)
        table.extend([(path, stacked)] * n)
        return ids if stacked else ids[0]
    return walk(ref_tree, ())


def _matched(ref_tree, cfg):
    """[(port path, reference path, stacked)] for every port leaf, matched
    by ``interop``'s carrying of an id tree (layer ``s·P + pos`` is entry
    ``s`` of ``blocks/p{pos}``)."""
    table = []
    ids = _leaf_ids(ref_tree, table)
    port = interop.params_tree_from_reference(ids, cfg, device="cpu")
    return [(tuple(path.split("/")),) + table[int(t)] for path, t in items(port)]


def _ref_tuple(spec, stacked):
    spec = tuple(spec)
    if stacked:
        assert spec[:1] == (None,), spec
        return spec[1:]
    return spec


def _jax_elements(shape, spec, mesh):
    return math.prod(NamedSharding(mesh, spec).shard_shape(tuple(shape)))


# ---------------------------------------------------------------------------
# placement rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pad_cfg_for_tp_matches_reference(arch):
    for tp in (1, 2, 8, 16):
        want = jax_shd.pad_cfg_for_tp(jax_get_config(arch), tp)
        got = shd.pad_cfg_for_tp(get_config(arch), tp)
        assert (got.n_heads, got.n_kv_heads, got.head_dim) == \
            (want.n_heads, want.n_kv_heads, want.head_dim), (arch, tp)
    if arch == "minicpm_2b":
        assert shd.pad_cfg_for_tp(get_config(arch), 16).n_heads == 48


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_match_reference(arch, mesh):
    axes = MESHES[mesh]
    plan, jplan = shd.plan_for_mesh(axes), _jax_plan(axes)
    assert (plan.tp, plan.n_dp, plan.dp) == (jplan.tp, jplan.n_dp, jplan.dp)
    cfg, (params, buffers) = _port_state(arch, plan.tp)
    jcfg = _jax_cfg(arch, plan.tp)
    jparams, _ = _jax_shapes(arch, plan.tp)
    specs = shd.param_pspecs(params, cfg, plan)
    jspecs = jax_shd.param_pspecs(jparams, jcfg, jplan)
    pairs = _matched(jparams, cfg)
    assert sorted(p for p, *_ in pairs) == sorted(tuple(p.split("/")) for p, _ in
                                                  items(params))
    for ppath, rpath, stacked in pairs:
        leaf, jleaf = _spec_at(params, ppath), _spec_at(jparams, rpath)
        assert tuple(leaf.shape) == tuple(jleaf.shape[1:] if stacked else jleaf.shape)
        assert _spec_at(specs, ppath) == _ref_tuple(_spec_at(jspecs, rpath), stacked), ppath
    for md in ("float32", "int8"):
        opt = shd.opt_pspecs(None, params, cfg, plan, md)
        jopt = jax_shd.opt_pspecs(None, jparams, jcfg, jplan, md)
        assert opt["step"] == tuple(jopt["step"]) == ()
        for ppath, rpath, stacked in pairs:
            for key in ("m", "v"):
                got, want = _spec_at(opt[key], ppath), _spec_at(jopt[key], rpath)
                if md == "int8":
                    got = {k: got[k] for k in ("q", "s")}
                    want = {k: _ref_tuple(want[k], stacked) for k in ("q", "s")}
                else:
                    want = _ref_tuple(want, stacked)
                assert got == want, (md, ppath)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_input_and_page_specs_match_reference(arch, mesh):
    axes = MESHES[mesh]
    plan, jplan = shd.plan_for_mesh(axes), _jax_plan(axes)
    cfg = _port_state(arch, plan.tp)[0]
    jcfg = _jax_cfg(arch, plan.tp)
    for name, shape in SHAPES.items():
        jshape = jax_base.SHAPES[name]
        assert dataclasses.astuple(shape) == dataclasses.astuple(jshape)
        assert shd.input_pspecs(cfg, shape, plan) == {
            k: tuple(v) for k, v in jax_shd.input_pspecs(jcfg, jshape, jplan).items()}
        B, S = shape.global_batch, shape.seq_len
        cache = lm.init_cache(cfg, B, S, device=META)
        jcache = jax.eval_shape(lambda: jax_lm.init_cache(jcfg, B, S, jnp.bfloat16))
        for over in (False, True):
            got = shd.cache_pspecs(cache, cfg, plan, B, seq_over_tp=over)
            want = jax_shd.cache_pspecs(jcache, jcfg, jplan, B, seq_over_tp=over)
            assert got["index"] == tuple(want["index"]) == ()
            assert set(got["blocks"]) == set(want["blocks"])
            for pos, leaves_ in cache["blocks"].items():
                for leaf_name, t in leaves_.items():
                    assert tuple(t.shape) == tuple(jcache["blocks"][pos][leaf_name].shape)
                    assert got["blocks"][pos][leaf_name] == tuple(
                        want["blocks"][pos][leaf_name]), (name, over, pos, leaf_name)
    assert shd.serving_page_pspecs(cfg, plan) == {
        k: tuple(v) for k, v in jax_shd.serving_page_pspecs(jcfg, jplan).items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resident_elements_match_reference(arch, mesh):
    """Per device and kind, for every shape cell, as ``lower_cell`` sums
    them (the decode plan without FSDP where the reference drops it)."""
    axes = MESHES[mesh]
    jmesh = _jax_mesh(axes)
    for name, shape in SHAPES.items():
        decode = shape.kind == "decode"
        plan = shd.plan_for_mesh(axes)
        fsdp = dryrun.decode_fsdp_default(arch, plan) if decode else True
        assert fsdp == (not decode or jax_get_config(arch).param_count() * 2 / plan.tp > 8e9)
        plan, jplan = shd.plan_for_mesh(axes, fsdp=fsdp), _jax_plan(axes, fsdp=fsdp)
        cfg = dryrun.build_cfg(arch, shape, plan)
        jcfg = _jax_cfg(arch, plan.tp)
        md = "int8" if cfg.param_count() > 5e10 else "float32"
        assert md == ("int8" if jcfg.param_count() > 5e10 else "float32")
        cell = dryrun.Cell(cfg, shape, md if shape.kind == "train" else "float32")
        state = dryrun.cell_state(cell, META)
        got = dryrun.resident(cfg, shape, plan, state, md, seq_over_tp=decode)
        got = {k: v["elements"] for k, v in got.items()}
        jparams, jbuffers = _jax_shapes(arch, plan.tp)
        jspecs = jax_shd.param_pspecs(jparams, jcfg, jplan)
        count = lambda tree, specs: sum(
            _jax_elements(t.shape, s, jmesh) for t, s in zip(
                jax.tree.leaves(tree), jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                    x, P))))
        want = {"params": count(jparams, jspecs),
                "buffers": sum(math.prod(t.shape) for t in jax.tree.leaves(jbuffers))}
        if shape.kind == "train":
            jopt = jax_shd.opt_pspecs(None, jparams, jcfg, jplan, md)
            m = jopt["m"]
            if md == "int8":
                q = count(jparams, jax.tree.map(lambda s: s["q"], m,
                                                is_leaf=lambda x: isinstance(x, dict)
                                                and "q" in x))
                srow = jax.tree.map(lambda t: jax.ShapeDtypeStruct(t.shape[:-1] + (1,),
                                                                   jnp.float32), jparams)
                s = count(srow, jax.tree.map(lambda s: s["s"], m,
                                             is_leaf=lambda x: isinstance(x, dict)
                                             and "q" in x))
                want["opt_state"] = 1 + 2 * (q + s)
            else:
                want["opt_state"] = 1 + 2 * count(jparams, m)
        else:
            B, S = shape.global_batch, shape.seq_len
            jcache = jax.eval_shape(lambda: jax_lm.init_cache(jcfg, B, S, jnp.bfloat16))
            cspecs = jax_shd.cache_pspecs(jcache, jcfg, jplan, B, seq_over_tp=decode)
            want["cache"] = count(jcache["blocks"], cspecs["blocks"])
        jin = jax_base.input_specs(jcfg, jax_base.SHAPES[name])
        ispecs = jax_shd.input_pspecs(jcfg, jax_base.SHAPES[name], jplan)
        want["inputs"] = sum(_jax_elements(v.shape, ispecs[k], jmesh) for k, v in jin.items())
        assert got == want, (name, mesh)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        got = input_specs(cfg, shape)
        want = jax_base.input_specs(jcfg, jax_base.SHAPES[name])
        assert list(got) == list(want), name
        for k, t in got.items():
            assert t.is_meta and tuple(t.shape) == tuple(want[k].shape), (name, k)
            assert t.dtype == (torch.int64 if want[k].dtype == jnp.int32 else torch.float32)


def test_shard_shape_and_meshes():
    from repro_torch.launch.mesh import production_mesh_axes
    assert production_mesh_axes() == {"data": 16, "model": 16}
    assert production_mesh_axes(multi_pod=True) == {"pod": 2, "data": 16, "model": 16}
    plan = shd.plan_for_mesh(production_mesh_axes(multi_pod=True))
    assert (plan.tp, plan.n_dp, plan.chips, plan.dp, plan.tag) == (
        16, 32, 512, ("pod", "data"), "2x16x16")
    assert shd.shard_shape((64, 4096, 7), (("pod", "data"), "model"), plan) == (2, 256, 7)
    assert shd.shard_shape((3,), (), plan) == (3,)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

TRACE_ARCHS = ("tinyllama_1_1b", "qwen3_moe_235b", "jamba_v0_1_52b", "falcon_mamba_7b",
               "internvl2_2b", "musicgen_large")


def _reduced(arch):
    cfg = get_config(arch).reduced()
    return cfg.with_elitekv() if cfg.n_attn_layers else cfg


def _cpu_flops(cell, state):
    """FlopCounterMode's count of the step on CPU tensors, what it counted
    inside the kernel entries (their plain versions), and the kernels'
    cost formulas on the calls' own inputs."""
    inside, formulas = [0], {}
    real = {n: getattr(ops, n) for n in ("elite_decode", "flash_prefill", "rope_elite_qk")}

    def wrap(name, fn, cost):
        def run(*a):
            before = fc.get_total_flops()
            out = fn(*a)
            inside[0] += fc.get_total_flops() - before
            formulas[name] = formulas.get(name, 0) + cost(a)[1]
            return out
        return run

    costs = {"elite_decode": ed.contig_decode_cost,
             "flash_prefill": lambda a: fp.prefill_cost(a[0], a[1], a[5], a[6]),
             "rope_elite_qk": re_k.rope_cost}
    with FlopCounterMode(display=False) as fc:
        try:
            for n, fn in real.items():
                setattr(ops, n, wrap("rope_elite" if n == "rope_elite_qk" else n, fn,
                                     costs[n]))
            dryrun.run_step(cell, state)
        finally:
            for n, fn in real.items():
                setattr(ops, n, fn)
    return fc.get_total_flops(), inside[0], formulas


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", TRACE_ARCHS)
def test_trace_runs_on_meta_and_counts_the_cpu_flops(arch, kind):
    cfg = _reduced(arch)
    cell = dryrun.Cell(cfg, ShapeConfig("t", 16, 2, kind))
    launched = ops.launches()
    tr = dryrun.trace_step(cell)
    assert ops.launches() == launched                       # meta launches nothing
    assert tr["temp_bytes"] > 0 and tr["largest"]
    state = dryrun.cell_state(cell, "cpu", seed=3)
    total, inside, formulas = _cpu_flops(cell, state)
    assert tr["operator_flops"] == total - inside > 0
    if kind == "train" and cfg.n_attn_layers:
        # the CPU's backward is autograd through the plain rotation; on meta
        # the kernel's transpose, once per layer against two forwards (remat)
        back = tr["kernels"].pop("rope_elite_backward")
        assert back["calls"] == cfg.n_attn_layers
        assert 2 * back["flops"] == formulas["rope_elite"]
    assert {k: v["flops"] for k, v in tr["kernels"].items()} == formulas


def test_meta_peak_within_one_percent_of_the_cpu_run():
    cfg = _reduced("tinyllama_1_1b")
    cell = dryrun.Cell(cfg, ShapeConfig("t", 64, 4, "train"))
    meta = dryrun.trace_step(cell)
    state = dryrun.cell_state(cell, "cpu", seed=3)
    assert dryrun.tree_bytes(state) == meta["input_bytes"]
    with dryrun.LiveBytes() as live:
        out = dryrun.run_step(cell, state)
    del out
    assert abs(meta["temp_bytes"] - live.peak) <= 0.01 * live.peak, (meta["temp_bytes"],
                                                                       live.peak)


def test_live_bytes_counts_new_storages_once():
    x = torch.empty(1000, device=META)
    with dryrun.LiveBytes() as live:
        y = x * 2                          # 4000 B → 4096
        v = y.view(10, 100)                # a view: nothing
        y.add_(1)                          # in place: nothing
        z = torch.cat([y, y])              # 8000 → 8192
        del y, v
        w = z[:10].clone()                 # 40 → 512, after y went
        del z
    assert live.peak == 4096 + 8192 and live.live == 512
    assert [r["bytes"] for r in live.at_peak(5)] == [8192, 4096]
    assert live.peak_name == "aten.cat.default"
    del w
    assert live.live == 0


def test_live_bytes_runs_accumulating_backward_formulas_in_place():
    """Under any dispatch mode autograd's backward of ``index``, ``gather``
    and ``sort`` writes into its fresh zeros out of place
    (``index_put``, ``scatter_add``, ``scatter``); the tracker runs them in
    place, as they run with no mode on (the card's allocations)."""
    x = torch.randn(1000, requires_grad=True)
    z = torch.randn(4, 6, requires_grad=True)
    idx = torch.tensor([0, 5, 5, 999])
    y = (x[idx].sum() + torch.gather(z, 1, torch.tensor([[0], [1], [2], [2]])).sum()
         + torch.sort(z, dim=1)[0][:, :2].sum())
    with dryrun.LiveBytes() as live:
        y.backward()
    made = [r[1] for r in live.records]
    for op in ("aten.index_put.default", "aten.scatter_add.default", "aten.scatter.src"):
        assert op not in made, op
    assert "aten.new_zeros.default" in made
    assert x.grad[5] == 2.0 and x.grad[0] == 1.0 and x.grad.sum() == 4.0
    smallest = torch.sort(z.detach(), dim=1)[1][:, :2]
    want = torch.zeros(4, 6)
    want[torch.arange(4), torch.tensor([0, 1, 2, 2])] += 1
    want.scatter_add_(1, smallest, torch.ones(4, 2))
    assert torch.equal(z.grad, want)


def test_lower_cell_one_card_and_production_records():
    one = dryrun.lower_cell("tinyllama_1_1b", "decode_32k", mesh_axes={"data": 1, "model": 1},
                            batch=2, seq_len=64, overrides={"num_layers": 2})
    mem = one["memory"]
    assert one["mesh"] == "1x1" and one["collectives"] == {} and one["flops_split"] is None
    assert mem["peak_estimate_bytes"] == mem["step_input_bytes"] + mem["temp_bytes"]
    assert mem["step_input_bytes"] == mem["argument_bytes"]
    assert one["kernels"]["elite_decode"]["calls"] == 2
    prod = dryrun.lower_cell("tinyllama_1_1b", "decode_32k", overrides={"num_layers": 2})
    assert prod["mesh"] == "16x16" and prod["fsdp"] is False and prod["decode_seq_tp"]
    pm = prod["memory"]        # traced sharded: the cache sequence over "model"
    assert pm["temp_bytes"] > 0 and "reason" not in pm
    assert pm["peak_estimate_bytes"] == pm["step_input_bytes"] + pm["temp_bytes"]
    assert prod["flops_split"] is None and prod["collective_bytes_per_device"] > 0
    skipped = dryrun.lower_cell("tinyllama_1_1b", "long_500k")
    assert skipped["skipped"] and "long_500k" in skipped["reason"]


def test_production_flops_extrapolate_a_full_trace():
    """At tp > 1 the FLOPs come from traces of no layers and one layer
    period, extrapolated to full depth, at the per-replica batch: equal to
    a trace of the whole depth (two Jamba periods, decode, 2 x 2 mesh)."""
    axes = {"data": 2, "model": 2}
    rec = dryrun.lower_cell("jamba_v0_1_52b", "decode_32k", mesh_axes=axes, batch=4,
                            seq_len=64, overrides={"num_layers": 16})
    plan = shd.plan_for_mesh(axes)
    cfg = dryrun.build_cfg("jamba_v0_1_52b", SHAPES["decode_32k"], plan,
                           overrides={"num_layers": 16})
    full = dryrun.trace_step(dryrun.Cell(cfg, ShapeConfig("decode_32k", 64, 2, "decode")),
                             memory=False)
    assert rec["flops_per_device"] == full["flops"] * 2 / 4
    assert rec["kernels"]["elite_decode"]["calls"] == 2 * full["kernels"]["elite_decode"]["calls"]


@pytest.mark.parametrize("arch,shape", [("tinyllama_1_1b", "train_4k"),
                                        ("falcon_mamba_7b", "train_4k"),
                                        ("falcon_mamba_7b", "prefill_32k"),
                                        ("falcon_mamba_7b", "decode_32k")])
def test_sharded_trace_extrapolates_a_full_depth_trace(arch, shape):
    """At tp > 1 a sharded trace may be extrapolated from three and four
    layer periods (``depth="periods"``): on six layers at 16 x 16 it
    equals the full-depth trace in every count, byte and FLOP."""
    kw = dict(batch=32, seq_len=64, overrides={"num_layers": 6})
    full = dryrun.lower_cell(arch, shape, depth="full", **kw)
    ext = dryrun.lower_cell(arch, shape, depth="periods", **kw)
    for key in ("flops_per_device", "operator_flops_per_device", "kernels", "collectives",
                "collective_bytes_per_device"):
        assert ext[key] == full[key], key
    for key in ("temp_bytes", "peak_estimate_bytes", "output_bytes", "step_input_bytes"):
        assert ext["memory"][key] == full["memory"][key], key
    assert full["memory"]["temp_bytes"] > 0 and full["collectives"]


def test_dryrun_cli_and_diagnose_report(tmp_path, capsys):
    assert dryrun.main(["--arch", "tinyllama_1_1b", "--shape", "decode_32k", "--out",
                        str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "16x16" / "tinyllama_1_1b__decode_32k.json").read_text())
    assert rec["kind"] == "decode" and rec["resident"]["cache"]["bytes"] > 0
    assert rec["memory"]["temp_bytes"] > 0 and "all-reduce" in rec["collectives"]
    # the decode plan's switches: FSDP kept; the cache sequence whole over "model"
    for flag, key, want in (("--decode-fsdp", "fsdp", True),
                            ("--no-decode-seq-tp", "decode_seq_tp", False)):
        out = tmp_path / flag.strip("-")
        assert dryrun.main(["--arch", "tinyllama_1_1b", "--shape", "decode_32k", flag,
                            "--out", str(out)]) == 0
        got = json.loads((out / "16x16" / "tinyllama_1_1b__decode_32k.json").read_text())
        assert got[key] is want and got["memory"]["temp_bytes"] > 0, flag
        assert got["resident"] != rec["resident"], flag
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "tinyllama_1_1b", "--shape", "train_4k", "--param-dtype",
                     "bfloat16"])
    capsys.readouterr()
    diagnose.main(["--arch", "tinyllama_1_1b", "--shape", "decode_32k", "--one-card",
                   "--batch", "2", "--seq-len", "64"])
    out = capsys.readouterr().out
    for part in ("peak/device:", "resident/device:", "flops/device:",
                 "collectives: none (one device)", "largest live tensors at the peak"):
        assert part in out, part
    with pytest.raises(SystemExit):
        diagnose.main(["--arch", "tinyllama_1_1b"])


# ---------------------------------------------------------------------------
# kernel meta versions
# ---------------------------------------------------------------------------

def _pair(shape, seed, dtype=torch.float32, high=None):
    g = torch.Generator().manual_seed(seed)
    cpu = (torch.randint(0, high, shape, generator=g, dtype=dtype) if high else
           torch.randn(shape, generator=g))
    return cpu, torch.empty(shape, dtype=dtype, device=META)


def _run_both(fn, cpu_args, meta_args):
    build.reset_meta_calls()
    launched = ops.launches()
    want = fn(*cpu_args)
    got = fn(*meta_args)
    assert ops.launches() == launched
    return got, want


def _same_meta(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.is_meta and g.shape == w.shape and g.dtype == w.dtype


@pytest.mark.parametrize("seed", range(4))
def test_kernel_meta_versions_give_the_plain_shapes(seed):
    rng = np.random.default_rng(seed)
    B, S, nkv, G = int(rng.integers(1, 4)), int(rng.integers(1, 70)), int(rng.choice([1, 2, 4])), \
        int(rng.choice([1, 2, 8]))
    nh, r2, dc = nkv * G, int(rng.choice([8, 16, 32])), int(rng.choice([16, 64]))
    separate = bool(rng.integers(0, 2))
    cpu, meta = zip(*[_pair(s, seed * 10 + i) for i, s in enumerate(
        [(B, nh, r2), (B, nh, dc), (B, S, nkv, r2), (B, S, dc), (B, S, dc)])])
    c_v_cpu, c_v_meta = (cpu[4], meta[4]) if separate else (cpu[3], meta[3])
    lens_cpu = torch.full((B,), S, dtype=torch.int32)
    lens_meta = torch.empty((B,), dtype=torch.int32, device=META)
    got, want = _run_both(ops.elite_decode, (*cpu[:4], c_v_cpu, lens_cpu, G, 0.1),
                          (*meta[:4], c_v_meta, lens_meta, G, 0.1))
    _same_meta(got, want)
    assert build.META_CALLS["elite_decode"]["flops"] == ed.contig_decode_cost(
        (*cpu[:4], c_v_cpu, lens_cpu))[1]
    plan = ed.plan_for("elite_decode", (*meta[:4], c_v_meta, lens_meta, G, 0.1),
                       build.TARGET_SMS, build.TARGET_SMEM_OPTIN)
    assert plan.heads * plan.groups == nkv
    # flash_prefill: a prefill (Sq = Sk) and a decode-shaped call
    dh = int(rng.choice(fp.HEAD_DIMS))
    for Sq in (S, 1):
        cpu, meta = zip(*[_pair(s, seed * 20 + i) for i, s in enumerate(
            [(B, Sq, nh, dh), (B, S, nkv, dh), (B, S, nkv, dh)])])
        offs, lens = (torch.full((B,), S - Sq, dtype=torch.int32),
                      torch.full((B,), S, dtype=torch.int32))
        m_i = lambda: torch.empty((B,), dtype=torch.int32, device=META)
        got, want = _run_both(ops.flash_prefill, (*cpu, G, 0.1, offs, lens),
                              (*meta, G, 0.1, m_i(), m_i()))
        _same_meta(got, want)
        assert build.META_CALLS["flash_prefill"]["flops"] == fp.prefill_cost(
            cpu[0], cpu[1], offs, lens)[1]
    # the rotations: q and k together, one tensor, and the backward
    r = r2 // 2
    cpu, meta = zip(*[_pair(s, seed * 30 + i) for i, s in enumerate(
        [(B, S, nh, 2 * r), (B, S, nkv, 2 * r), (nkv, r)])])
    pos_cpu = torch.arange(S)
    pos_meta = torch.empty((S,), dtype=torch.int64, device=META)
    got, want = _run_both(ops.rope_elite_qk, (cpu[0], cpu[1], pos_cpu, cpu[2], G, 1),
                          (meta[0], meta[1], pos_meta, meta[2], G, 1))
    _same_meta(got, want)
    got, want = _run_both(ops.rope_elite, (cpu[1], pos_cpu, cpu[2]),
                          (meta[1], pos_meta, meta[2]))
    _same_meta(got, want)
    q, k = (t.detach().requires_grad_(True) for t in meta[:2])
    build.reset_meta_calls()
    qr, kr = ops.rope_elite_qk(q, k, pos_meta, meta[2], G, 1)
    (qr.sum() + kr.sum()).backward()
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert {n: c["calls"] for n, c in build.META_CALLS.items()} == {
        "rope_elite": 1, "rope_elite_backward": 1}


def test_elite_decode_meta_with_lse_counts_its_output():
    """``return_lse`` on meta tensors: (o, lse) of the plain version's
    shapes, and the call's bytes count the [B, nh] f32 log-sum-exp."""
    B, S, nkv, G, r2, dc = 2, 40, 2, 4, 8, 16
    cpu, meta = zip(*[_pair(s, 70 + i) for i, s in enumerate(
        [(B, nkv * G, r2), (B, nkv * G, dc), (B, S, nkv, r2), (B, S, dc)])])
    lens_cpu = torch.tensor([S, 7], dtype=torch.int32)
    lens_meta = torch.empty((B,), dtype=torch.int32, device=META)
    got, want = _run_both(lambda *a: ops.elite_decode(*a, return_lse=True),
                          (*cpu, cpu[3], lens_cpu, G, 0.1), (*meta, meta[3], lens_meta, G, 0.1))
    _same_meta(got, want)
    args = (*cpu, cpu[3], lens_cpu)
    nbytes, flops = ed.contig_decode_cost(args, rows=B * S, lse=True)
    assert build.META_CALLS["elite_decode"] == {"calls": 1, "bytes": nbytes, "flops": flops}
    assert nbytes == ed.contig_decode_cost(args, rows=B * S)[0] + 4 * B * nkv * G


def test_elite_decode_meta_allocates_the_launchers_scratch():
    build.free_scratch(META)
    B, S, nkv, G, r2, dc = 3, 1000, 4, 8, 16, 64
    q_e, q_lat = (torch.empty(s, device=META) for s in ((B, nkv * G, r2), (B, nkv * G, dc)))
    k_e, c = (torch.empty(s, device=META) for s in ((B, S, nkv, r2), (B, S, dc)))
    lens = torch.empty((B,), dtype=torch.int32, device=META)
    ops.elite_decode(q_e, q_lat, k_e, c, c, lens, G, 0.1)
    p = ed.plan_for("elite_decode", (q_e, q_lat, k_e, c, c, lens, G),
                    build.TARGET_SMS, build.TARGET_SMEM_OPTIN)
    part, cnt = build._SCRATCH[(META, "elite_decode")]
    units = B * p.groups * p.parts
    assert part.numel() == units * p.splits * G * p.heads * (dc + 2)
    assert cnt.numel() == units and cnt.dtype == torch.int32
    build.free_scratch(META)


REFUSED = ("elite_decode_paged", "elite_decode_paged_q8", "elite_decode_sparse_paged",
           "elite_decode_sparse_paged_q8", "elite_verify_paged", "elite_verify_paged_q8")


@pytest.mark.parametrize("name", REFUSED)
def test_other_entries_raise_on_meta(name):
    fn = getattr(ops, name)
    n_args = fn.__code__.co_argcount
    args = [torch.empty((2, 4, 8), device=META)] + [None] * (n_args - 1)
    with pytest.raises(NotImplementedError, match=name):
        fn(*args)


def test_moe_even_groups_on_meta():
    assert moe.even_group_sizes(10, 4) == [3, 3, 3, 1]
    assert moe.even_group_sizes(3, 4) == [1, 1, 1, 0]
    assert sum(moe.even_group_sizes(4096 * 8, 128)) == 4096 * 8
    cfg = _reduced("qwen3_moe_235b")
    params, _ = lm.init(cfg, device=META)
    syncs = moe.group_size_syncs
    y, aux = moe.apply(params["layers"][0]["ffn"], cfg,
                       torch.empty((2, 8, cfg.d_model), device=META))
    assert y.shape == (2, 8, cfg.d_model) and y.is_meta and moe.group_size_syncs == syncs


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

#: sha256 of every leaf's bytes, in ``items`` order, of ``lm.init(seed=0)``
#: on the CPU, taken from the tree before the meta path existed
INIT_DIGESTS = {
    "tinyllama_1_1b": "8e4a91c81dd6c20d2f600c63b44412330a1569a9aedd3d926b246fb9033a4990",
    "jamba_v0_1_52b": "01ce9a8d7ed8e7f43537ca668ff47fcdd3c5c7719008b71ca86684cee0488120",
    "qwen3_moe_235b": "5bd25b0d59eb5c73c83cb8222d37dfe7372e6e4dec865fb14900243a48ce99e4",
}


def _digest(tree) -> str:
    h = hashlib.sha256()
    for path, t in items(tree):
        h.update(path.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("arch", list(INIT_DIGESTS))
def test_init_on_cpu_keeps_its_bits_and_meta_its_shapes(arch):
    cfg = _reduced(arch)
    params, buffers = lm.init(cfg, seed=0, device="cpu")
    assert _digest({"params": params, "buffers": buffers}) == INIT_DIGESTS[arch]
    mp, mb = lm.init(cfg, seed=0, device=META)
    for (pa, a), (pb, b) in zip(items({"p": params, "b": buffers}), items({"p": mp, "b": mb})):
        assert pa == pb and b.is_meta and a.shape == b.shape and a.dtype == b.dtype
    cache = lm.init_cache(cfg, 2, 16, device=META)
    assert all(t.is_meta for t in leaves(cache["blocks"]))
    for md in ("float32", "bfloat16", "int8"):
        tc = train_loop.TrainConfig(optimizer=AdamWConfig(moment_dtype=md))
        want = train_loop.init_opt_state(params, tc)
        got = train_loop.init_opt_state(mp, tc)
        for (pa, a), (pb, b) in zip(items(want), items(got)):
            assert pa == pb and b.is_meta and a.shape == b.shape and a.dtype == b.dtype
