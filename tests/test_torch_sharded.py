"""The sharding executor: the port's train and prefill steps sharded over a
``DeviceMesh`` by the reference's rules, held to the one-process port and
to the JAX package.

One spawn per module of four gloo processes on a 2 × 2 ``("data",
"model")`` debug mesh (``make_debug_mesh((2, 2), device_type="cpu")``)
runs every case: reduced TinyLlama (2 layers, vocab 256, 4 / 2 heads; B 4
× 32, the reference's ``test_sharded_loss_matches_single_device``) with
EliteKV on and off, and Falcon-Mamba reduced to 2 layers.  The same
weights (from the reference's ``lm.init`` through ``repro_torch.interop``)
and numpy batches go through the one-process port here.  Tolerances, f32
throughout, the same math summed in another order across shards:

* the loss: rel 1e-5 against the one-process port, rel 1e-4 against the
  JAX ``lm.loss_fn`` (the reference's own tolerance for its sharded loss);
* every gradient leaf (``full_tensor()``) and both AdamW moments after one
  step: within 1e-5 of the leaf's largest one-process magnitude; the
  weights after that step as ``tests/test_torch_train.py`` holds the port's
  to the reference's: within 1e-6 where the gradient is at least 1e-4, and
  within 2·lr elsewhere, since the first step moves a weight by ``lr·g /
  (|g| + eps)``, which a gradient near zero summed in another order may
  turn to the other sign;
* the prefill step's logits and cache: within 1e-5 of the largest.

Rank 0's ``CommDebugMode`` counts of the sharded train and prefill steps
equal a fake-group trace of the same cells (``launch/dryrun.py``'s
``trace_sharded`` on a "cpu" mesh, whose routes gloo takes).  The rest
runs in this process inside ``fake_group``, which always tears its group
down: local shapes against ``shard_shape``, ``make_constrain`` on plain
tensors, ``make_debug_mesh`` on one process, the two kernels' ``local_map``
wrappers at every shard's coordinate (a shard's kv heads sliced from
replicated ones), and the dry run's records at 16 × 16.
"""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.models import lm as jax_lm

from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config, make_inputs
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_group, make_debug_mesh
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import serve_loop, train_loop
from repro_torch.tree import items, leaves, map_tree

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 32
LR = 1e-3
CASES = {"elitekv": ("tinyllama_1_1b", True), "baseline": ("tinyllama_1_1b", False),
         "mamba": ("falcon_mamba_7b", False)}


def _cfgs(case):
    arch, elite = CASES[case]
    over = (dict(num_layers=2, vocab_size=256, n_heads=4, n_kv_heads=2)
            if arch == "tinyllama_1_1b" else dict(num_layers=2, vocab_size=256))
    jcfg = jax_get_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    if elite:
        jcfg, cfg = jcfg.with_elitekv(), cfg.with_elitekv()
    return jcfg, cfg


def _train_config():
    return train_loop.TrainConfig(lr=LR, optimizer=AdamWConfig())


WORKER = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.runtime import serve_loop, train_loop
    from repro_torch.tree import items, map_tree

    rank, world, port, src, dst = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                   sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        plan = shd.plan_for_mesh(mesh)
        full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
        out = {}
        for case, c in torch.load(src, weights_only=False).items():
            cfg, tc = c["cfg"], c["tc"]
            B, S = c["batch"]["tokens"].shape
            train = ShapeConfig("train", S, B, "train")
            cell = dryrun.Cell(cfg, train)
            state = {"params": c["params"], "buffers": c["buffers"], "batch": c["batch"],
                     "opt_state": train_loop.init_opt_state(c["params"], tc)}
            placed = dryrun.place_state(cell, plan, state)
            con = shd.make_constrain(plan, cfg, S, B)
            p, b = placed["params"], placed["buffers"]
            with CommDebugMode() as cdm:
                new_p, new_opt, metrics = train_loop.make_train_step(cfg, tc, constrain=con)(
                    p, b, placed["opt_state"], placed["batch"])
            train_counts = dryrun.comm_counts(cdm)
            # the loss and its gradients (the step's first half), then prefill
            tp_ = map_tree(lambda t: t.detach().requires_grad_(True), p)
            loss, _ = lm.loss_fn(tp_, b, cfg, placed["batch"], constrain=con)
            loss.backward()
            grads = {k: full(v.grad) for k, v in items(tp_)}
            pre = ShapeConfig("prefill", S, B, "prefill")
            pcell = dryrun.Cell(cfg, pre)
            pstate = {"params": c["params"], "buffers": c["buffers"],
                      "batch": {"tokens": c["batch"]["tokens"]},
                      "cache": lm.init_cache(cfg, B, S, device="cpu")}
            pplaced = dryrun.place_state(pcell, plan, pstate)
            before = {k: v.placements for k, v in items(pplaced["cache"]["blocks"])}
            with torch.no_grad(), CommDebugMode() as cdm:
                logits = serve_loop.make_prefill_step(cfg, constrain=con)(
                    p, b, pplaced["batch"], pplaced["cache"])
            out[case] = {
                "step_loss": float(full(metrics["loss"])),
                "loss": float(full(loss.detach())),
                "grads": grads,
                "new_params": {k: full(v) for k, v in items(new_p)},
                "new_m": {k: full(v) for k, v in items(new_opt["m"])},
                "new_v": {k: full(v) for k, v in items(new_opt["v"])},
                "logits": full(logits),
                "cache": {k: full(v) for k, v in items(pplaced["cache"]["blocks"])},
                "cache_kept": all(v.placements == before[k]
                                  for k, v in items(pplaced["cache"]["blocks"])),
                "train_counts": train_counts,
                "prefill_counts": dryrun.comm_counts(cdm),
                "sharded": {k: any(x.is_shard() for x in v.placements) for k, v in items(p)},
            }
        if rank == 0:
            torch.save(out, dst)
    finally:
        dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def models():
    """Per case: (jax cfg, port cfg, jax params, jax buffers, port params,
    port buffers, the numpy batch)."""
    out = {}
    for case in CASES:
        jcfg, cfg = _cfgs(case)
        jp, jb = jax_lm.init(jax.random.PRNGKey(0), jcfg)
        tp, tb = interop.from_reference(jax.tree.map(np.asarray, jp),
                                        jax.tree.map(np.asarray, jb), jcfg, device="cpu")
        out[case] = (jcfg, cfg, jp, jb, tp, tb, make_inputs(cfg, B, S, "train", seed=0))
    return out


def _torch_batch(np_batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in np_batch.items()}


def _fake_trace_counts(cfg):
    """{kind: counts} of the fake-group traces of the sharded train and
    prefill steps at B × S on a "cpu" 2 × 2 mesh."""
    plan = shd.plan_for_mesh({"data": 2, "model": 2})
    out = {}
    for kind in ("train", "prefill"):
        tr = dryrun.trace_sharded(dryrun.Cell(cfg, ShapeConfig(kind, S, B, kind)), plan,
                                  device_type="cpu")
        out[kind] = ({k: v["count"] for k, v in tr["collectives"].items() if v["count"]},
                     tr["local_counts"])
    return out


@pytest.fixture(scope="module")
def runs(models, tmp_path_factory):
    """Per case: "sharded", rank 0's results of the four gloo processes;
    "one", the one-process port's; "traces", the fake-group traces' counts.
    The last two are computed here while the processes run."""
    tmp = tmp_path_factory.mktemp("sharded")
    src, dst = tmp / "in.pt", tmp / "out.pt"
    torch.save({case: {"cfg": cfg, "tc": _train_config(), "params": tp, "buffers": tb,
                       "batch": _torch_batch(batch)}
                for case, (_, cfg, _, _, tp, tb, batch) in models.items()}, src)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [tmp / f"rank{r}.log" for r in range(4)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER, str(r), "4", str(port), str(src), str(dst)],
                env=env, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT))
    try:
        out = {"one": {case: _one_process(cfg, tp, tb, _torch_batch(batch))
                       for case, (_, cfg, _, _, tp, tb, batch) in models.items()},
               "traces": {case: _fake_trace_counts(m[1]) for case, m in models.items()}}
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(p.returncode, log.read_text()[-3000:]) for p, log in zip(procs, logs)
           if p.returncode != 0]
    assert not bad, bad
    out["sharded"] = torch.load(dst, weights_only=False)
    return out


@pytest.fixture(scope="module")
def sharded(runs):
    return runs["sharded"]


@pytest.fixture(scope="module")
def one_process(runs):
    return runs["one"]


def _one_process(cfg, tp, tb, batch):
    """The one-process port: (loss, grads, params after one step, prefill
    logits and cache)."""
    tc = _train_config()
    p = map_tree(lambda t: t.detach().requires_grad_(True), tp)
    loss, _ = lm.loss_fn(p, tb, cfg, batch)
    loss.backward()
    grads = {k: v.grad for k, v in items(p)}
    new_p, new_opt, metrics = train_loop.make_train_step(cfg, tc)(
        tp, tb, train_loop.init_opt_state(tp, tc), batch)
    cache = lm.init_cache(cfg, B, S, device="cpu")
    with torch.no_grad():
        logits = serve_loop.make_prefill_step(cfg)(tp, tb, {"tokens": batch["tokens"]}, cache)
    return dict(loss=float(loss.detach()), step_loss=float(metrics["loss"]), grads=grads,
                new_params=dict(items(new_p)), new_m=dict(items(new_opt["m"])),
                new_v=dict(items(new_opt["v"])), logits=logits,
                cache=dict(items(cache["blocks"])))


def _close(got, want, tol=1e-5):
    """max |Δ| over the leaf <= tol · the leaf's largest |want|."""
    err = float((got - want).abs().max()) if want.numel() else 0.0
    return err <= tol * float(want.abs().max()) if want.numel() else True, err


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_loss_matches_one_process_and_jax(case, models, sharded, one_process):
    jcfg, _, jp, jb, _, _, batch = models[case]
    want = one_process[case]["loss"]
    got = sharded[case]
    assert got["loss"] == pytest.approx(want, rel=1e-5)
    assert got["step_loss"] == pytest.approx(one_process[case]["step_loss"], rel=1e-5)
    jbatch = {k: jnp.asarray(np.asarray(v).astype(np.int32)) for k, v in batch.items()}
    jloss, _ = jax_lm.loss_fn(jp, jb, jcfg, jbatch)
    assert got["loss"] == pytest.approx(float(jloss), rel=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_gradients_and_adamw_step_match_one_process(case, sharded, one_process):
    got, want = sharded[case], one_process[case]
    assert set(got["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        for key in ("grads", "new_m", "new_v"):
            ok, err = _close(got[key][k], want[key][k])
            assert ok, (key, k, err)
        d = (got["new_params"][k] - want["new_params"][k]).abs()
        assert float(torch.where(g.abs() >= 1e-4, d, 0.0).max()) <= 1e-6, k
        assert float(d.max()) <= 2 * LR, k
    # the weights really were sharded by the rules
    assert any(got["sharded"].values()) and not got["sharded"]["final_norm/scale"]


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_prefill_matches_one_process(case, sharded, one_process):
    got, want = sharded[case], one_process[case]
    ok, err = _close(got["logits"], want["logits"])
    assert ok, err
    assert got["cache_kept"]            # written in place, placements unchanged
    assert set(got["cache"]) == set(want["cache"])
    for k in want["cache"]:
        ok, err = _close(got["cache"][k], want["cache"][k])
        assert ok, (k, err)


@pytest.mark.parametrize("case", list(CASES))
def test_rank0_collectives_equal_the_fake_group_trace(case, runs):
    for kind in ("train", "prefill"):
        counts, own = runs["traces"][case][kind]
        assert runs["sharded"][case][f"{kind}_counts"] == counts, (kind, counts)
        assert own == counts
    assert runs["sharded"][case]["train_counts"].get("all-gather", 0) > 0


# ---------------------------------------------------------------------------
# in this process, inside a fake group
# ---------------------------------------------------------------------------

NON_MOE = [a for a in ARCH_IDS if get_config(a).n_experts == 0]


@pytest.mark.parametrize("axes", [{"data": 2, "model": 2}, {"data": 16, "model": 16}],
                         ids=["2x2", "16x16"])
@pytest.mark.parametrize("arch", NON_MOE)
def test_every_local_shape_is_shard_shape(arch, axes):
    cfg = get_config(arch).reduced()
    plan0 = shd.plan_for_mesh(axes)
    cfg = shd.pad_cfg_for_tp(cfg, plan0.tp)
    for kind in ("train", "prefill"):
        shape = ShapeConfig(kind, 64, 32, kind)
        cell = dryrun.Cell(cfg, shape)
        state = dryrun.cell_state(cell, "meta")
        with fake_group(plan0.chips, "cpu"):
            plan = dryrun.sharded_plan(plan0, "cpu")
            placed = dryrun.place_state(cell, plan, state)
            specs = {"params": shd.param_pspecs(state["params"], cfg, plan),
                     "buffers": shd.param_pspecs(state["buffers"], cfg, plan),
                     "batch": shd.input_pspecs(cfg, shape, plan)}
            if kind == "train":
                specs["opt_state"] = shd.opt_pspecs(state["opt_state"], state["params"], cfg,
                                                    plan, "float32")
            else:
                specs["cache"] = shd.cache_pspecs(state["cache"], cfg, plan, 32)
            n = 0
            for key, tree in placed.items():
                sp = specs[key] if key != "batch" else {k: specs[key][k] for k in tree}
                for (path, t), (_, s) in zip(items(tree), items(sp)):
                    if not torch.is_tensor(t):
                        continue
                    assert tuple(t.to_local().shape) == shd.shard_shape(
                        tuple(t.shape), s, plan), (key, path, s)
                    n += 1
            assert n > 0
            # the sizes-only functions agree with what is placed
            res = dryrun.resident(cfg, shape, plan, state, "float32", seq_over_tp=False)
            assert sum(v["bytes"] for v in res.values()) == dryrun.local_bytes(placed)


def test_constrain_passes_plain_tensors_and_unknown_names():
    from torch.distributed.tensor import Shard
    cfg = get_config("tinyllama_1_1b").reduced()
    with fake_group(4, "cpu"):
        plan = shd.plan_for_mesh(make_debug_mesh((2, 2), device_type="cpu"))
        con = shd.make_constrain(plan, cfg, 32, 4)
        x = torch.randn(4, 32, 128)
        for name in ("embed", "residual", "attn_in", "logits", "mlp_h", "latent", "other"):
            assert con(name, x) is x
        dx = shd.distribute({"x": x}, {"x": shd.Sharding(plan.mesh, shd.placements(
            ("data", None, None), plan))})["x"]
        assert con("other", dx) is dx
        y = con("residual", dx)               # sequence over model
        assert list(y.placements) == [Shard(0), Shard(1)]
    assert shd.make_constrain(shd.plan_for_mesh({"data": 2, "model": 2}), cfg, 32, 4)(
        "residual", x) is x                  # a plan without a mesh constrains nothing


def test_serving_page_and_optimizer_shardings():
    from torch.distributed.tensor import Replicate, Shard
    cfg = get_config("tinyllama_1_1b").reduced().with_elitekv()       # 4 / 4 heads
    with fake_group(4, "cpu"):
        plan = shd.plan_for_mesh(make_debug_mesh((2, 2), device_type="cpu"))
        pages = shd.serving_page_shardings(cfg, plan)
        assert pages["k_e"].placements == (Replicate(), Shard(2))    # kv heads over model
        assert all(v.placements == (Replicate(), Replicate())
                   for k, v in pages.items() if k != "k_e")
        params, _ = lm.init(cfg, device="meta")
        opt = train_loop.init_opt_state(params, _train_config())
        osh = shd.opt_shardings(opt, params, cfg, plan, "float32")
        psh = shd.param_shardings(params, cfg, plan)
        assert osh["step"].placements == (Replicate(), Replicate())
        assert all(a.placements == b.placements == c.placements for a, b, c in zip(
            leaves(osh["m"]), leaves(osh["v"]), leaves(psh)))


def test_make_debug_mesh_on_one_process_and_meshes():
    with fake_group(1, "cpu"):
        m = make_debug_mesh(device_type="cpu")
        assert tuple(m.mesh.shape) == (1, 1) and m.mesh_dim_names == ("data", "model")
    with fake_group(8, "cpu"):
        assert tuple(make_debug_mesh(device_type="cpu").mesh.shape) == (4, 2)
        assert tuple(make_debug_mesh(axes=("data",), device_type="cpu").mesh.shape) == (4,)
    with fake_group(512, "cpu"):
        from repro_torch.launch.mesh import make_production_mesh
        m = make_production_mesh(multi_pod=True, device_type="cpu")
        assert m.mesh_dim_names == ("pod", "data", "model") and m.size() == 512
        with pytest.raises(RuntimeError):
            with fake_group(2, "cpu"):
                pass
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        make_debug_mesh(device_type="cpu")


def _at_coordinate(monkeypatch, coord):
    from torch.distributed.device_mesh import DeviceMesh
    monkeypatch.setattr(DeviceMesh, "get_coordinate", lambda self: list(coord))


@pytest.mark.parametrize("nh,nkv", [(8, 2), (4, 1), (8, 8)])
def test_kernel_wrappers_at_every_shard(nh, nkv, monkeypatch):
    """``rope_elite_qk`` (with its backward) and ``flash_prefill`` on
    ``DTensor``s at each shard's coordinate of a 1 × 4 mesh: the local
    outputs are the plain versions' pieces, kv heads sliced from replicated
    ones where they do not divide the shards."""
    tp, Bq, Sq, dh, r = 4, 2, 24, 16, 3
    g = torch.Generator().manual_seed(0)
    q = torch.randn(Bq, Sq, nh, dh, generator=g)
    k = torch.randn(Bq, Sq, nkv, dh, generator=g)
    v = torch.randn(Bq, Sq, nkv, dh, generator=g)
    freqs = torch.rand(nkv, r, generator=g)
    pos = torch.arange(Sq)
    G = nh // nkv
    want_q, want_k = ref.rope_elite_qk_ref(q[..., :2 * r], k[..., :2 * r], pos, freqs, G, 1)
    lens = torch.full((Bq,), Sq, dtype=torch.int32)
    offs = torch.zeros(Bq, dtype=torch.int32)
    want_o = ref.flash_prefill_ref(q, k, v, G, dh ** -0.5, offs, lens)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with fake_group(tp, "cpu"):
        mesh = make_debug_mesh((1, tp), device_type="cpu")
        rep = [Replicate(), Replicate()]
        heads = [Replicate(), Shard(2)]
        kv_pl = heads if nkv % tp == 0 else rep
        for c in range(tp):
            _at_coordinate(monkeypatch, (0, c))
            piece = lambda t, pl: t.chunk(tp, 2)[c].contiguous() if pl == heads else t
            dt = lambda t, pl: DTensor.from_local(piece(t, pl), mesh, pl, run_check=False,
                                                  shape=t.shape, stride=t.stride())
            qe = dt(q[..., :2 * r].contiguous(), heads).requires_grad_(True)
            ke = dt(k[..., :2 * r].contiguous(), kv_pl).requires_grad_(True)
            ops.reset_launches()
            got_q, got_k = ops.rope_elite_qk(qe, ke, dt(pos, rep), dt(freqs, rep), G, 1)
            assert torch.equal(got_q.to_local(), piece(want_q, heads))
            assert torch.equal(got_k.to_local(), piece(want_k, kv_pl))
            (got_q.to_local().sum() + got_k.to_local().sum()).backward()
            assert qe.grad is not None and ke.grad is not None
            o = ops.flash_prefill(dt(q, heads), dt(k, kv_pl), dt(v, kv_pl), G, dh ** -0.5,
                                  dt(offs, rep), dt(lens, rep))
            assert torch.allclose(o.to_local(), piece(want_o, heads), atol=1e-6, rtol=1e-5)
            assert o.placements == tuple(heads)
            assert sum(ops.launches().values()) == 0      # plain versions on the CPU


def _records(shape_name):
    return dryrun.lower_cell("tinyllama_1_1b", shape_name, batch=32, seq_len=64,
                             overrides={"num_layers": 2})


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k"])
def test_reduced_production_records_trace_the_sharded_step(shape_name):
    rec = _records(shape_name)
    mem = rec["memory"]
    assert rec["mesh"] == "16x16" and rec["flops_split"] is None
    assert mem["temp_bytes"] > 0 and mem["peak_estimate_bytes"] >= mem["argument_bytes"]
    assert mem["step_input_bytes"] == mem["argument_bytes"]
    assert {"all-gather", "reduce-scatter"} <= set(rec["collectives"])
    assert rec["collective_bytes_per_device"] == sum(
        v["bytes"] for v in rec["collectives"].values()) > 0
    calls = {k: v["calls"] for k, v in rec["kernels"].items()}
    assert calls["rope_elite"] == (4 if shape_name == "train_4k" else 2)
    if shape_name == "prefill_32k":
        assert calls["flash_prefill"] == 2
    assert rec["largest_at_peak"]


def test_moe_and_decode_records_stay_null_with_their_reasons():
    dec = dryrun.lower_cell("tinyllama_1_1b", "decode_32k", overrides={"num_layers": 2})
    assert dec["memory"]["peak_estimate_bytes"] is None
    assert "15c.2" in dec["memory"]["reason"] and "item 15" in dec["memory"]["reason"]
    assert dec["collectives"] == {} and dec["collective_bytes_per_device"] is None
    moe = dryrun.lower_cell("qwen3_moe_235b", "train_4k", batch=32, seq_len=64,
                            overrides={"num_layers": 1})
    assert moe["memory"]["temp_bytes"] is None
    assert "15d" in moe["memory"]["reason"] and "item 15" in moe["memory"]["reason"]


def test_no_process_group_is_left():
    assert not dist.is_initialized()
