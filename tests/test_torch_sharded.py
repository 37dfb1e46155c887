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

The same spawn runs the decode plan's step (``make_decode_step(cfg,
constrain=)`` on params, tokens and cache placed by the dry run's decode
cell: no FSDP, the cache sequence over "model", ``seq_over_tp``): EliteKV
TinyLlama at B 4 × S 32, 14 tokens prefilled by the one-process port and 4
steps whose index crosses the two model shards' boundary at 16 (a shard
with no valid row), the same at B 1 (the sequence over "data", the
``long_500k`` rule), and Falcon-Mamba (channels over "model").  Each
step's logits and the cache after it: within 1e-5 of the largest of the
one-process port's, and the logits within rel 1e-4 (of the largest) of the
JAX ``lm.apply_decode`` on the same weights; greedy tokens equal wherever
the one-process top-2 margin is at least 1e-4.

Rank 0's ``CommDebugMode`` counts of the sharded train, prefill and decode
steps equal a fake-group trace of the same cells (``launch/dryrun.py``'s
``trace_sharded`` on a "cpu" mesh, whose routes gloo takes); a decode
trace at twice the cache length sends the same bytes.  The rest runs in
this process inside ``fake_group``, which always tears its group down:
local shapes against ``shard_shape``, ``make_constrain`` on plain tensors,
``make_debug_mesh`` on one process, the kernels' ``local_map`` wrappers at
every shard's coordinate (a shard's kv heads sliced from replicated ones;
a sequence-sharded decode cache's pieces merged by ``ref.merge_lse``), the
plain decode's log-sum-exp against float64 and its merge over every cut
of the sequence, and the dry run's records at 16 × 16.
"""
import copy
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
from repro.kernels import elite_decode as jax_ed
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
#: the decode cases: (the train case whose weights they take, lanes)
DECODE = {"elitekv": ("elitekv", 4), "elitekv_b1": ("elitekv", 1), "mamba": ("mamba", 4)}
PREFILLED, STEPS = 14, 4          # decode indices 14 .. 17 cross the shards' boundary at 16


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
        inp = torch.load(src, weights_only=False)
        out = {}
        for case, c in inp["train"].items():
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
        # the decode plan: no FSDP, the cache sequence over model (or data at B 1)
        dplan = shd.plan_for_mesh(mesh, fsdp=False)
        dec = {}
        for case, c in inp["decode"].items():
            cfg, toks = c["cfg"], c["tokens"]
            cell = dryrun.Cell(cfg, ShapeConfig("decode", S, toks.shape[0], "decode"),
                               seq_over_tp=True)
            placed = dryrun.place_state(cell, dplan, {
                "params": c["params"], "buffers": c["buffers"],
                "batch": {"tokens": toks[:, :1]}, "cache": c["cache"]})
            before = {k: v.placements for k, v in items(placed["cache"]["blocks"])}
            step = serve_loop.make_decode_step(cfg, constrain=dryrun.sharding_constrain(
                cell, dplan))
            rec = {"logits": [], "next": [], "cache": [], "counts": []}
            for t in range(toks.shape[1]):
                tok = shd.distribute({"tokens": toks[:, t:t + 1]}, shd.input_shardings(
                    {"tokens": None}, cfg, cell.shape, dplan))
                with torch.no_grad(), CommDebugMode() as cdm:
                    nxt, logits = step(placed["params"], placed["buffers"], tok,
                                       placed["cache"])
                rec["counts"].append(dryrun.comm_counts(cdm))
                rec["logits"].append(full(logits))
                rec["next"].append(full(nxt))
                rec["cache"].append({k: full(v) for k, v in items(placed["cache"]["blocks"])})
            rec["index"] = placed["cache"]["index"]
            rec["placements"] = {k: [x.dim if x.is_shard() else None for x in v]
                                 for k, v in before.items()}
            rec["cache_kept"] = all(v.placements == before[k]
                                    for k, v in items(placed["cache"]["blocks"]))
            dec[case] = rec
        if rank == 0:
            torch.save({"train": out, "decode": dec}, dst)
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


def _decode_traces(cfg, lanes):
    """The fake-group traces' collectives ({kind: {"count", "bytes"}}) of
    the decode plan's step at ``lanes`` × S and × 2S on a "cpu" 2 × 2 mesh."""
    plan = shd.plan_for_mesh({"data": 2, "model": 2}, fsdp=False)
    return [dryrun.trace_sharded(dryrun.Cell(cfg, ShapeConfig("decode", n, lanes, "decode"),
                                             seq_over_tp=True), plan,
                                 device_type="cpu")["collectives"] for n in (S, 2 * S)]


def _decode_inputs(models):
    """Per decode case: its config, weights, the cache with PREFILLED
    tokens prefilled by the one-process port, and STEPS decode tokens."""
    out = {}
    for case, (base, lanes) in DECODE.items():
        _, cfg, _, _, tp, tb, _ = models[base]
        toks = torch.from_numpy(np.random.default_rng(9).integers(
            0, cfg.vocab_size, (lanes, PREFILLED + STEPS)))
        cache = lm.init_cache(cfg, lanes, S, device="cpu")
        with torch.no_grad():
            lm.apply_prefill(tp, tb, cfg, {"tokens": toks[:, :PREFILLED]}, cache)
        out[case] = {"cfg": cfg, "params": tp, "buffers": tb, "cache": cache,
                     "tokens": toks[:, PREFILLED:], "prompt": toks[:, :PREFILLED]}
    return out


def _one_process_decode(c):
    """The one-process port's decode steps on a copy of the case's cache:
    per step (logits, next, the cache's leaves after it)."""
    cache = copy.deepcopy(c["cache"])
    step = serve_loop.make_decode_step(c["cfg"])
    rows = []
    for t in range(c["tokens"].shape[1]):
        with torch.no_grad():
            nxt, logits = step(c["params"], c["buffers"], c["tokens"][:, t:t + 1], cache)
        rows.append((logits, nxt, {k: v.clone() for k, v in items(cache["blocks"])}))
    return rows


def _jax_decode(models, case, c):
    """The JAX ``lm.apply_decode``'s logits per step, its cache prefilled
    with the same prompt."""
    jcfg, _, jp, jb = models[DECODE[case][0]][:4]
    lanes = c["tokens"].shape[0]
    jcache = jax_lm.init_cache(jcfg, lanes, S, dtype=jnp.float32)
    as_j = lambda t: jnp.asarray(t.numpy().astype(np.int32))
    _, jcache = jax_lm.apply_prefill(jp, jb, jcfg, {"tokens": as_j(c["prompt"])}, jcache)
    out = []
    for t in range(c["tokens"].shape[1]):
        logits, jcache = jax_lm.apply_decode(jp, jb, jcfg,
                                             {"tokens": as_j(c["tokens"][:, t:t + 1])}, jcache)
        out.append(torch.from_numpy(np.array(logits)))
    return out


@pytest.fixture(scope="module")
def runs(models, tmp_path_factory):
    """Per case: "sharded", rank 0's results of the four gloo processes;
    "one", the one-process port's; "traces", the fake-group traces' counts.
    The last two are computed here while the processes run."""
    tmp = tmp_path_factory.mktemp("sharded")
    src, dst = tmp / "in.pt", tmp / "out.pt"
    dec = _decode_inputs(models)
    torch.save({"train": {case: {"cfg": cfg, "tc": _train_config(), "params": tp,
                                 "buffers": tb, "batch": _torch_batch(batch)}
                          for case, (_, cfg, _, _, tp, tb, batch) in models.items()},
                "decode": dec}, src)
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
               "traces": {case: _fake_trace_counts(m[1]) for case, m in models.items()},
               "one_decode": {case: _one_process_decode(c) for case, c in dec.items()},
               "jax_decode": {case: _jax_decode(models, case, c) for case, c in dec.items()},
               "decode_traces": {case: _decode_traces(c["cfg"], c["tokens"].shape[0])
                                 for case, c in dec.items()}}
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
    got = torch.load(dst, weights_only=False)
    out["sharded"], out["decode"] = got["train"], got["decode"]
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


@pytest.mark.parametrize("case", list(DECODE))
def test_sharded_decode_matches_one_process_and_jax(case, runs):
    got, one, jax_rows = runs["decode"][case], runs["one_decode"][case], runs["jax_decode"][case]
    assert got["cache_kept"] and got["index"] == PREFILLED + STEPS
    for t, (logits, nxt, cache) in enumerate(one):
        ok, err = _close(got["logits"][t], logits)
        assert ok, (t, err)
        ok, err = _close(got["logits"][t], jax_rows[t], 1e-4)
        assert ok, (t, "jax", err)
        top2 = logits[:, -1].topk(2, dim=-1).values
        sure = top2[:, 0] - top2[:, 1] >= 1e-4
        assert torch.equal(got["next"][t][sure], nxt[sure]), t
        assert set(got["cache"][t]) == set(cache)
        for k, v in cache.items():
            ok, err = _close(got["cache"][t][k], v)
            assert ok, (t, k, err)
    if case.startswith("elitekv"):      # [L, B, S, ...]: the sequence sharded
        seq_axis = "model" if DECODE[case][1] > 1 else "data"
        pl = got["placements"]["p0/k_e"]
        assert pl[("data", "model").index(seq_axis)] == 2, pl


@pytest.mark.parametrize("case", list(DECODE))
def test_sharded_decode_collectives_equal_the_fake_trace_and_do_not_grow_with_S(case, runs):
    at_s, at_2s = runs["decode_traces"][case]
    want = {k: v["count"] for k, v in at_s.items() if v["count"]}
    assert all(counts == want for counts in runs["decode"][case]["counts"]), want
    assert at_s == at_2s                  # counts and bytes: nothing sends the cache
    if case.startswith("elitekv"):        # per layer at least the merge's max and sum
        assert want["all-reduce"] >= 2 * 2 and want["all-gather"] >= 1


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


def _piece(t, placements, mesh):
    """This rank's piece of ``t`` as a ``DTensor`` placed by ``placements``."""
    from torch.distributed.tensor import DTensor
    local = shd.local_shard(t, shd.Sharding(mesh, tuple(placements)))
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=t.shape,
                              stride=t.stride())


@pytest.mark.parametrize("lanes", [4, 1], ids=["seq_over_model", "seq_over_data"])
def test_sequence_sharded_decode_wrapper_at_every_shard(lanes, monkeypatch):
    """``ops.elite_decode`` on ``DTensor``s whose cache sequence is sharded
    (over "model" of a 2 × 2 mesh at B 4; over "data" at B 1, the query
    heads over "model" reading replicated kv heads) at each rank's
    coordinate: each rank attends its own rows with local lengths (a lane
    ending on the pieces' boundary, lanes with no row in a piece) and hands
    the two all-reduces its lse and ``[o·w | w]``; merged over the
    sequence's ranks by ``ref.merge_lse`` they give the unsharded plain
    call (rel 1e-6 of the largest)."""
    from torch.distributed.tensor import Replicate, Shard
    nh, nkv, r2, dc, Sq = 4, 2, 8, 16, 32
    g = torch.Generator().manual_seed(1)
    q_e, q_lat = torch.randn(lanes, nh, r2, generator=g), torch.randn(lanes, nh, dc, generator=g)
    k_e, c = torch.randn(lanes, Sq, nkv, r2, generator=g), torch.randn(lanes, Sq, dc, generator=g)
    lens = torch.tensor([32, 20, 16, 5][:lanes] if lanes > 1 else [20], dtype=torch.int32)
    G, scale = nh // nkv, 0.3
    want = ref.elite_decode_ref(q_e, q_lat, k_e, c, c, lens, G, scale)
    if lanes > 1:     # lanes over data, the sequence over model (the query whole
        # there: a fake group's gather would move no data)
        q_pl, c_pl, seq_dim = [Shard(0), Replicate()], [Shard(0), Shard(1)], 1
    else:             # the sequence over data, query heads over model
        q_pl, c_pl, seq_dim = [Replicate(), Shard(1)], [Shard(1), Replicate()], 0
    pieces = {}
    with fake_group(4, "cpu"):
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        for coord in [(d, m) for d in range(2) for m in range(2)]:
            _at_coordinate(monkeypatch, coord)
            sent = []
            monkeypatch.setattr(ops, "_all_reduce", lambda t, op, mesh, dim: sent.append(
                (op, dim, t)) or t)
            ops.reset_launches()
            o = ops.elite_decode(_piece(q_e, q_pl, mesh), _piece(q_lat, q_pl, mesh),
                                 _piece(k_e, c_pl, mesh), *[_piece(c, c_pl, mesh)] * 2,
                                 _piece(lens, [q_pl[0], Replicate()], mesh), G, scale)
            assert [(op, dim) for op, dim, _ in sent] == [("max", seq_dim), ("sum", seq_dim)]
            assert sum(ops.launches().values()) == 0          # plain versions on the CPU
            lse, sums = sent[0][2], sent[1][2]
            w = sums[..., -1]
            assert torch.equal(w, torch.isfinite(lse).float())  # its own max: 1 or 0
            other = coord[1 - seq_dim]                # the coordinate the pieces share
            pieces.setdefault(other, []).append((sums[..., :-1], lse))
            assert o.placements == tuple(p if i != seq_dim else Replicate()
                                         for i, p in enumerate(q_pl))
    for other, got in pieces.items():
        merged = ref.merge_lse(*zip(*got))
        part = (want.chunk(2, 0)[other] if lanes > 1 else want.chunk(2, 1)[other])
        ok, err = _close(merged, part, 1e-6)
        assert ok, (other, err)


@pytest.mark.parametrize("nkv,G,separate", [(2, 1, False), (1, 4, False), (2, 4, True)])
def test_decode_lse_matches_float64_and_pallas(nkv, G, separate):
    """The plain decode's ``return_lse``: o as without it, bitwise, and as
    the Pallas ``elite_decode`` in interpret mode; lse within 1e-6 of a
    float64 log-sum-exp of the masked scaled scores, -inf for a lane with no
    row."""
    rng = np.random.default_rng(3)
    Sq, r2, dc, scale = 24, 8, 32, 0.3
    lengths = np.asarray([0, 1, 5, Sq - 3, Sq, 9, Sq + 4], np.int32)
    B, nh = len(lengths), nkv * G
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q_e, q_lat, k_e, c_k = f(B, nh, r2), f(B, nh, dc), f(B, Sq, nkv, r2), f(B, Sq, dc)
    c_v = f(B, Sq, dc) if separate else c_k
    t = lambda a: torch.from_numpy(a)
    args = (t(q_e), t(q_lat), t(k_e), t(c_k), t(c_v) if separate else t(c_k), t(lengths),
            G, scale)
    o, lse = ops.elite_decode(*args, return_lse=True)
    assert torch.equal(o, ops.elite_decode(*args))
    want = np.asarray(jax_ed.elite_decode(
        *(jnp.asarray(a) for a in (q_e, q_lat, k_e, c_k, c_v, lengths)), G, scale,
        block_s=Sq, interpret=True))
    np.testing.assert_allclose(o.numpy(), want, atol=1e-5, rtol=1e-5)
    kv = np.repeat(np.arange(nkv), G)
    s64 = (np.einsum("bhr,bshr->bhs", q_e.astype(np.float64), k_e[:, :, kv].astype(np.float64))
           + np.einsum("bhc,bsc->bhs", q_lat.astype(np.float64), c_k.astype(np.float64)))
    s64 = np.where(np.arange(Sq)[None, None] < lengths[:, None, None], s64 * scale, -np.inf)
    top = s64.max(-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        lse64 = (top + np.log(np.exp(s64 - top).sum(-1, keepdims=True)))[..., 0]
    lse64 = np.where(lengths[:, None] > 0, lse64, -np.inf)
    np.testing.assert_allclose(lse.numpy(), lse64, atol=1e-6, rtol=0)
    assert np.isneginf(lse.numpy()[0]).all()


@pytest.mark.parametrize("separate", [False, True], ids=["jlrd", "slrd"])
def test_merge_lse_over_every_cut_matches_unsharded(separate):
    """``ref.merge_lse`` of the plain decode over every cut of S into two
    and three pieces (empty pieces included: a cut past a lane's length, a
    lane with no row) against the unsharded call, rel 1e-6 of the largest."""
    g = torch.Generator().manual_seed(4)
    nh, nkv, r2, dc, Sq = 8, 2, 8, 16, 12
    f = lambda *shape: torch.randn(shape, generator=g)
    lens = torch.tensor([0, 1, 5, 7, 12, 15], dtype=torch.int32)
    B = len(lens)
    q_e, q_lat, k_e, c_k = f(B, nh, r2), f(B, nh, dc), f(B, Sq, nkv, r2), f(B, Sq, dc)
    c_v = f(B, Sq, dc) if separate else c_k
    G, scale = nh // nkv, 0.4
    want = ref.elite_decode_ref(q_e, q_lat, k_e, c_k, c_v, lens, G, scale)
    cuts = [(a,) for a in range(Sq + 1)] + [(a, b) for a in range(Sq + 1)
                                            for b in range(a, Sq + 1)]
    for cut in cuts:
        bounds = (0,) + cut + (Sq,)
        os_, lses = [], []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if hi == lo:
                os_.append(torch.zeros(B, nh, dc))
                lses.append(torch.full((B, nh), -torch.inf))
                continue
            mine = (lens - lo).clamp(0, hi - lo).to(torch.int32)
            o, lse = ref.elite_decode_ref(q_e, q_lat, k_e[:, lo:hi], c_k[:, lo:hi],
                                          c_v[:, lo:hi], mine, G, scale, return_lse=True)
            os_.append(o)
            lses.append(lse)
        ok, err = _close(ref.merge_lse(os_, lses), want, 1e-6)
        assert ok, (cut, err)
    assert float(ref.merge_lse(os_, lses)[0].abs().max()) == 0.0     # no row: zeros


def test_baseline_decode_on_a_sequence_sharded_cache_raises():
    from repro_torch.models import attention
    cfg = get_config("tinyllama_1_1b").reduced(num_layers=2, vocab_size=256, n_heads=4,
                                               n_kv_heads=2)
    cell = dryrun.Cell(cfg, ShapeConfig("decode", S, B, "decode"), seq_over_tp=True)
    with fake_group(4, "cpu"):
        plan = dryrun.sharded_plan(shd.plan_for_mesh({"data": 2, "model": 2}, fsdp=False),
                                   "cpu")
        placed = dryrun.place_state(cell, plan, dryrun.cell_state(cell, "meta"))
        layer = {k: v[0] for k, v in placed["cache"]["blocks"]["p0"].items()}
        x = shd.distribute({"x": torch.empty(B, 1, cfg.d_model, device="meta")},
                           {"x": shd.Sharding(plan.mesh, shd.placements(("data",), plan))})
        with pytest.raises(ValueError, match="15c.3"):
            attention.apply_decode(placed["params"]["layers"][0]["attn"], cfg, x["x"], S - 1,
                                   layer)


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


@pytest.mark.parametrize("seq_tp", [True, False], ids=["seq_over_tp", "no_decode_seq_tp"])
def test_decode_record_traces_the_sharded_step(seq_tp):
    """The 16 × 16 decode cell (2 layers) traced sharded: temp, peak and
    collectives; with the cache sequence over "model" the query gather and
    the merge's two all-reduces per layer, and no collective that grows
    with the cache: the same bytes at twice the length."""
    recs = [dryrun.lower_cell("tinyllama_1_1b", "decode_32k", seq_len=n,
                              overrides={"num_layers": 2}, decode_seq_tp=seq_tp)
            for n in (4096, 8192)]
    dec = recs[0]
    mem = dec["memory"]
    assert dec["decode_seq_tp"] is seq_tp and not dec["fsdp"] and dec["flops_split"] is None
    assert mem["temp_bytes"] > 0 and mem["peak_estimate_bytes"] >= mem["argument_bytes"]
    assert dec["collective_bytes_per_device"] > 0 and "all-reduce" in dec["collectives"]
    assert {k: v["calls"] for k, v in dec["kernels"].items()} == {"elite_decode": 2,
                                                                   "rope_elite": 2}
    if seq_tp:     # embed, and per layer attn_out, ffn_out and the merge's max and sum
        assert dec["collectives"]["all-reduce"]["count"] == 1 + 4 * 2
        assert recs[1]["collectives"] == dec["collectives"]
    else:          # the latent (d_c over model) gathered: it grows with the cache
        assert recs[1]["collective_bytes_per_device"] > dec["collective_bytes_per_device"]


def test_moe_and_decode_records_stay_null_with_their_reasons():
    dec = dryrun.lower_cell("tinyllama_1_1b", "decode_32k", overrides={"num_layers": 2},
                            elitekv=False)
    assert dec["memory"]["peak_estimate_bytes"] is None
    assert "15c.3" in dec["memory"]["reason"] and "item 15" in dec["memory"]["reason"]
    assert dec["collectives"] == {} and dec["collective_bytes_per_device"] is None
    moe = dryrun.lower_cell("qwen3_moe_235b", "train_4k", batch=32, seq_len=64,
                            overrides={"num_layers": 1})
    assert moe["memory"]["temp_bytes"] is None
    assert "15d" in moe["memory"]["reason"] and "item 15" in moe["memory"]["reason"]
    moe_dec = dryrun.lower_cell("qwen3_moe_235b", "decode_32k", overrides={"num_layers": 1})
    assert moe_dec["memory"]["temp_bytes"] is None and "15d" in moe_dec["memory"]["reason"]


def test_no_process_group_is_left():
    assert not dist.is_initialized()
