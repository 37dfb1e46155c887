"""Tensor-parallel serving: ``Scheduler(mesh=)``, ``Router(meshes=)``, the
launcher's ``--tp`` and ``sharded_check --tp/--parity``, on ``TPMesh``es
of CPU devices.

* The port's ``Scheduler`` at tp 2 and 4 against the JAX ``Scheduler``
  (``mesh=None``) on the conftest's 2-layer weights crossed by
  ``repro_torch.interop``: equal streams, completions and preemptions in
  ``plain`` and ``int8`` (the reference's own sharded wall holds its tp
  streams to its single-device ones).
* The port at tp 2 and 4 against the port at tp 1 in every scenario of
  ``runtime/sharded_check.py``, ``sampled`` included, and in sparse decode
  with swap eviction: equal streams and equal scheduling (preemptions,
  prefill chunks, decode steps), since the host bookkeeping is the same at
  every tp.
* Every logits row of a greedy run (prefill, decode, draft and verify
  forwards) at tp 2 bitwise equal to tp 1's.
* ``Router(meshes=)`` at tp 2 × dp 2 against one tp-1 ``Scheduler``.
* Per-device pool bytes shrink with tp (the reference's
  ``test_per_device_pool_bytes_shrink_with_tp``); ``sharded_check`` as a
  module; the launcher traced at ``--tp 2`` through ``tools/check_trace.py``.

On the CPU every shard runs the kernels' plain versions, whose bits for a
head do not depend on the other heads in the call, so everything is
compared exactly.
"""
import collections
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from repro.runtime import serve_loop as jax_sl

from repro_torch import interop, obs
from repro_torch.configs import get_config
from repro_torch.launch.mesh import TPMesh
from repro_torch.models import lm
from repro_torch.runtime import serve_loop, sharded_check
from repro_torch.runtime.router import Router

REPO = Path(__file__).resolve().parent.parent
SRC = str(REPO / "src")
SCENARIOS = list(sharded_check.SCENARIOS) + list(sharded_check.SAMPLED)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny shapes: threading only costs here
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """sharded_check's 2-layer model on the CPU: (cfg, params, buffers, prompts)."""
    return sharded_check.tiny_model("cpu")


@pytest.fixture(scope="module")
def runs(tiny):
    """``sharded_check.run_scenario`` at (scenario, tp), each run once."""
    cfg, params, buffers, prompts = tiny
    cache = {}

    def get(name, tp):
        if (name, tp) not in cache:
            cache[name, tp] = sharded_check.run_scenario(
                name, params, buffers, cfg, [TPMesh.on("cpu", tp)], prompts)
        return cache[name, tp]
    return get


def _scfg(mod, name, **kw):
    knobs, req = sharded_check.scenario_knobs(name)
    base = dict(max_slots=2, block_size=8, num_blocks=24, prefill_chunk_tokens=8,
                max_new_tokens=sharded_check.NEW_TOKENS)
    return mod.SchedulerConfig(**{**base, **knobs, **kw}), req


def _sched(tiny, scfg, tp):
    cfg, params, buffers, _ = tiny
    return serve_loop.Scheduler(params, buffers, cfg, scfg, mesh=TPMesh.on("cpu", tp))


# ---------------------------------------------------------------------------
# (a) against the JAX Scheduler

@pytest.fixture(scope="module")
def crossed(tiny_elite_cfg, tiny_elite_model):
    """The conftest's 2-layer weights (sharded_check's config) in both packages."""
    params, buffers = tiny_elite_model
    cfg = get_config("tinyllama_1_1b").reduced(
        num_layers=tiny_elite_cfg.num_layers, vocab_size=tiny_elite_cfg.vocab_size
    ).with_elitekv(elite_r=tiny_elite_cfg.elitekv.elite_r,
                   d_ckv=tiny_elite_cfg.elitekv.d_ckv)
    tp, tb = interop.from_reference(jax.tree.map(np.asarray, params),
                                    jax.tree.map(np.asarray, buffers),
                                    tiny_elite_cfg, device="cpu")
    return cfg, tp, tb


@pytest.fixture(scope="module")
def jax_runs(tiny_elite_cfg, tiny_elite_model, tiny):
    """The JAX ``Scheduler`` (one device) per scenario, each run once."""
    cache = {}

    def get(name):
        if name not in cache:
            scfg, req = _scfg(jax_sl, name)
            sched = jax_sl.Scheduler(*tiny_elite_model, tiny_elite_cfg, scfg, mesh=None)
            rep = sched.run([jax_sl.Request(
                uid=r.uid, prompt=list(r.prompt), max_new_tokens=r.max_new_tokens,
                arrival=r.arrival, temperature=r.temperature, top_p=r.top_p, seed=r.seed)
                for r in sharded_check.build_requests(tiny[3], **req)])
            cache[name] = ({r.uid: [int(t) for t in r.generated] for r in sched.finished},
                           rep)
        return cache[name]
    return get


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["plain", "int8"])
def test_tp_scheduler_matches_the_reference_scheduler(name, tp, crossed, jax_runs, tiny):
    want, jrep = jax_runs(name)
    cfg, params, buffers = crossed
    scfg, req = _scfg(serve_loop, name)
    sched = serve_loop.Scheduler(params, buffers, cfg, scfg, mesh=TPMesh.on("cpu", tp))
    assert sched.pool.tp == tp and len(sched.pool.pages["p0"]["k_e"]) == tp
    rep = sched.run(sharded_check.build_requests(tiny[3], **req))
    assert {r.uid: list(r.generated) for r in sched.finished} == want
    assert rep.completed == jrep.completed == sharded_check.N_REQUESTS
    assert rep.preemptions == jrep.preemptions


# ---------------------------------------------------------------------------
# (b) against the port's tp 1, every scenario

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", SCENARIOS)
def test_tp_streams_and_scheduling_equal_tp1(name, tp, runs):
    one, got = runs(name, 1), runs(name, tp)
    assert got["tokens"] == one["tokens"]
    assert len(one["tokens"]) == sharded_check.N_REQUESTS
    for key in ("completed", "preemptions", "prefill_chunks", "decode_steps"):
        assert got["report"][key] == one["report"][key], key


def _tight_run(tiny, name, tp):
    scfg, req = _scfg(serve_loop, name, num_blocks=8, block_size=4)
    sched = _sched(tiny, scfg, tp)
    rep = sched.run(sharded_check.build_requests(tiny[3], **req))
    return {r.uid: list(r.generated) for r in sched.finished}, rep


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["plain", "recompute"])
def test_tp_preempting_pool_equals_tp1(name, tp, tiny):
    """A pool that preempts (swap or recompute): the same evictions at
    every tp, and the same streams."""
    want, one = _tight_run(tiny, name, 1)
    got, rep = _tight_run(tiny, name, tp)
    assert got == want and len(want) == sharded_check.N_REQUESTS
    assert one.preemptions > 0
    assert (rep.preemptions, rep.swap_outs, rep.swap_ins, rep.prefill_chunks,
            rep.decode_steps) == (one.preemptions, one.swap_outs, one.swap_ins,
                                  one.prefill_chunks, one.decode_steps)
    if name == "plain":
        assert one.swap_outs > 0


# ---------------------------------------------------------------------------
# (c) sparse decode with swap eviction

def _sparse_run(tiny, tp):
    scfg = serve_loop.SchedulerConfig(
        max_slots=2, block_size=4, num_blocks=10, prefill_chunk_tokens=8,
        max_new_tokens=sharded_check.NEW_TOKENS, sparse_topk_blocks=1,
        sparse_recent_blocks=1, eviction="swap")
    sched = _sched(tiny, scfg, tp)
    rep = sched.run(sharded_check.build_requests(tiny[3]))
    return {r.uid: list(r.generated) for r in sched.finished}, rep


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_sparse_decode_with_swap_equals_tp1(tp, tiny):
    want, one = _sparse_run(tiny, 1)
    got, rep = _sparse_run(tiny, tp)
    assert got == want and len(want) == sharded_check.N_REQUESTS
    assert one.swap_outs > 0 and one.swap_ins > 0 and one.sparse_steps > 0
    assert (rep.swap_outs, rep.swap_ins, rep.preemptions, rep.decode_steps,
            rep.sparse_steps) == (one.swap_outs, one.swap_ins, one.preemptions,
                                  one.decode_steps, one.sparse_steps)


# ---------------------------------------------------------------------------
# (d) every logits row bitwise

def _logged_run(tiny, name, tp, monkeypatch):
    """A greedy run, every paged forward's logits kept in call order."""
    rows = []
    for fn in ("apply_prefill_paged", "apply_decode_paged", "apply_verify_paged"):
        real = getattr(lm, fn)

        def keep(*a, real=real, fn=fn, **k):
            out = real(*a, **k)
            rows.append((fn, out.clone()))
            return out
        monkeypatch.setattr(lm, fn, keep)
    scfg, req = _scfg(serve_loop, name)
    sched = _sched(tiny, scfg, tp)
    sched.run(sharded_check.build_requests(tiny[3], **req))
    monkeypatch.undo()
    return rows


@pytest.mark.parametrize("name", ["plain", "spec"])
def test_tp2_logits_rows_bitwise_tp1(name, tiny, monkeypatch):
    want = _logged_run(tiny, name, 1, monkeypatch)
    got = _logged_run(tiny, name, 2, monkeypatch)
    assert [f for f, _ in got] == [f for f, _ in want]
    kinds = collections.Counter(f for f, _ in want)
    assert kinds["apply_prefill_paged"] and kinds["apply_decode_paged"]
    if name == "spec":
        assert kinds["apply_verify_paged"]
    bad = [i for i, ((_, g), (_, w)) in enumerate(zip(got, want)) if not torch.equal(g, w)]
    assert not bad, bad


# ---------------------------------------------------------------------------
# (e) the router at tp 2 x dp 2

@pytest.mark.parametrize("name", ["plain", "prefix"])
def test_router_tp2_dp2_equals_one_scheduler(name, tiny, runs):
    cfg, params, buffers, prompts = tiny
    scfg, req = _scfg(serve_loop, name)
    meshes = [TPMesh.on("cpu", 2), TPMesh.on("cpu", 2)]
    router = Router(params, buffers, cfg, scfg, num_replicas=2, meshes=meshes)
    rep = router.run(sharded_check.build_requests(prompts, **req))
    want = runs(name, 1)["tokens"]
    assert {str(u): t for u, t in sorted(router.finished_tokens().items())} == want
    assert rep.completed == sum(rep.routed) == sharded_check.N_REQUESTS
    assert all(n > 0 for n in rep.routed)
    assert [r.pool.tp for r in router.replicas] == [2, 2]
    assert all(r.mesh is m and r.params is params for r, m in zip(router.replicas, meshes))
    assert router.shard_devices() == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="not both"):
        Router(params, buffers, cfg, scfg, num_replicas=2, meshes=meshes,
               devices=["cpu", "cpu"])


def test_scheduler_mesh_placement_rules(tiny):
    cfg, params, buffers, _ = tiny
    scfg, _ = _scfg(serve_loop, "plain")
    sched = serve_loop.Scheduler(params, buffers, cfg, scfg, device="cpu",
                                 mesh=TPMesh.on("cpu", 2))
    assert sched.device == torch.device("cpu") and sched.mesh.tp == 2
    with pytest.raises(ValueError, match="mesh's first device"):
        serve_loop.Scheduler(params, buffers, cfg, scfg, device="cpu",
                             mesh=TPMesh.on("meta", 2))
    with pytest.raises(ValueError, match="params live on"):
        serve_loop.Scheduler(params, buffers, cfg, scfg, mesh=TPMesh.on("meta", 2))
    with pytest.raises(ValueError, match="does not divide"):
        serve_loop.Scheduler(params, buffers, cfg, scfg, mesh=TPMesh.on("cpu", 3))


# ---------------------------------------------------------------------------
# (f) per-device pool bytes

def test_per_device_pool_bytes_shrink_with_tp(runs):
    b1, b2, b4 = (runs("plain", tp)["report"]["pool_bytes_per_token_per_device"]
                  for tp in (1, 2, 4))
    assert b1 > b2 > b4
    assert b4 >= b1 // 4
    assert b1 == runs("plain", 4)["report"]["pool_bytes_per_token"]


# ---------------------------------------------------------------------------
# (g) sharded_check as a module

def _module(*argv):
    env = dict(os.environ, OMP_NUM_THREADS="1",      # tiny shapes: one thread, as here
               PYTHONPATH=SRC + (os.pathsep + os.environ["PYTHONPATH"]
                                 if os.environ.get("PYTHONPATH") else ""))
    out = subprocess.run([sys.executable, "-m", "repro_torch.runtime.sharded_check", *argv],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


def test_sharded_check_module_tp2_equals_tp1(runs):
    two = _module("--tp", "2", "--device", "cpu", "--scenarios", "plain,spec")
    assert two["devices"] == ["cpu", "cpu"] and two["tp"] == 2
    for name in ("plain", "spec"):
        assert two["scenarios"][name]["tokens"] == runs(name, 1)["tokens"]
    parity = _module("--parity", "--device", "cpu")["parity"]
    assert set(parity) == {"decode_tp2", "decode_tp4", "verify_tp2", "decode_q8_tp2"}
    assert all(v is True for v in parity.values())


# ---------------------------------------------------------------------------
# (h) the launcher at --tp 2, traced

def test_launcher_tp2_traced_passes_check_trace(monkeypatch, capsys, tmp_path):
    from repro_torch.launch import serve
    monkeypatch.setattr(serve, "REGISTRY", obs.MetricsRegistry())   # keep the process's clean
    t, m = tmp_path / "tp2.json", tmp_path / "tp2.prom"
    argv = ["--stream", "--device", "cpu", "--reduced", "--elitekv", "--requests", "4",
            "--rate", "1.0", "--max-slots", "2", "--block-size", "4", "--num-blocks", "24",
            "--prompt-len", "8", "--new-tokens", "4", "--prefill-chunk", "4"]
    rep = serve.main(argv + ["--tp", "2", "--trace", str(t), "--metrics-out", str(m)])
    out = capsys.readouterr().out
    assert rep.completed == 4
    assert "stream [tp=2]: completed=4" in out
    assert "pool/device: 384B/token (global 512B/token, tp=2)" in out
    chk = subprocess.run([sys.executable, str(REPO / "tools" / "check_trace.py"), str(t),
                          "--metrics", str(m)], capture_output=True, text=True, timeout=120)
    assert chk.returncode == 0, chk.stdout + chk.stderr
    assert chk.stdout.strip().splitlines()[-1].startswith("OK")
    # each shard's attention call is one span on the kernel track
    spans = collections.Counter(e["name"] for e in json.loads(t.read_text())["traceEvents"]
                                if e.get("cat") == "kernel" and e.get("ph") == "X")
    layers = get_config("tinyllama_1_1b").reduced().num_layers
    assert spans["elite_decode_paged"] == 2 * layers * rep.decode_steps
    assert spans["flash_prefill"] == layers * rep.prefill_chunks
    # the same stream at tp 1
    monkeypatch.setattr(serve, "REGISTRY", obs.MetricsRegistry())
    one = serve.main(argv)
    capsys.readouterr()
    assert (one.completed, one.decode_steps, one.decoded_tokens) == \
        (rep.completed, rep.decode_steps, rep.decoded_tokens)
