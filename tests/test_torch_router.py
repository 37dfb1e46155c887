"""The port's data-parallel replica router against the JAX package's, and
against the port's own single ``Scheduler``.

* ``ReplicaBoard``: the reference's op-fuzz of the admission ledger over
  real block growth on each replica's own pool (the port's ``PagedKVPool``
  and ``BlockManager``), and its zero-routed ``imbalance`` regression.
* ``Router(dp=2)`` on the CPU against the reference ``Router`` with two
  replicas on its one CPU device, on the same 2-layer weights (crossed by
  ``repro_torch.interop``): equal streams, routing, completions and
  preemptions in the ``plain`` and ``int8`` scenarios.
* ``Router(dp=2)`` against one port ``Scheduler`` in every scenario of
  ``runtime/sharded_check.py`` and the sampled one: equal streams.
* Observability: the ``serve_replica_{i}_*`` family, ``tools/check_trace.py``
  on a routed trace (a subprocess), ``diagnose trace-summary``'s
  per-replica blocks; ``launch/mesh.py``'s placement rules at tp 1 and
  tp > 1; the launcher's ``--dp``/``--tp``; ``sharded_check`` as a module
  and in process at ``--tp 2`` and ``--parity``.

On the CPU every replica runs the kernels' plain versions, and a lane's
bits do not depend on its neighbours, so streams are compared exactly.
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
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
from repro.runtime import serve_loop as jax_sl
from repro.runtime.router import Router as JaxRouter

from repro_torch import interop, obs
from repro_torch.configs import get_config
from repro_torch.core.cache import BlockManager, OutOfBlocks, PagedKVPool
from repro_torch.launch import mesh
from repro_torch.runtime import serve_loop, sharded_check
from repro_torch.runtime.router import (REPLICA_METRIC_SUFFIXES, ReplicaBoard,
                                        ReplicaTracer, Router)

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


def _scfg(mod, name, **kw):
    knobs, req = sharded_check.scenario_knobs(name)
    base = dict(max_slots=2, block_size=8, num_blocks=24, prefill_chunk_tokens=8,
                max_new_tokens=sharded_check.NEW_TOKENS)
    return mod.SchedulerConfig(**{**base, **knobs, **kw}), req


def _serve_routed(tiny, name, dp=2, tracer=None, metrics=None, **kw):
    cfg, params, buffers, prompts = tiny
    scfg, req = _scfg(serve_loop, name, **kw)
    router = Router(params, buffers, cfg, scfg, num_replicas=dp,
                    devices=mesh.replica_devices(dp=dp, device="cpu"),
                    tracer=tracer, metrics=metrics)
    rep = router.run(sharded_check.build_requests(prompts, **req))
    return router, rep


# ---------------------------------------------------------------------------
# the admission ledger

_ROUTER_OPS = st.lists(
    st.tuples(st.sampled_from(["route", "admit", "retire", "preempt"]),
              st.integers(0, 3),            # replica index (mod n)
              st.integers(1, 12)),          # token count for admissions
    min_size=1, max_size=60)


@given(ops=_ROUTER_OPS, n=st.integers(2, 4), num_blocks=st.integers(2, 6))
@settings(max_examples=15, deadline=None)
def test_router_admission_ledger_conservation(ops, n, num_blocks):
    """Arbitrary route/admit/preempt/retire interleavings, every admission
    backed by real block growth on that replica's own pool, keep the
    ledger conserved after every op: the board mirrors the model queues
    replica by replica, ``pick`` returns a least-loaded replica, the
    imbalance stays finite and ≥ 1, and no pool leaks a block, even when an
    admission bounces off ``OutOfBlocks``."""
    cfg = get_config("tinyllama_1_1b").reduced(num_layers=2, vocab_size=64).with_elitekv(
        elite_r=2, d_ckv=8)
    board = ReplicaBoard(n)
    pools = [PagedKVPool(cfg, num_blocks=num_blocks, block_size=4, device="cpu")
             for _ in range(n)]
    bms = [BlockManager(p) for p in pools]
    waiting = [collections.deque() for _ in range(n)]
    resident = [dict() for _ in range(n)]    # uid -> tokens held
    uid = 0

    def check():
        board.check()
        imb = board.imbalance()
        assert imb == imb and imb != float("inf") and imb >= 1.0, imb
        for j in range(n):
            assert board.waiting[j] == len(waiting[j])
            assert board.resident[j] == len(resident[j])
            alloc = pools[j].allocator
            assert alloc.num_free + alloc.num_used == num_blocks
            owned = [b for sid in list(pools[j]._tables) for b in pools[j].block_table(sid)]
            assert len(owned) == len(set(owned)) == alloc.num_used

    for op, ridx, tokens in ops:
        i = ridx % n
        if op == "route":
            j = board.pick()
            assert board.load(j) == min(board.load(k) for k in range(n))
            board.route(j)
            waiting[j].append(uid)
            uid += 1
        elif op == "admit" and waiting[i]:
            u = waiting[i].popleft()
            try:
                bms[i].grow(u, tokens)
                board.admit(i)
                resident[i][u] = tokens
            except OutOfBlocks:
                bms[i].release(u)            # partial growth must roll back
                waiting[i].appendleft(u)     # still waiting, ledger untouched
        elif op == "retire" and resident[i]:
            u = next(iter(resident[i]))
            del resident[i][u]
            bms[i].release(u)
            board.retire(i)
        elif op == "preempt" and resident[i]:
            u = next(iter(resident[i]))
            del resident[i][u]
            bms[i].release(u)                # recompute-style full eviction
            board.preempt(i)
            waiting[i].append(u)
        check()

    for i in range(n):                       # drain: the ledger lands on zero
        while waiting[i]:
            waiting[i].popleft()
            board.admit(i)
            board.retire(i)
        for u in list(resident[i]):
            del resident[i][u]
            bms[i].release(u)
            board.retire(i)
    check()
    assert sum(board.waiting) + sum(board.resident) == 0
    assert board.submitted == board.retired == uid
    assert all(p.allocator.num_free == num_blocks for p in pools)


def test_router_imbalance_zero_routed_regression():
    """A replica that never saw a request does not make the imbalance inf:
    it covers replicas with traffic, and an idle board reports 1.0."""
    board = ReplicaBoard(3)
    assert board.imbalance() == 1.0
    board.route(0)
    assert board.imbalance() == 1.0
    board.route(0)
    board.route(1)                           # routed == [2, 1, 0]
    assert board.imbalance() == 2.0
    board.route(2)
    assert board.imbalance() == 2.0          # [2, 1, 1]


# ---------------------------------------------------------------------------
# streams

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


@pytest.mark.parametrize("name", ["plain", "int8"])
def test_router_matches_the_reference_router(name, tiny_elite_cfg, tiny_elite_model,
                                             crossed, tiny):
    """Two replicas in both packages on the same weights and requests: the
    same streams, routing, completions and preemptions, replica by replica."""
    prompts = tiny[3]
    scfg, req = _scfg(jax_sl, name)
    jrouter = JaxRouter(*tiny_elite_model, tiny_elite_cfg, scfg, num_replicas=2,
                        meshes=None)
    jrep = jrouter.run([jax_sl.Request(uid=r.uid, prompt=list(r.prompt),
                                       max_new_tokens=r.max_new_tokens, arrival=r.arrival,
                                       temperature=r.temperature, top_p=r.top_p,
                                       seed=r.seed)
                        for r in sharded_check.build_requests(prompts, **req)])
    cfg, tp, tb = crossed
    router, rep = _serve_routed((cfg, tp, tb, prompts), name)
    assert router.finished_tokens() == jrouter.finished_tokens()
    assert rep.routed == jrep.routed == [3, 3]
    assert rep.completed == jrep.completed == sharded_check.N_REQUESTS
    assert rep.preemptions == jrep.preemptions
    assert rep.imbalance == jrep.imbalance
    for mine, ref in zip(rep.replicas, jrep.replicas):
        assert (mine.completed, mine.preemptions, mine.decoded_tokens) == \
            (ref.completed, ref.preemptions, ref.decoded_tokens)
    for mine, ref in zip(router.replicas, jrouter.replicas):
        assert [r.uid for r in mine.finished] == [r.uid for r in ref.finished]


@pytest.mark.parametrize("name", SCENARIOS)
def test_router_streams_equal_one_scheduler(name, tiny):
    """The router's merged streams equal one Scheduler's in every scenario;
    each replica's ledger and phases add up."""
    cfg, params, buffers, prompts = tiny
    scfg, req = _scfg(serve_loop, name)
    sched = serve_loop.Scheduler(params, buffers, cfg, scfg, device="cpu")
    srep = sched.run(sharded_check.build_requests(prompts, **req))
    router, rep = _serve_routed(tiny, name)
    want = {r.uid: r.generated for r in sched.finished}
    assert router.finished_tokens() == want
    assert len(want) == rep.completed == srep.completed == sharded_check.N_REQUESTS
    assert sum(rep.routed) == sharded_check.N_REQUESTS and rep.n_replicas == 2
    assert rep.decoded_tokens == srep.decoded_tokens
    assert all(r.params is params for r in router.replicas)    # shared, not copied
    for r in rep.replicas:
        assert sum(r.phase_ms.values()) == pytest.approx(r.step_wall_ms_total)
    if name == "sampled":
        assert all(r.temperature == 0.8 for r in sched.finished)
    if name == "prefix":
        assert sum(r.prefix_cache_hits for r in rep.replicas) > 0
    if name == "spec":
        assert all(r.draft_proposed > 0 for r in rep.replicas)


def test_preempting_router_equals_one_scheduler(tiny):
    """A pool that preempts on every replica: still the single streams."""
    cfg, params, buffers, prompts = tiny
    for name in ("plain", "recompute"):
        scfg, req = _scfg(serve_loop, name, num_blocks=8, block_size=4)
        sched = serve_loop.Scheduler(params, buffers, cfg, scfg, device="cpu")
        srep = sched.run(sharded_check.build_requests(prompts, **req))
        router, rep = _serve_routed(tiny, name, num_blocks=8, block_size=4)
        assert router.finished_tokens() == {r.uid: r.generated for r in sched.finished}
        assert srep.preemptions > 0 and all(r.preemptions > 0 for r in rep.replicas)


# ---------------------------------------------------------------------------
# observability

def _traced(tiny, tmp_path):
    tr, metrics = obs.Tracer(), obs.MetricsRegistry()
    router, rep = _serve_routed(tiny, "plain", tracer=tr, metrics=metrics,
                                num_blocks=10, block_size=4)
    trace = obs.write_chrome_trace(tmp_path / "routed.json", tr)
    prom = tmp_path / "routed.prom"
    prom.write_text(metrics.to_prometheus())
    return router, rep, tr, metrics, trace, prom


def test_replica_metric_family_and_tracks(tiny, tmp_path):
    router, rep, tr, metrics, _, _ = _traced(tiny, tmp_path)
    for i in range(2):
        for suffix in REPLICA_METRIC_SUFFIXES:
            assert metrics.get(f"serve_replica_{i}_{suffix}") is not None, (i, suffix)
        assert metrics.get(f"serve_replica_{i}_submitted_total").value == rep.routed[i]
        assert metrics.get(f"serve_replica_{i}_completed_total").value == \
            rep.replicas[i].completed
        assert metrics.get(f"serve_replica_{i}_resident").value == 0
    assert metrics.get("serve_requests_submitted_total").value == sharded_check.N_REQUESTS
    events = tr.events()
    routes = [e for e in events if e.name == "route"]
    assert [e.arg("uid") for e in routes] == list(range(sharded_check.N_REQUESTS))
    assert all(e.track == "router" for e in routes)
    tracks = {e.track for e in events}
    assert {"r0:scheduler", "r1:scheduler", "r0:pool", "r1:pool", "router"} <= tracks
    assert not any(t in ("scheduler", "pool") for t in tracks)
    assert {e.name for e in events if e.ph == "C" and e.track == "r1:pool"} >= \
        {"r1_pool_blocks_used"}
    assert rep.preemptions > 0                # the trace covers evictions too
    # the ledger after the drain
    assert router.board.submitted == router.board.retired == sharded_check.N_REQUESTS


def test_routed_trace_passes_check_trace_and_diagnose(tiny, tmp_path, capsys):
    from repro_torch.launch import diagnose
    _, rep, _, _, trace, prom = _traced(tiny, tmp_path)
    out = subprocess.run([sys.executable, str(REPO / "tools" / "check_trace.py"),
                          str(trace), "--metrics", str(prom)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith("OK")
    capsys.readouterr()
    diagnose.main(["trace-summary", str(trace)])
    text = capsys.readouterr().out
    assert "== per-replica pool occupancy (2 replicas) ==" in text
    for i in range(2):
        assert f"r{i} [" in text and f"{rep.routed[i]} routed" in text
    assert f"routed={rep.routed} max/min=1.00" in text


def test_replica_tracer_forwards_to_the_base():
    """Clock, anchors, device spans (kept on the base ``kernel`` track) and
    resolve go to the base tracer unprefixed."""

    class _Ev:
        def __init__(self, ms):
            self.ms = ms

        def elapsed_time(self, other):
            return other.ms - self.ms

        def synchronize(self):
            pass

    base = obs.Tracer()
    rt = ReplicaTracer(base, 1)
    assert rt.now() <= base.now()
    rt.anchor(0, _Ev(0.0), 1.0)
    assert rt.has_anchor(0) and base.has_anchor(0) and not rt.has_anchor(1)
    rt.device_span("elite_decode_paged", 0, _Ev(2.0), _Ev(5.0), shape="(1,)")
    rt.instant("admit", uid=3)
    rt.counter("pool_blocks_used", 4)
    rt.resolve()
    span, inst, ctr = base.events()
    assert (span.track, span.cat, span.ts) == ("kernel", "kernel", pytest.approx(1.002))
    assert span.dur == pytest.approx(0.003, abs=1e-8)
    assert (inst.track, inst.name) == ("r1:scheduler", "admit")
    assert (ctr.track, ctr.name) == ("r1:scheduler", "r1_pool_blocks_used")
    assert rt.emitted == base.emitted == 3 and rt.dropped == 0 and rt.enabled


# ---------------------------------------------------------------------------
# placement, the launcher, sharded_check

def test_mesh_placement_rules(monkeypatch):
    assert mesh.replica_devices(dp=3, device="cpu") == [torch.device("cpu")] * 3
    assert mesh.serving_devices(dp=2, device="cuda:0") == [[torch.device("cuda", 0)]] * 2
    cpu = torch.device("cpu")
    assert mesh.serving_devices(tp=2, dp=1, device="cpu") == [[cpu, cpu]]
    assert [m.devices for m in mesh.replica_meshes(tp=2, dp=2, device="cpu")] == \
        [(cpu, cpu)] * 2
    with pytest.raises(ValueError, match="must be >= 1"):
        mesh.replica_devices(dp=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.replica_devices(dp=3) == [torch.device("cuda", i) for i in range(3)]
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert mesh.serving_devices(tp=2, dp=2) == [cuda[:2], cuda[2:]]
    assert [m.devices for m in mesh.replica_meshes(tp=4)] == [tuple(cuda)]
    with pytest.raises(ValueError, match=r"serving mesh needs 6 devices \(tp=2 x dp=3\) "
                                         r"but only 4 are visible"):
        mesh.serving_devices(tp=2, dp=3)
    with pytest.raises(ValueError, match=r"serving mesh needs 5 devices \(tp=1 x dp=5\) "
                                         r"but only 4 are visible"):
        mesh.replica_devices(dp=5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="needs 2 devices .* only 0 are visible"):
        mesh.replica_devices(dp=2, device="cuda")
    assert mesh.production_mesh_axes() == {"data": 16, "model": 16}
    assert mesh.production_mesh_axes(multi_pod=True) == {"pod": 2, "data": 16, "model": 16}


def test_launcher_serves_routed_and_refuses(monkeypatch, capsys, tmp_path):
    from repro_torch.launch import serve
    monkeypatch.setattr(serve, "REGISTRY", obs.MetricsRegistry())   # keep the process's clean
    t, m = tmp_path / "out.json", tmp_path / "m.prom"
    rep = serve.main(["--stream", "--dp", "2", "--device", "cpu", "--reduced", "--elitekv",
                      "--requests", "4", "--rate", "1.0", "--max-slots", "2",
                      "--block-size", "4", "--num-blocks", "24", "--prompt-len", "8",
                      "--new-tokens", "4", "--prefill-chunk", "4", "--trace", str(t),
                      "--metrics-out", str(m)])
    out = capsys.readouterr().out
    assert rep.completed == 4 and rep.n_replicas == 2 and sum(rep.routed) == 4
    assert "stream [tp=1 dp=2 devices=cpu,cpu]: dp=2 completed=4" in out
    assert "  r0: routed=" in out and "  r1: routed=" in out
    assert "serve_replica_1_blocks_used" in m.read_text()
    assert json.loads(t.read_text())["traceEvents"]
    base = ["--reduced", "--elitekv", "--device", "cpu"]
    for bad in (["--dp", "2"], ["--stream", "--dp", "0"], ["--stream", "--tp", "0"],
                ["--stream", "--tp", "3"]):          # 3 does not divide the 4 kv heads
        with pytest.raises(SystemExit):
            serve.main(base + bad)
    rep = serve.main(base + ["--stream", "--tp", "2", "--requests", "4", "--rate", "1.0",
                             "--max-slots", "2", "--block-size", "4", "--num-blocks", "24",
                             "--prompt-len", "8", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert rep.completed == 4
    assert "arch=tinyllama_1_1b stream [tp=2]: completed=4" in out
    assert "pool/device: 384B/token (global 512B/token, tp=2)" in out
    with pytest.raises(ValueError, match="item 15"):
        serve.main(base + ["--stream", "--moe-impl", "ep"])


def test_sharded_check_runs_tp_and_parity(capsys):
    one = sharded_check.main(["--device", "cpu"])
    two = sharded_check.main(["--tp", "2", "--device", "cpu"])
    assert two["devices"] == ["cpu", "cpu"] and two["tp"] == 2
    plain1, plain2 = one["scenarios"]["plain"], two["scenarios"]["plain"]
    assert plain2["tokens"] == plain1["tokens"]
    assert len(plain2["tokens"]) == sharded_check.N_REQUESTS
    assert plain2["report"]["pool_bytes_per_token_per_device"] < \
        plain1["report"]["pool_bytes_per_token_per_device"] == \
        plain1["report"]["pool_bytes_per_token"] == plain2["report"]["pool_bytes_per_token"]
    parity = sharded_check.main(["--parity", "--device", "cpu"])["parity"]
    assert parity == {"decode_tp2": True, "decode_tp4": True, "verify_tp2": True,
                      "decode_q8_tp2": True}
    capsys.readouterr()


def test_sharded_check_module_dp2_equals_dp1():
    env = dict(os.environ, OMP_NUM_THREADS="1",      # tiny shapes: one thread, as here
               PYTHONPATH=SRC + (os.pathsep + os.environ["PYTHONPATH"]
                                 if os.environ.get("PYTHONPATH") else ""))
    runs = {}
    for dp in (1, 2):
        out = subprocess.run([sys.executable, "-m", "repro_torch.runtime.sharded_check",
                              "--dp", str(dp), "--device", "cpu", "--scenarios", "plain,spec"],
                             capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        runs[dp] = json.loads(out.stdout)
    assert runs[2]["devices"] == ["cpu", "cpu"] and runs[1]["devices"] == ["cpu"]
    for name in ("plain", "spec"):
        one, two = runs[1]["scenarios"][name], runs[2]["scenarios"][name]
        assert two["tokens"] == one["tokens"] and len(one["tokens"]) == sharded_check.N_REQUESTS
        assert two["report"]["completed"] == one["report"]["completed"]
        assert sum(two["report"]["routed"]) == sharded_check.N_REQUESTS
        assert len(two["report"]["occupancy_per_replica"]) == 2
