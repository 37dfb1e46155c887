"""The port's observability layer, held to the JAX package's.

* Units, on the port and the reference alike: the ring drops the oldest
  event, spans carry their args, a disabled tracer is inert, ``format_tail``
  names recent events, a counter rejects a decrease, histogram buckets are
  cumulative.
* Exports: the same operations give byte-identical Prometheus text and
  equal JSON, and Chrome trace JSON equal apart from timestamps.
* Device-timed entries (the port's own), with stand-in events: nothing is
  read when they are emitted; ``events()`` reads them once, from the anchor.
  The launch gate, with the card's calls faked: the stream waits, the
  launch is queued between its events, and the host always releases it.
* The traced ``Scheduler`` and ``PagedKVPool``: the ``(ph, name, track, cat,
  args)`` stream on the scheduler, slot and pool tracks equals the
  reference's (greedy, one-shot, preempted under recompute and under swap,
  prefix cache, int8 pool with sparse decode, greedy speculation; a pool op
  sequence with a COW copy), and so do the count-valued metrics.  The
  ``kernel`` track is the port's own: the reference's jitted path emits none.
* Tracing is passive: traced streams equal untraced ones (greedy and
  sampled) with no more reads of a tensor's value on the host, the
  artifacts pass ``tools/check_trace.py``, and ``diagnose trace-summary``
  prints the reference's text for the same file.
"""
import ctypes
import dataclasses
import importlib.util
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
from repro import obs as jax_obs
from repro.configs import get_config as jax_get_config
from repro.configs.base import EliteKVConfig
from repro.core import cache as jax_cache
from repro.runtime import serve_loop as jax_sl

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core.cache import BlockManager, OutOfBlocks, PagedKVPool
from repro_torch.kernels import build, ops
from repro_torch.obs.trace import DeviceDuration
from repro_torch.runtime import serve_loop
from test_torch_prefix_cache import shared_workload
from test_torch_sampling import sampled_requests
from test_torch_serve import port  # noqa: F401 (fixture)

_CHECK = Path(__file__).resolve().parent.parent / "tools" / "check_trace.py"
IMPLS = {"port": obs, "reference": jax_obs}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny shapes: threading only costs here
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def check_trace_mod():
    spec = importlib.util.spec_from_file_location("check_trace", _CHECK)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _key(ev):
    return ev.ph, ev.name, ev.track, ev.cat, ev.args


# ---------------------------------------------------------------------------
# units, on both implementations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", list(IMPLS))
def test_ring_drops_oldest(impl):
    tr = IMPLS[impl].Tracer(capacity=4)
    for i in range(10):
        tr.instant(f"e{i}")
    assert [e.name for e in tr.events()] == ["e6", "e7", "e8", "e9"]
    assert tr.emitted == 10 and tr.dropped == 6
    assert [e.name for e in tr.last(2)] == ["e8", "e9"] and tr.last(0) == []


@pytest.mark.parametrize("impl", list(IMPLS))
def test_span_nesting_and_args(impl):
    tr = IMPLS[impl].Tracer()
    with tr.span("outer", track="scheduler", cat="phase", lanes=2):
        with tr.span("inner", track="kernel", cat="kernel", shape="(2,3)"):
            pass
    inner, outer = tr.events()                     # appended at exit
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.ph == outer.ph == "X" and inner.track == "kernel"
    assert outer.ts <= inner.ts and inner.ts + inner.dur <= outer.ts + outer.dur
    assert inner.args_dict() == {"shape": "(2,3)"} and outer.arg("lanes") == 2
    assert outer.arg("missing", 7) == 7
    with pytest.raises(ValueError):
        with tr.span("raises"):
            raise ValueError
    assert tr.events()[-1].name == "raises"        # a span that raises still lands


@pytest.mark.parametrize("impl", list(IMPLS))
def test_disabled_tracer_is_inert(impl):
    null = IMPLS[impl].NULL_TRACER
    before = null.emitted
    null.instant("x")
    null.counter("c", 1)
    null.begin("b")
    null.end("b")
    with null.span("y"):
        pass
    assert null.emitted == before and null.events() == []
    assert "disabled" in null.format_tail(5)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_format_tail_mentions_recent_events(impl):
    tr = IMPLS[impl].Tracer(capacity=3)
    assert tr.format_tail(5) == "(no events recorded)"
    for i in range(5):
        tr.instant("admit", uid=i)
    tail = tr.format_tail(2)
    assert "last 2 of 5 events (2 dropped from the ring)" in tail
    assert "uid=4" in tail and "uid=2" not in tail


@pytest.mark.parametrize("impl", list(IMPLS))
def test_counter_rejects_decrease(impl):
    with pytest.raises(AssertionError):
        IMPLS[impl].MetricsRegistry().counter("x").inc(-1)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_histogram_buckets_are_cumulative(impl):
    m = IMPLS[impl].MetricsRegistry()
    h = m.histogram("step_ms", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0, 1.0):
        h.observe(v)
    assert h.cumulative() == [2, 3, 4] and h.count == 4 and h.sum == 56.5
    assert m.histogram("step_ms") is h
    with pytest.raises(AssertionError):
        m.gauge("step_ms")                         # a kind clash


def _metric_ops(mod):
    m = mod.MetricsRegistry()
    m.counter("serve_requests_total", "requests").inc(3)
    m.counter("serve_requests_total").inc(0.25)
    m.gauge("slots", "occupied slots").set(2)
    m.gauge("bytes").inc(1e12)
    m.gauge("neg").set(-1.5)
    h = m.histogram("serve_step_ms", "step wall ms")
    for v in (0.3, 2.5, 7.0, 99.9, 1e4, float("inf")):
        h.observe(v)
    m.histogram("tiny", buckets=(0.5, 1.5)).observe(1)
    return m


def test_prometheus_and_json_equal_the_reference():
    ours, theirs = _metric_ops(obs), _metric_ops(jax_obs)
    assert ours.to_prometheus() == theirs.to_prometheus()
    assert json.dumps(ours.to_json()) == json.dumps(theirs.to_json())
    assert ours.names() == theirs.names()
    assert obs.MetricsRegistry().to_prometheus() == ""


def _event_ops(tr):
    tr.begin("req0", track="slot0", cat="request", uid=0)
    tr.instant("alloc", track="pool", cat="pool", seq=0, blocks=[3, 2], length=7)
    tr.counter("pool_blocks_used", np.int64(5), track="pool")
    with tr.span("decode", track="scheduler", cat="phase", lanes=1):
        with tr.span("elite_decode_paged", track="kernel", cat="kernel", shape="(2, 4)"):
            pass
    tr.instant("free", track="pool", cat="pool", seq=np.int32(0), blocks=[3, 2],
               reason="release")
    tr.end("req0", track="slot0", cat="request", reason="budget")
    tr.begin("req1", track="slot10", cat="request", uid=1)
    tr.end("req1", track="slot10", cat="request", reason="eos")
    tr.begin("req2", track="slot2", cat="request", uid=2)
    tr.end("req2", track="slot2", cat="request", reason="eos")


def _untimed(doc):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in doc["traceEvents"]]


def test_chrome_trace_equals_the_reference(tmp_path, check_trace_mod):
    ours, theirs = obs.Tracer(), jax_obs.Tracer()
    _event_ops(ours)
    _event_ops(theirs)
    doc = obs.to_chrome_trace(ours)
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    assert _untimed(doc) == _untimed(jax_obs.to_chrome_trace(theirs))
    tids = {e["args"]["name"]: e["tid"] for e in doc["traceEvents"]
            if e["ph"] == "M" and e["name"] == "thread_name"}
    assert tids == {"scheduler": 0, "kernel": 1, "pool": 2, "slot0": 3, "slot2": 4,
                    "slot10": 5}
    p = obs.write_chrome_trace(tmp_path / "t.json", ours)
    q = jax_obs.write_chrome_trace(tmp_path / "r.json", theirs)
    strip = lambda path: _untimed(json.loads(Path(path).read_text()))
    assert strip(p) == strip(q)
    assert check_trace_mod.main([str(p)]) == 0


# ---------------------------------------------------------------------------
# device-timed entries (stand-in events: a device clock in ms)
# ---------------------------------------------------------------------------

class FakeEvent:
    """A recorded device event at ``t`` ms that counts how often it is read."""

    def __init__(self, t):
        self.t, self.reads = t, 0

    def elapsed_time(self, other):
        self.reads += 1
        return other.t - self.t

    def synchronize(self):
        self.reads += 1


def test_device_spans_resolve_when_read(tmp_path, check_trace_mod):
    tr = obs.Tracer()
    anchor = FakeEvent(1000.0)
    tr.anchor(0, anchor, host_ts=2.0)
    assert tr.has_anchor(0) and not tr.has_anchor(1)
    evs = [FakeEvent(t) for t in (1010.0, 1010.5, 1010.5, 1011.0)]
    tr.device_span("rope_elite_qk", 0, evs[0], evs[1], shape="(8, 1, 32, 16)")
    tr.device_span("elite_decode_paged", 0, evs[2], evs[3], shape="(8, 32, 16)")
    a, b = FakeEvent(5.0), FakeEvent(5.25)
    with tr.span("swap_out", track="pool", cat="swap", seq=3, device_ms=DeviceDuration(a, b)):
        pass
    tr.instant("after", track="pool")
    assert anchor.reads == 0 and all(e.reads == 0 for e in evs + [a, b])   # nothing read yet
    assert tr.emitted == 4
    rope, dec, swap, after = tr.events()
    assert (rope.ts, rope.track, rope.cat) == (pytest.approx(2.010), "kernel", "kernel")
    assert rope.dur == pytest.approx(0.0005, abs=1e-8) and rope.arg("shape") == "(8, 1, 32, 16)"
    assert dec.ts == pytest.approx(2.0105)
    assert rope.ts + rope.dur < dec.ts              # tied events still nest
    assert swap.arg("device_ms") == 0.25 and swap.arg("seq") == 3
    assert after.name == "after"
    reads = anchor.reads
    assert tr.events()[0] == rope and anchor.reads == reads   # resolved once
    p = obs.write_chrome_trace(tmp_path / "t.json", tr)
    assert check_trace_mod.main([str(p)]) == 0


def test_device_entries_dropped_from_the_ring_are_never_read():
    tr = obs.Tracer(capacity=2)
    tr.anchor(0, FakeEvent(0.0), host_ts=0.0)
    first = FakeEvent(1.0)
    tr.device_span("flash_prefill", 0, first, FakeEvent(2.0))
    tr.instant("a")
    tr.instant("b")
    assert [e.name for e in tr.events()] == ["a", "b"] and tr.dropped == 1
    assert first.reads == 0


def test_launch_gate_orders_the_launch_and_always_releases(monkeypatch):
    """``build.launch`` with a tracer armed, with the card's calls faked:
    the stream waits for counter value k, then the start event, the launch
    and the end event are queued, then the host writes k — also when the
    entry returns a CUDA error or raises, which leave no span."""
    log = []
    stamps = iter(range(100, 10**6, 5))

    class Event(FakeEvent):
        def __init__(self, enable_timing=False):
            super().__init__(None)

        def record(self, stream=None):
            self.t = float(next(stamps))
            log.append("record")

    class Stream:
        cuda_stream = 1234

    host = ctypes.c_uint32(0)

    def wait(stream, addr, value, flags):
        log.append(("wait", stream, addr, value, flags))
        return 0

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(build, "_GATE", {"wait": wait, "addr": 77, "issued": 0, "host": host})
    tr = obs.Tracer()
    tr.anchor(None, FakeEvent(0.0), host_ts=1.0)    # a CPU tensor's device has index None
    monkeypatch.setattr(build, "TRACER", tr)
    first = torch.zeros(2, 3)

    def entry(*args):
        log.append(("launch", args, host.value))
        return 0

    build.launch("flash_prefill", entry, (5, 6), first)
    assert log == [("wait", 1234, 77, 1, 0), "record", ("launch", (5, 6, 1234), 0), "record"]
    assert host.value == 1
    (span,) = tr.events()
    assert (span.name, span.track, span.arg("shape")) == ("flash_prefill", "kernel", "(2, 3)")
    assert span.ts == pytest.approx(1.0 + 0.1) and span.dur == pytest.approx(0.005, abs=1e-8)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        build.launch("flash_prefill", lambda *a: 700, (), first)
    assert host.value == 2 and len(tr.events()) == 1

    def raising(*a):
        raise ctypes.ArgumentError("bad argument")
    with pytest.raises(ctypes.ArgumentError):
        build.launch("flash_prefill", raising, (), first)
    assert host.value == 3 and len(tr.events()) == 1


# ---------------------------------------------------------------------------
# the traced scheduler and pool against the reference
# ---------------------------------------------------------------------------

BASE = dict(max_slots=2, block_size=4, num_blocks=64, max_len=48, prefill_bucket=4,
            prefill_chunk_tokens=4)
REQS = dict(n=4, lo=8, hi=18, max_new=10, seed=3, spacing=0.5, temp=0.0)
CASES = {
    "greedy": (BASE, REQS),
    "oneshot": (dict(BASE, prefill_chunk_tokens=0), REQS),
    "recompute": (dict(BASE, num_blocks=9), REQS),
    "swap": (dict(BASE, num_blocks=9, eviction="swap"), REQS),
    "prefix-cache": (dict(BASE, num_blocks=10, prefix_cache=True), None),
    "int8-sparse": (dict(BASE, cache_dtype="int8", admission="watermark",
                         sparse_topk_blocks=1, sparse_recent_blocks=1), REQS),
    "speculative": (dict(BASE, speculate_k=2, draft_rank=16), REQS),
}


def _workload(mod, vocab, req_kw):
    if req_kw is None:
        return shared_workload(mod, vocab)
    return sampled_requests(mod, vocab, **req_kw)


def _traced_port(port, scfg_kw, req_kw, kernels=False, tracer=None):
    cfg, tp, tb = port
    tr = tracer or obs.Tracer()
    m = obs.MetricsRegistry()
    sched = serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(**scfg_kw),
                                 device="cpu", tracer=tr, metrics=m)
    if kernels:
        ops.set_kernel_tracer(tr)
    try:
        rep = sched.run(_workload(serve_loop, cfg.vocab_size, req_kw))
    finally:
        ops.set_kernel_tracer(None)
    return sched, rep, tr, m


_TIMED = ("serve_step_ms", "serve_ttft_ms")


def _counts(metrics):
    """The count-valued instruments of a registry's JSON: wall-time
    instruments keep only their observation counts."""
    out = {}
    for name, v in metrics.to_json().items():
        if name.startswith("serve_phase_"):
            continue
        out[name] = v["count"] if name in _TIMED else v
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_event_stream_and_metrics_equal_the_reference(case, tiny_elite_cfg,
                                                     tiny_elite_model, port):
    scfg_kw, req_kw = CASES[case]
    jtr, jm = jax_obs.Tracer(), jax_obs.MetricsRegistry()
    jsched = jax_sl.Scheduler(*tiny_elite_model, tiny_elite_cfg,
                              jax_sl.SchedulerConfig(**scfg_kw), tracer=jtr, metrics=jm)
    jrep = jsched.run(_workload(jax_sl, tiny_elite_cfg.vocab_size, req_kw))
    sched, rep, tr, m = _traced_port(port, scfg_kw, req_kw, kernels=True)

    want = [_key(e) for e in jtr.events()]
    got = [_key(e) for e in tr.events() if e.track != "kernel"]
    assert len(got) == len(want)
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    assert first is None, f"event {first}: port {got[first]} vs reference {want[first]}"
    assert _counts(m) == _counts(jm)
    assert rep.trace_events == tr.emitted and rep.trace_dropped == 0
    assert {r.uid: r.generated for r in sched.finished} == \
        {r.uid: r.generated for r in jsched.finished}
    names = {e[1] for e in got}
    assert {"submit", "admit", "first_token", "retire", "alloc", "free"} <= names
    expect = {"recompute": {"preempt"}, "swap": {"preempt", "swap_out", "swap_in"},
              "prefix-cache": {"prefix_hit", "prefix_miss", "prefix_register", "share",
                               "retain"},
              "int8-sparse": {"sparse_select"}, "speculative": {"draft", "verify", "accept"},
              }.get(case, set())
    assert expect <= names, expect - names
    # the kernel track: one span per plain call, rope_elite_qk once per layer and forward
    kern = [e for e in tr.events() if e.track == "kernel"]
    forwards = rep.prefill_chunks + rep.decode_steps + rep.draft_forwards
    L = port[0].num_layers
    assert sum(e.name == "rope_elite_qk" for e in kern) == L * forwards
    assert sum(e.name == "flash_prefill" for e in kern) == L * rep.prefill_chunks
    decode = {"int8-sparse": "elite_decode_sparse_paged_q8",
              "speculative": "elite_verify_paged"}.get(case, "elite_decode_paged")
    assert sum(e.name == decode for e in kern) == L * rep.decode_steps
    assert all(e.cat == "kernel" and e.arg("shape").startswith("(") for e in kern)


def _pool_cfgs():
    jcfg = dataclasses.replace(
        jax_get_config("tinyllama_1_1b").reduced(num_layers=2, vocab_size=64),
        elitekv=EliteKVConfig(enabled=True, elite_r=2, d_ckv=8))
    cfg = get_config("tinyllama_1_1b").reduced(num_layers=2, vocab_size=64).with_elitekv(
        elite_r=2, d_ckv=8)
    return jcfg, cfg


def _pool_script(pool, bm):
    """Share, copy on write, retain, reclaim, truncate and swap: the pool's
    every event."""
    toks = np.arange(12, dtype=np.int32)
    bm.grow(0, 12)
    bm.register_prefix(0, toks)
    assert bm.lookup_prefix(1, toks) == 8             # two blocks shared
    bm.prepare_write(1, 4, 8)                         # a write into shared block 1
    bm.grow(1, 10)
    bm.truncate(1, 6)
    bm.release(0)                                     # cached blocks are retained
    bm.grow(2, 20)                                    # reclaims retained blocks
    swapped = bm.preempt_swap_out(2, 18)
    bm.swap_in(3, swapped)
    for sid in (1, 3):
        bm.release(sid)
    return pool.cow_copies


def test_pool_event_stream_with_a_cow_equals_the_reference():
    jcfg, cfg = _pool_cfgs()
    jtr, tr = jax_obs.Tracer(), obs.Tracer()
    jpool = jax_cache.PagedKVPool(jcfg, 8, 4, tracer=jtr)
    pool = PagedKVPool(cfg, 8, 4, device="cpu", tracer=tr)
    assert _pool_script(jpool, jax_cache.BlockManager(jpool, prefix_cache=True)) \
        == _pool_script(pool, BlockManager(pool, prefix_cache=True)) == 1
    got, want = [_key(e) for e in tr.events()], [_key(e) for e in jtr.events()]
    assert got == want
    names = [e[1] for e in got]
    for name in ("alloc", "free", "retain", "share", "cow", "prefix_register",
                 "swap_out", "swap_in"):
        assert name in names, name
    assert any(e.arg("reason") == "reclaim" for e in tr.events() if e.name == "free")
    assert any(e.arg("reason") == "truncate" for e in tr.events() if e.name == "free")


# ---------------------------------------------------------------------------
# tracing is passive
# ---------------------------------------------------------------------------

# every way a tensor's value reaches the host (each waits for the card there)
_HOST_READS = ("item", "tolist", "__int__", "__float__", "__bool__", "numpy", "cpu")


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_traced_tokens_equal_untraced_with_no_more_host_reads(temp, port, monkeypatch):
    cfg, tp, tb = port
    scfg_kw = dict(BASE, num_blocks=9, eviction="swap")
    req_kw = dict(REQS, temp=temp)
    calls = {}
    for name in _HOST_READS:
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    plain = serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(**scfg_kw),
                                 device="cpu")
    plain_rep = plain.run(_workload(serve_loop, cfg.vocab_size, req_kw))
    untraced = dict(calls)
    calls.clear()
    sched, rep, tr, _ = _traced_port(port, scfg_kw, req_kw, kernels=True)
    assert calls == untraced and untraced
    assert {r.uid: r.generated for r in sched.finished} == \
        {r.uid: r.generated for r in plain.finished}
    assert rep.preemptions == plain_rep.preemptions > 0 and rep.swap_outs > 0
    assert plain_rep.trace_events == 0 and plain.trace is obs.NULL_TRACER
    assert rep.trace_events == tr.emitted > 0


def test_artifacts_pass_check_trace(tmp_path, port, check_trace_mod):
    for case in ("swap", "prefix-cache", "int8-sparse"):
        scfg_kw, req_kw = CASES[case]
        _, _, tr, m = _traced_port(port, scfg_kw, req_kw, kernels=True)
        t = obs.write_chrome_trace(tmp_path / f"{case}.json", tr)
        p = tmp_path / f"{case}.prom"
        p.write_text(m.to_prometheus())
        assert check_trace_mod.main([str(t), "--metrics", str(p)]) == 0, case


def test_trace_summary_prints_the_reference_text(tmp_path, port, capsys):
    jax.devices()                              # the backend is up before the import
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import diagnose as jax_diagnose   # sets XLA_FLAGS on import
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    from repro_torch.launch import diagnose
    _, _, tr, _ = _traced_port(port, *CASES["swap"], kernels=True)
    path = str(obs.write_chrome_trace(tmp_path / "t.json", tr))
    capsys.readouterr()
    diagnose.main(["trace-summary", path, "--top", "3"])
    ours = capsys.readouterr().out
    jax_diagnose.main(["trace-summary", path, "--top", "3"])
    assert ours == capsys.readouterr().out
    for part in ("phase time", "kernel spans", "swap traffic",
                 "requests (4 submitted, 4 retired)", "pool occupancy"):
        assert part in ours, part
    with pytest.raises(SystemExit):
        diagnose.main(["--arch", "tinyllama_1_1b"])


def test_did_not_drain_error_carries_the_event_tail(port):
    cfg, tp, tb = port
    tr = obs.Tracer()
    s = serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(**BASE),
                             device="cpu", tracer=tr)
    with pytest.raises(RuntimeError) as ei:
        s.run(_workload(serve_loop, cfg.vocab_size, dict(REQS, n=3)), max_steps=1)
    msg = str(ei.value)
    assert msg.startswith("scheduler did not drain in 1 steps")
    assert "uid=" in msg and "pool:" in msg
    assert "dropped from the ring" in msg and "submit" in msg
    s = serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(**BASE), device="cpu")
    with pytest.raises(RuntimeError) as ei:
        s.run(_workload(serve_loop, cfg.vocab_size, dict(REQS, n=2)), max_steps=1)
    assert "uid=" in str(ei.value) and "tracing disabled" in str(ei.value)


def test_serve_cli_writes_a_valid_trace_and_metrics(tmp_path, capsys, check_trace_mod):
    from repro_torch.launch import serve
    t, m = tmp_path / "out.json", tmp_path / "m.prom"
    rep = serve.main(["--reduced", "--elitekv", "--stream", "--device", "cpu",
                      "--requests", "3", "--rate", "1.0", "--max-slots", "2",
                      "--block-size", "4", "--num-blocks", "24", "--prompt-len", "8",
                      "--new-tokens", "4", "--prefill-chunk", "4", "--trace", str(t),
                      "--trace-capacity", "4096", "--metrics-out", str(m)])
    out = capsys.readouterr().out
    assert rep.completed == 3 and rep.trace_events > 0
    assert f"trace: {rep.trace_events} events" in out and "metrics: " in out
    assert build.TRACER is None                     # the kernel tracer is disarmed after
    assert check_trace_mod.main([str(t), "--metrics", str(m)]) == 0
    doc = json.loads(t.read_text())
    assert any(e.get("tid") == 1 and e["ph"] == "X" for e in doc["traceEvents"])   # kernel
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--elitekv", "--device", "cpu", "--trace", str(t)])


# ---------------------------------------------------------------------------
# property: every alloc event pairs with exactly one free (the reference's)
# ---------------------------------------------------------------------------

_OPS = st.lists(st.tuples(st.sampled_from(["grow", "free", "swap_out", "swap_in", "truncate"]),
                          st.integers(0, 3), st.integers(1, 40)),
                min_size=1, max_size=40)


@settings(max_examples=25, deadline=None)
@given(ops_=_OPS, num_blocks=st.integers(2, 8))
def test_every_alloc_event_has_one_free_event(ops_, num_blocks):
    """Arbitrary pool op interleavings on a traced pool: each block an
    ``alloc`` names is named by exactly one later ``free``."""
    tr = obs.Tracer()
    pool = PagedKVPool(_pool_cfgs()[1], num_blocks=num_blocks, block_size=4, device="cpu",
                       tracer=tr)
    bm = BlockManager(pool)
    swapped = {}
    for op, sid, tokens in ops_:
        try:
            if op == "grow":
                bm.grow(sid, tokens)
            elif op == "free":
                bm.release(sid)
            elif op == "swap_out":
                s = bm.preempt_swap_out(sid, pool.length(sid))
                if s is not None:
                    swapped[sid] = s
            elif op == "swap_in" and sid in swapped and not pool.block_table(sid):
                bm.swap_in(sid, swapped.pop(sid))
            elif op == "truncate":
                bm.truncate(sid, min(tokens, pool.length(sid)))
        except OutOfBlocks:
            pass
    for sid in list(pool._tables):
        bm.release(sid)
    live = set()
    for ev in tr.events():
        if ev.name == "alloc":
            blocks = set(ev.arg("blocks"))
            assert not blocks & live, "block allocated while still live"
            live |= blocks
        elif ev.name == "free":
            blocks = set(ev.arg("blocks"))
            assert blocks <= live, "freed a block no alloc event granted"
            live -= blocks
    assert not live, f"alloc events without a matching free: {live}"


def test_no_test_module_imports_the_reference_diagnose_at_collection():
    """``repro.launch.diagnose`` sets ``XLA_FLAGS`` to 512 host devices when
    imported; imported at a test module's top level it would reach every
    JAX test of the worker that collects it (``tests/test_distributed.py``
    asserts one device).  Port tests import it inside a test, after the
    backend is up."""
    top = re.compile(r"^(from repro\.launch import .*diagnose|import repro\.launch\.diagnose)",
                     re.M)
    here = Path(__file__).resolve().parent
    assert [p.name for p in sorted(here.glob("test_torch_*.py"))
            if top.search(p.read_text())] == []
