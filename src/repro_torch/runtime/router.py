"""Data-parallel replica router: one front end, N independent Schedulers.

The port's counterpart of the JAX package's ``runtime/router.py``.  The
router owns the global serving clock and ``N`` ``Scheduler`` replicas, each
on its own device or tensor-parallel mesh (``launch/mesh.py::replica_meshes``;
several replicas may share one device, as on one card or the CPU).  Replicas never
synchronize with each other.  Every global step it (1) routes due arrivals
to the least-loaded replica, (2) steps every replica once in lockstep, and
(3) reconciles the :class:`ReplicaBoard` admission ledger against the
schedulers' observed state — the same ledger the op-fuzz in
tests/test_torch_router.py drives directly.

Token streams are router-invariant: greedy decoding is deterministic and a
sampled token folds ``key(seed)`` with the request's token count
(``serve_loop.sample_tokens``), so a request's output does not depend on
which replica — or slot, or step — it lands on.  The merged streams equal
one ``Scheduler``'s (tests/test_torch_router.py on the CPU; on a card a
token may differ only where the single scheduler's is a near-tie, since
a lane's GEMM bits may depend on its neighbours).

Observability: each replica's tracer events keep their shape but move to
``r{i}:``-prefixed tracks (counters gain an ``r{i}_`` name prefix) through
:class:`ReplicaTracer`; kernel spans stay on the base tracer's ``kernel``
track.  The router adds ``route`` instants and per-replica occupancy
counters on the ``router`` track, and the shared metrics registry grows
the name-encoded ``serve_replica_{i}_*`` family (the registry has no labels
by design; tools/check_trace.py checks the family all or nothing).

``meshes`` gives each replica its own ``TPMesh`` (or None: one device), as
the reference's does; a replica's scheduler then shards its attention heads
over that mesh.  The port's own additions: ``devices`` places ``tp == 1``
replicas; either way replica ``i``'s weights live on its first device
(replicas on the params' device share its tensors, another device gets one
copy), and ``RouterReport.launches`` counts each replica's kernel launches
(the launch counters' change across that replica's steps).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime.serve_loop import Request, Scheduler, SchedulerConfig, ServeReport
from repro_torch.tree import map_tree

REPLICA_METRIC_SUFFIXES = (
    "submitted_total",   # requests routed to this replica
    "completed_total",   # requests finished on this replica
    "waiting",           # gauge: queue depth after the last step
    "resident",          # gauge: occupied slots after the last step
    "blocks_used",       # gauge: pool blocks in use after the last step
)


class ReplicaBoard:
    """Pure per-replica admission ledger: the router's routing state.

    Requests move ``route → waiting → (admit) → resident → (retire)`` with
    ``preempt`` bouncing resident back to waiting.  The conservation law

        sum(waiting) + sum(resident) == submitted - retired

    holds after every operation; :meth:`check` asserts it (the router calls
    it each global step after reconciling the schedulers' observed deltas,
    so a bookkeeping leak fails loudly in serving, not only under test).
    """

    def __init__(self, n: int):
        assert n >= 1, n
        self.n = n
        self.waiting = [0] * n
        self.resident = [0] * n
        self.routed = [0] * n        # lifetime admissions (imbalance metric)
        self.submitted = 0
        self.retired = 0

    def load(self, i: int) -> int:
        return self.waiting[i] + self.resident[i]

    def pick(self) -> int:
        """Least-loaded replica, lowest id on ties (deterministic)."""
        return min(range(self.n), key=lambda i: (self.load(i), i))

    def route(self, i: int) -> None:
        self.waiting[i] += 1
        self.routed[i] += 1
        self.submitted += 1

    def admit(self, i: int) -> None:
        assert self.waiting[i] > 0, (i, self.waiting)
        self.waiting[i] -= 1
        self.resident[i] += 1

    def preempt(self, i: int) -> None:
        assert self.resident[i] > 0, (i, self.resident)
        self.resident[i] -= 1
        self.waiting[i] += 1

    def retire(self, i: int) -> None:
        assert self.resident[i] > 0, (i, self.resident)
        self.resident[i] -= 1
        self.retired += 1

    def check(self) -> None:
        assert all(w >= 0 for w in self.waiting), self.waiting
        assert all(r >= 0 for r in self.resident), self.resident
        in_flight = sum(self.waiting) + sum(self.resident)
        assert in_flight == self.submitted - self.retired, \
            (self.waiting, self.resident, self.submitted, self.retired)

    def imbalance(self) -> float:
        """max/min lifetime admissions over the replicas that saw traffic
        (1.0 = perfectly even).  Replicas with none are left out: early in
        a run, or with fewer requests than replicas, some have legitimately
        not been routed to yet, and counting them made the metric inf.  No
        traffic anywhere reports 1.0, not 0/0."""
        active = [r for r in self.routed if r > 0]
        if not active:
            return 1.0
        return max(active) / min(active)


class ReplicaTracer:
    """Per-replica view of a shared Tracer: the same event stream, but
    tracks are prefixed ``r{i}:`` and counter names ``r{i}_``, so N
    replicas' timelines share one trace without colliding (diagnose
    trace-summary groups the ``r{i}_pool_blocks_used`` counters back into
    per-replica sparklines).  The clock, the device anchors and device
    spans (the ``kernel`` track) are the base tracer's, unprefixed."""

    def __init__(self, base, i: int):
        self._base = base
        self._p = f"r{i}"

    @property
    def enabled(self) -> bool:
        return self._base.enabled

    @property
    def emitted(self) -> int:
        return self._base.emitted

    @property
    def dropped(self) -> int:
        return self._base.dropped

    def _t(self, track: str) -> str:
        return f"{self._p}:{track}"

    def now(self) -> float:
        return self._base.now()

    def instant(self, name, track="scheduler", cat="event", **args):
        return self._base.instant(name, self._t(track), cat, **args)

    def begin(self, name, track="scheduler", cat="event", **args):
        return self._base.begin(name, self._t(track), cat, **args)

    def end(self, name, track="scheduler", cat="event", **args):
        return self._base.end(name, self._t(track), cat, **args)

    def span(self, name, track="scheduler", cat="span", **args):
        return self._base.span(name, self._t(track), cat, **args)

    def counter(self, name, value, track="scheduler", cat="counter"):
        return self._base.counter(f"{self._p}_{name}", value, self._t(track), cat)

    def anchor(self, device, event, host_ts: float) -> None:
        return self._base.anchor(device, event, host_ts)

    def has_anchor(self, device) -> bool:
        return self._base.has_anchor(device)

    def device_span(self, name, device, start, end, track="kernel", cat="kernel", **args):
        return self._base.device_span(name, device, start, end, track, cat, **args)

    def resolve(self) -> None:
        return self._base.resolve()

    def format_tail(self, n: int = 30) -> str:
        return self._base.format_tail(n)


@dataclasses.dataclass
class RouterReport:
    """Merged end-of-run view over every replica's ServeReport."""
    replicas: List[ServeReport]
    routed: List[int]                      # requests per replica
    completed: int = 0
    decoded_tokens: int = 0
    prefill_tokens: int = 0
    preemptions: int = 0
    wall_s: float = 0.0
    tok_per_s: float = 0.0                 # merged throughput (one wall clock)
    ttft_wall_p50_ms: float = 0.0          # percentiles over ALL requests
    ttft_wall_p95_ms: float = 0.0
    imbalance: float = 1.0                 # max/min routed (ReplicaBoard)
    # the port's own: each replica's kernel launches over the run
    launches: List[Dict[str, int]] = dataclasses.field(default_factory=list)

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    def summary(self) -> str:
        return (f"dp={self.n_replicas} completed={self.completed} "
                f"decoded={self.decoded_tokens} tok/s={self.tok_per_s:.1f} "
                f"ttft_ms p50/p95={self.ttft_wall_p50_ms:.0f}/"
                f"{self.ttft_wall_p95_ms:.0f} "
                f"routed={self.routed} imbalance={self.imbalance:.2f}")

    def per_replica_table(self) -> str:
        """One line per replica: admissions, phase breakdown, occupancy."""
        lines = []
        for i, (n, rep) in enumerate(zip(self.routed, self.replicas)):
            lines.append(f"  r{i}: routed={n} completed={rep.completed} "
                         f"decoded={rep.decoded_tokens} "
                         f"occ={rep.mean_occupancy:.2f} "
                         f"preempt={rep.preemptions} | {rep.phase_table()}")
        return "\n".join(lines)


def _to(tree, device: torch.device):
    return map_tree(lambda t: t.to(device) if torch.is_tensor(t) else t, tree)


class Router:
    """Front end over ``num_replicas`` independent Schedulers (see the
    module docstring).  ``meshes`` gives each replica's ``TPMesh`` (None
    for one device), ``devices`` each replica's device at ``tp == 1``;
    passing both is a ``ValueError``, and with neither every replica runs
    on the params' device.  Replica ``i``'s device (``devices[i]``) is its
    mesh's first.  Replicas there share ``params``/``buffers`` when it is
    the params' device; each other device gets one copy, made once and
    shared by the replicas there."""

    def __init__(self, params, buffers, cfg, scfg: SchedulerConfig,
                 num_replicas: int, devices: Optional[List[Any]] = None,
                 moe_impl: str = "ragged", tracer=None, metrics=None,
                 meshes: Optional[List[Any]] = None):
        assert num_replicas >= 1, num_replicas
        if devices is not None and meshes is not None:
            raise ValueError("pass the replicas' devices or their meshes, not both")
        home = lm.params_device(params)
        meshes = list(meshes) if meshes is not None else [None] * num_replicas
        if devices is None:
            devices = [home if m is None else m.devices[0] for m in meshes]
        assert len(devices) == len(meshes) == num_replicas, \
            (len(devices), len(meshes), num_replicas)
        devices = [torch.empty(0, device=d).device for d in devices]  # "cuda" → "cuda:0"
        self.devices = devices
        self.meshes = meshes
        self.trace = tracer or NULL_TRACER
        self.metrics = metrics or MetricsRegistry()
        self.scfg = scfg
        weights = {home: (params, buffers)}
        for d in devices:
            if d not in weights:
                weights[d] = (_to(params, d), _to(buffers, d))
        # replicas share the metrics registry: shared counters become fleet
        # totals, while the serve_replica_{i}_* family keeps the split
        self.replicas = [
            Scheduler(*weights[d], cfg, scfg, device=d, moe_impl=moe_impl,
                      tracer=ReplicaTracer(self.trace, i), metrics=self.metrics,
                      mesh=meshes[i])
            for i, d in enumerate(devices)]
        self.board = ReplicaBoard(num_replicas)
        self.t = 0
        self.launches = [collections.Counter() for _ in range(num_replicas)]
        self._m: List[Dict[str, Any]] = []
        for i in range(num_replicas):
            self._m.append({
                "submitted_total": self.metrics.counter(
                    f"serve_replica_{i}_submitted_total",
                    f"requests routed to replica {i}"),
                "completed_total": self.metrics.counter(
                    f"serve_replica_{i}_completed_total",
                    f"requests finished on replica {i}"),
                "waiting": self.metrics.gauge(
                    f"serve_replica_{i}_waiting",
                    f"replica {i} queue depth"),
                "resident": self.metrics.gauge(
                    f"serve_replica_{i}_resident",
                    f"replica {i} occupied slots"),
                "blocks_used": self.metrics.gauge(
                    f"serve_replica_{i}_blocks_used",
                    f"replica {i} pool blocks in use"),
            })

    def shard_devices(self) -> List[torch.device]:
        """Every replica's devices in replica and shard order: its mesh's,
        or its one device."""
        return [d for dev, m in zip(self.devices, self.meshes)
                for d in ((dev,) if m is None else m.devices)]

    # -- routing ------------------------------------------------------------
    def submit(self, req: Request) -> int:
        """Route one request to the least-loaded replica; returns its id."""
        i = self.board.pick()
        self.board.route(i)
        self.replicas[i].submit(req)
        self._m[i]["submitted_total"].inc()
        self.trace.instant("route", track="router", cat="request",
                           uid=req.uid, replica=i,
                           load=self.board.load(i) - 1)
        return i

    # -- lockstep serving loop ---------------------------------------------
    def _step_replica(self, i: int) -> bool:
        """Step replica ``i`` once on the global clock and reconcile the
        board: admit/preempt/retire counts are rebuilt from the scheduler's
        observable state deltas (waiting moves only by those three), so the
        ledger stays exact without hooks inside the scheduler."""
        rep = self.replicas[i]
        w0 = self.board.waiting[i]
        f0 = len(rep.finished)
        rep.t = self.t                       # lockstep: the router owns the clock
        n0 = ops.launches()
        s0 = time.perf_counter()
        before = rep._measured_phase_ms()
        alive = rep.step()
        # Scheduler.run's per-step wall accounting (the router drives step()
        # directly): residual host time lands in phase "other", so each
        # replica's sum(phase_ms) still equals its step_wall_ms_total
        dt_ms = (time.perf_counter() - s0) * 1e3
        rep._step_wall_ms_total += dt_ms
        other = max(0.0, dt_ms - (rep._measured_phase_ms() - before))
        rep._phase_ms["other"] += other
        rep._m_phase["other"].inc(other)
        for name, n in ops.launches().items():
            if n != n0[name]:
                self.launches[i][name] += n - n0[name]
        w1 = len(rep.waiting)
        r1 = sum(1 for s in rep.slots if s is not None)
        retires = len(rep.finished) - f0
        # only the net waiting flow (admits − preempts) is observable from
        # outside; applying it as all admits or all preempts lands the
        # ledger on the exact live state either way (asserted below)
        net = w0 - w1
        admits, preempts = (net, 0) if net >= 0 else (0, -net)
        for _ in range(admits):
            self.board.admit(i)
        for _ in range(preempts):
            self.board.preempt(i)
        for _ in range(retires):
            self.board.retire(i)
        assert self.board.waiting[i] == w1 and self.board.resident[i] == r1, \
            (i, self.board.waiting, self.board.resident, w1, r1)
        if retires:
            self._m[i]["completed_total"].inc(retires)
        used = rep.pool.allocator.num_used
        self._m[i]["waiting"].set(w1)
        self._m[i]["resident"].set(r1)
        self._m[i]["blocks_used"].set(used)
        self.trace.counter(f"replica{i}_blocks_used", used, track="router")
        self.trace.counter(f"replica{i}_resident", r1, track="router")
        return alive

    def run(self, requests: Optional[List[Request]] = None,
            max_steps: int = 100_000) -> RouterReport:
        pending = collections.deque(sorted(requests or [],
                                           key=lambda r: (r.arrival, r.uid)))
        t0 = time.perf_counter()
        steps = 0
        while True:
            while pending and pending[0].arrival <= self.t:
                self.submit(pending.popleft())
            alive = False
            for i in range(len(self.replicas)):
                alive |= self._step_replica(i)
            self.board.check()
            if not alive and not pending:
                break
            self.t += 1
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"router stuck after {max_steps} steps: "
                    f"pending={len(pending)} board={self.board.__dict__}")
        wall_s = time.perf_counter() - t0
        self.trace.resolve()                 # device-timed entries, read once
        return self.report(wall_s)

    # -- merged report ------------------------------------------------------
    def report(self, wall_s: float) -> RouterReport:
        reps = [r.report(wall_s) for r in self.replicas]
        fin = [req for r in self.replicas for req in r.finished]
        ttft_ms = [(req.first_token_wall - req.submit_wall) * 1e3 for req in fin]
        pct = lambda xs, q: float(np.percentile(xs, q)) if xs else 0.0
        decoded = sum(r.decoded_tokens for r in reps)
        return RouterReport(
            replicas=reps, routed=list(self.board.routed),
            completed=sum(r.completed for r in reps),
            decoded_tokens=decoded,
            prefill_tokens=sum(r.prefill_tokens for r in reps),
            preemptions=sum(r.preemptions for r in reps),
            wall_s=wall_s, tok_per_s=decoded / max(wall_s, 1e-9),
            ttft_wall_p50_ms=pct(ttft_ms, 50),
            ttft_wall_p95_ms=pct(ttft_ms, 95),
            imbalance=self.board.imbalance(),
            launches=[dict(c) for c in self.launches])

    def finished_tokens(self) -> Dict[int, List[int]]:
        """uid → generated tokens, merged across replicas (what is compared
        with a single scheduler's streams)."""
        out: Dict[int, List[int]] = {}
        for rep in self.replicas:
            for req in rep.finished:
                assert req.uid not in out, req.uid
                out[req.uid] = list(req.generated)
        return out
