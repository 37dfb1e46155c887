"""Fault tolerance & straggler mitigation for the training runtime.

The port's own copy of the JAX package's ``runtime/fault.py`` (pure Python
and numpy).

Mechanisms (single-process simulations of the multi-host patterns — the
abstractions are the deliverable, exercised by tests/test_torch_checkpoint.py):

  * ``FaultTolerantRunner`` — supervises a train loop; on failure (injected
    or real) it restarts from the last committed checkpoint.  Restart count,
    re-trained steps, and data-stream determinism are all observable.
  * ``HeartbeatMonitor`` — per-"host" heartbeat ages; hosts silent past the
    deadline are declared dead → triggers restart with survivors (elastic).
  * ``StragglerPolicy`` — tracks per-step/host durations; hosts persistently
    slower than ``threshold × median`` are flagged for eviction (at real
    scale this drives the re-mesh; here it feeds HeartbeatMonitor).
  * the checkpointer stores unsharded leaves, so a restart may resume on
    another device count (re-sharding itself is not ported yet).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class InjectedFault(RuntimeError):
    """Raised by fault-injection hooks (tests / chaos drills)."""


@dataclasses.dataclass
class HostState:
    last_beat: float
    durations: List[float] = dataclasses.field(default_factory=list)
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, hosts: int, deadline_s: float = 60.0, clock=time.monotonic):
        self.clock = clock
        self.deadline = deadline_s
        self.hosts: Dict[int, HostState] = {
            h: HostState(last_beat=clock()) for h in range(hosts)}

    def beat(self, host: int, duration_s: Optional[float] = None):
        st = self.hosts[host]
        st.last_beat = self.clock()
        if duration_s is not None:
            st.durations.append(duration_s)

    def dead_hosts(self) -> List[int]:
        now = self.clock()
        return [h for h, st in self.hosts.items()
                if st.alive and now - st.last_beat > self.deadline]

    def evict(self, host: int):
        self.hosts[host].alive = False

    @property
    def alive_hosts(self) -> List[int]:
        return [h for h, st in self.hosts.items() if st.alive]


class StragglerPolicy:
    """Flag hosts persistently slower than threshold × median step time."""

    def __init__(self, threshold: float = 1.5, window: int = 20, min_obs: int = 5):
        self.threshold = threshold
        self.window = window
        self.min_obs = min_obs

    def stragglers(self, monitor: HeartbeatMonitor) -> List[int]:
        recents = {h: st.durations[-self.window:]
                   for h, st in monitor.hosts.items() if st.alive}
        meds = {h: np.median(d) for h, d in recents.items() if len(d) >= self.min_obs}
        if len(meds) < 2:
            return []
        global_med = float(np.median(list(meds.values())))
        return [h for h, m in meds.items() if m > self.threshold * global_med]


class FaultTolerantRunner:
    """Run step_fn for num_steps with checkpoint/restart supervision.

    ``step_fn(state, step) -> state`` may raise; ``save_fn(state, step)``
    commits; ``restore_fn() -> (state, step) | None`` reloads.  Failures
    bounded by ``max_restarts``.
    """

    def __init__(self, step_fn, save_fn, restore_fn, ckpt_every: int,
                 max_restarts: int = 10,
                 fault_hook: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.fault_hook = fault_hook
        self.restarts = 0
        self.steps_replayed = 0

    def run(self, init_state, num_steps: int):
        state, start = init_state, 0
        restored = self.restore_fn()
        if restored is not None:
            state, start = restored
        step = start
        while step < num_steps:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                state = self.step_fn(state, step)
                step += 1
                if self.ckpt_every and step % self.ckpt_every == 0:
                    self.save_fn(state, step)
            except InjectedFault:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                restored = self.restore_fn()
                if restored is None:
                    state, step = init_state, 0
                else:
                    state, new_step = restored
                    self.steps_replayed += step - new_step
                    step = new_step
        return state, step
