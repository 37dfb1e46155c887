"""Low-overhead ring-buffer event tracer.

Counterpart of the JAX package's ``obs/trace.py``: the same ``Event``
records, the same ``Tracer`` (a fixed-capacity *ring buffer*, so a long
serving run keeps the most recent window of events instead of growing
without bound) and the same shared ``NULL_TRACER``.  Emission is a time read
plus an append on the host; it never touches a tensor, PRNG state or the
scheduler's decisions, so a traced run produces bit-identical tokens to an
untraced one (tests/test_torch_obs.py).

Event phases mirror the Chrome trace-event format the timeline exporter
targets:

* ``X`` — a *complete span* with a duration (``Tracer.span`` context manager)
* ``B`` / ``E`` — begin/end of a long-lived span (request residency in a slot)
* ``i`` — an instant event (submit, admit, alloc, free, preempt, …)
* ``C`` — a counter sample (pool blocks in use, occupied slots)

Every event carries a ``track`` — the timeline row it renders on:
``"scheduler"`` (phase spans), ``"pool"`` (block churn), ``"kernel"``
(opt-in launch spans), and ``"slot<i>"`` (per-slot request lifecycles).

Disabled tracers (``Tracer(enabled=False)`` or the shared ``NULL_TRACER``)
reduce every emit to one attribute check, so instrumented code paths need no
``if tracer:`` guards.

The port's own addition is values that live on the device.  A span timed by
two recorded CUDA events (``device_span``) or an argument holding such a
pair (``DeviceDuration``) is kept unread in the ring and turned into a plain
``Event`` in one place, ``resolve()``, which ``events()``, ``last()``, the
timeline export and the end of a scheduler run call — so nothing on the
serving path waits for the device.  A device span's ``ts`` comes from the
anchor of its device (``anchor``): an event recorded on the idle device at a
known host time, so ``ts = anchor_ts + anchor.elapsed_time(start)``.  The
module itself imports nothing but the standard library; the events are any
objects with ``elapsed_time`` and ``synchronize`` (``torch.cuda.Event``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterator, List, Tuple

#: Device spans end this many seconds early so that two launches whose
#: events tie on the device clock still nest on their track after the
#: exporter's rounding to nanoseconds.
_TIE_S = 2e-9


@dataclasses.dataclass(frozen=True)
class Event:
    """One trace record.  ``ts``/``dur`` are seconds relative to the
    tracer's origin (monotonic ``perf_counter`` clock)."""
    name: str
    ph: str                      # "X" | "B" | "E" | "i" | "C"
    ts: float
    track: str = "scheduler"
    cat: str = "event"
    dur: float = 0.0             # "X" only
    args: Tuple[Tuple[str, Any], ...] = ()

    def arg(self, key: str, default: Any = None) -> Any:
        for k, v in self.args:
            if k == key:
                return v
        return default

    def args_dict(self) -> Dict[str, Any]:
        return dict(self.args)


class DeviceDuration:
    """Milliseconds between two events recorded on one device's stream,
    read only when the trace is resolved."""
    __slots__ = ("start", "end")

    def __init__(self, start, end):
        self.start, self.end = start, end

    def resolve(self) -> float:
        self.end.synchronize()
        return self.start.elapsed_time(self.end)


class _Pending:
    """A ring entry whose ``Event`` needs device values: ``make()`` builds it
    once the device events have landed."""
    __slots__ = ("make",)

    def __init__(self, make):
        self.make = make


def _resolve_args(args: Tuple[Tuple[str, Any], ...]) -> Tuple[Tuple[str, Any], ...]:
    return tuple((k, v.resolve() if isinstance(v, DeviceDuration) else v)
                 for k, v in args)


class Tracer:
    """Bounded event recorder.  ``capacity`` is the ring size in events —
    older events are dropped once full (``dropped`` counts them), which
    bounds memory for arbitrarily long runs while keeping the recent window
    the stuck-scheduler diagnostics and the timeline export need."""

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        self.enabled = enabled
        self.capacity = capacity
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self.origin = time.perf_counter()
        self.emitted = 0                    # lifetime emits (≥ len(events()))
        self._pending = 0                   # unresolved entries emitted
        self._anchors: Dict[Any, Tuple[float, Any]] = {}

    # -- clock --------------------------------------------------------------
    def now(self) -> float:
        return time.perf_counter() - self.origin

    # -- emission -----------------------------------------------------------
    def _emit(self, ev) -> None:
        self._buf.append(ev)
        self.emitted += 1

    def instant(self, name: str, track: str = "scheduler",
                cat: str = "event", **args: Any) -> None:
        if not self.enabled:
            return
        self._emit(Event(name, "i", self.now(), track, cat,
                         args=tuple(args.items())))

    def counter(self, name: str, value: float, track: str = "scheduler",
                cat: str = "counter") -> None:
        if not self.enabled:
            return
        self._emit(Event(name, "C", self.now(), track, cat,
                         args=(("value", value),)))

    def begin(self, name: str, track: str = "scheduler",
              cat: str = "event", **args: Any) -> None:
        if not self.enabled:
            return
        self._emit(Event(name, "B", self.now(), track, cat,
                         args=tuple(args.items())))

    def end(self, name: str, track: str = "scheduler",
            cat: str = "event", **args: Any) -> None:
        if not self.enabled:
            return
        self._emit(Event(name, "E", self.now(), track, cat,
                         args=tuple(args.items())))

    @contextlib.contextmanager
    def span(self, name: str, track: str = "scheduler", cat: str = "span",
             **args: Any) -> Iterator[None]:
        """Time a block as one complete ("X") event.  The event is appended
        at *exit* (Chrome's complete-event convention: ``ts`` start + ``dur``),
        so a span that raises still records its duration.  An argument that
        is a ``DeviceDuration`` is read when the trace is resolved."""
        if not self.enabled:
            yield
            return
        t0 = self.now()
        try:
            yield
        finally:
            dur = self.now() - t0
            items = tuple(args.items())
            if any(isinstance(v, DeviceDuration) for _, v in items):
                self._pending += 1
                self._emit(_Pending(lambda: Event(name, "X", t0, track, cat, dur=dur,
                                                  args=_resolve_args(items))))
            else:
                self._emit(Event(name, "X", t0, track, cat, dur=dur, args=items))

    # -- device-timed spans (the port's own) ----------------------------------
    def anchor(self, device: Any, event, host_ts: float) -> None:
        """Tie ``device``'s clock to this tracer's: ``event`` was recorded
        on the idle device (right after a synchronize) at ``host_ts``."""
        self._anchors[device] = (host_ts, event)

    def has_anchor(self, device: Any) -> bool:
        return device in self._anchors

    def device_span(self, name: str, device: Any, start, end,
                    track: str = "kernel", cat: str = "kernel",
                    **args: Any) -> None:
        """One "X" event covering the device time from event ``start`` to
        event ``end`` (recorded on ``device``, which must have an anchor).
        Nothing is read now; ``resolve()`` computes ``ts`` and ``dur``."""
        if not self.enabled:
            return
        host_ts, ref = self._anchors[device]
        items = tuple(args.items())

        def make() -> Event:
            end.synchronize()
            t0 = host_ts + ref.elapsed_time(start) / 1e3
            t1 = host_ts + ref.elapsed_time(end) / 1e3
            return Event(name, "X", t0, track, cat, dur=max(0.0, t1 - t0 - _TIE_S),
                         args=_resolve_args(items))

        self._pending += 1
        self._emit(_Pending(make))

    def resolve(self) -> None:
        """Turn every entry that waits on device values into its ``Event``
        (waiting for the device events it reads)."""
        if not self._pending:
            return
        self._buf = collections.deque(
            (e.make() if isinstance(e, _Pending) else e for e in self._buf),
            maxlen=self.capacity)
        self._pending = 0

    # -- introspection ------------------------------------------------------
    @property
    def dropped(self) -> int:
        return self.emitted - len(self._buf)

    def events(self) -> List[Event]:
        self.resolve()
        return list(self._buf)

    def last(self, n: int) -> List[Event]:
        if n <= 0:
            return []
        return self.events()[-n:]

    def clear(self) -> None:
        self._buf.clear()
        self._pending = 0

    def format_tail(self, n: int = 30) -> str:
        """Human-readable last-``n`` events — attached to stuck-scheduler
        exceptions so the failure carries its own flight recorder."""
        if not self.enabled:
            return "(tracing disabled — pass a Tracer to the scheduler for "\
                   "an event tail here)"
        tail = self.last(n)
        if not tail:
            return "(no events recorded)"
        lines = [f"last {len(tail)} of {self.emitted} events "
                 f"({self.dropped} dropped from the ring):"]
        for ev in tail:
            args = " ".join(f"{k}={v}" for k, v in ev.args)
            lines.append(f"  [{ev.ts * 1e3:10.3f}ms] {ev.track:>10s} "
                         f"{ev.ph} {ev.name}" + (f" {args}" if args else ""))
        return "\n".join(lines)


#: Shared disabled tracer — the default for instrumented components, so
#: tracing costs one attribute check per emit site when nobody is listening.
NULL_TRACER = Tracer(capacity=1, enabled=False)
