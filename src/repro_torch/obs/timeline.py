"""Chrome trace-event JSON export of a ``Tracer``'s event stream.

Counterpart of the JAX package's ``obs/timeline.py``; exporting a tracer
resolves its device-timed entries first (``Tracer.events``).

The output loads directly in Perfetto (https://ui.perfetto.dev — "Open trace
file") or chrome://tracing: one process, one *thread track* per tracer track
— ``scheduler`` (phase spans), ``kernel`` (dispatch spans), ``pool`` (block
churn instants + occupancy counter), and one ``slot<i>`` row per scheduler
slot showing request residency spans.  Format reference:
https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU

Timestamps are microseconds from the tracer's origin (Chrome's convention);
counter events render as Perfetto counter tracks.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Iterable, List, Union

from repro_torch.obs.trace import Event, Tracer

#: Fixed thread ids for the well-known tracks (stable across runs so diffs
#: of two timelines line up); other tracks (slots) get ids after these.
_PINNED_TRACKS = ("scheduler", "kernel", "pool")


def _track_order(tracks: Iterable[str]) -> List[str]:
    rest = sorted(set(tracks) - set(_PINNED_TRACKS),
                  key=lambda t: (len(t), t))   # slot2 < slot10
    return [t for t in _PINNED_TRACKS] + rest


def to_chrome_trace(events: Union[Tracer, Iterable[Event]],
                    process_name: str = "elitekv-serve",
                    pid: int = 1) -> Dict[str, Any]:
    """Convert tracer events to a Chrome trace-event JSON object (the
    ``{"traceEvents": [...]}`` envelope form)."""
    if isinstance(events, Tracer):
        events = events.events()
    events = list(events)
    tids = {t: i for i, t in enumerate(_track_order(e.track for e in events))}

    out: List[Dict[str, Any]] = [
        {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
         "args": {"name": process_name}},
    ]
    for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        out.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                    "args": {"name": track}})
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_sort_index", "args": {"sort_index": tid}})

    for ev in events:
        rec: Dict[str, Any] = {
            "name": ev.name, "ph": ev.ph, "cat": ev.cat, "pid": pid,
            "tid": tids[ev.track], "ts": round(ev.ts * 1e6, 3),
        }
        if ev.ph == "X":
            rec["dur"] = round(ev.dur * 1e6, 3)
        if ev.ph == "i":
            rec["s"] = "t"                   # thread-scoped instant
        if ev.args:
            rec["args"] = ev.args_dict()
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path, events: Union[Tracer, Iterable[Event]],
                       process_name: str = "elitekv-serve") -> Path:
    """Serialize to ``path``; returns the path written."""
    path = Path(path)
    trace = to_chrome_trace(events, process_name=process_name)
    path.write_text(json.dumps(trace, default=_json_default), encoding="utf-8")
    return path


def _json_default(obj: Any) -> Any:
    """Event args may carry numpy scalars / arrays — coerce rather than fail
    (observability must never crash the run it is observing)."""
    if hasattr(obj, "item"):
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return str(obj)
