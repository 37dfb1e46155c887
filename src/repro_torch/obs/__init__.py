"""Serving observability, the counterpart of the JAX package's ``obs``.

Three independent pieces, stdlib-only so every layer of the stack can
depend on them without import cycles:

* ``trace``    — a low-overhead ring-buffer event tracer (spans, instants,
                 counters) the scheduler, block pool and kernel launchers
                 emit structured events into; spans timed on the card are
                 read when the trace is.
* ``metrics``  — a process-wide registry of counters / gauges / histograms
                 with Prometheus text-format and JSON export.
* ``timeline`` — export of the event stream as Chrome trace-event JSON,
                 viewable in Perfetto (https://ui.perfetto.dev), one track
                 per pool slot plus scheduler / pool / kernel tracks.
"""
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Event, Tracer
from repro_torch.obs.timeline import to_chrome_trace, write_chrome_trace

__all__ = ["Event", "Tracer", "NULL_TRACER", "MetricsRegistry", "REGISTRY",
           "to_chrome_trace", "write_chrome_trace"]
