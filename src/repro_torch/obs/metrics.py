"""Process-wide metrics registry.

Counterpart of the JAX package's ``obs/metrics.py``, line for line: the
same instruments and the same Prometheus text for the same operations.

Three instrument kinds, deliberately small:

* ``Counter``   — monotonically increasing total (``inc``)
* ``Gauge``     — last-written value (``set`` / ``inc``)
* ``Histogram`` — cumulative-bucket distribution (``observe``), Prometheus
                  ``le`` convention (each bucket counts observations ≤ bound,
                  ``+Inf`` bucket == total count)

``MetricsRegistry`` hands out instruments by name (idempotent — asking for
the same name returns the same instrument; asking with a different kind is
an error) and exports the whole registry as Prometheus text format
(``to_prometheus``) or JSON (``to_json``).  ``REGISTRY`` is the process-wide
default the serving CLI exports; tests and libraries create private
registries so runs never bleed into each other.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

#: Default histogram bounds (milliseconds-flavoured: serving step/TTFT times).
DEFAULT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                   1000.0, 2500.0, 5000.0)


class Counter:
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        assert amount >= 0, f"counter {self.name} cannot decrease ({amount})"
        self.value += amount

    def sample_lines(self) -> List[str]:
        return [f"{self.name} {_fmt(self.value)}"]

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.kind, "help": self.help, "value": self.value}


class Gauge:
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def sample_lines(self) -> List[str]:
        return [f"{self.name} {_fmt(self.value)}"]

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.kind, "help": self.help, "value": self.value}


class Histogram:
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        assert list(buckets) == sorted(buckets), "bucket bounds must ascend"
        self.name, self.help = name, help
        self.bounds: Tuple[float, ...] = tuple(buckets)
        self.bucket_counts = [0] * (len(self.bounds) + 1)  # last == +Inf
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        for i, b in enumerate(self.bounds):
            if value <= b:
                self.bucket_counts[i] += 1
        self.bucket_counts[-1] += 1          # +Inf catches everything

    def cumulative(self) -> List[int]:
        return list(self.bucket_counts)

    def sample_lines(self) -> List[str]:
        lines = []
        for b, c in zip(self.bounds, self.bucket_counts):
            lines.append(f'{self.name}_bucket{{le="{_fmt(b)}"}} {c}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {self.bucket_counts[-1]}')
        lines.append(f"{self.name}_sum {_fmt(self.sum)}")
        lines.append(f"{self.name}_count {self.count}")
        return lines

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.kind, "help": self.help, "count": self.count,
                "sum": self.sum,
                "buckets": {**{_fmt(b): c for b, c in
                               zip(self.bounds, self.bucket_counts)},
                            "+Inf": self.bucket_counts[-1]}}


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """Name → instrument map with Prometheus / JSON export."""

    def __init__(self):
        self._instruments: Dict[str, Any] = {}

    def _get(self, cls, name: str, help: str, **kwargs):
        assert _NAME_RE.match(name), f"invalid metric name {name!r}"
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(name, help, **kwargs)
        assert isinstance(inst, cls), \
            f"metric {name!r} already registered as {inst.kind}"
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[Any]:
        return self._instruments.get(name)

    def names(self) -> List[str]:
        return sorted(self._instruments)

    # -- export -------------------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition format, one HELP/TYPE block per
        instrument (tools/check_trace.py validates parseability)."""
        lines: List[str] = []
        for name in self.names():
            inst = self._instruments[name]
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            lines.append(f"# TYPE {name} {inst.kind}")
            lines.extend(inst.sample_lines())
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> Dict[str, Any]:
        return {name: self._instruments[name].to_json()
                for name in self.names()}


#: Process-wide default registry (`launch/serve.py --metrics-out` exports it).
REGISTRY = MetricsRegistry()
