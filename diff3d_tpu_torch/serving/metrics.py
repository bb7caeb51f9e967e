"""Service metrics: counters, gauges and windowed histograms
(counterpart: ``diff3d_tpu/serving/metrics.py``, a copy).

Serving needs request-shaped metrics — queue depth, batch occupancy,
padding waste, time-to-first-view and end-to-end latency percentiles.
Everything here is host-side and thread-safe (the engine, the scheduler
and N HTTP handler threads all write concurrently); observing a metric
never touches the device.

Two exposition forms:
  * :meth:`MetricsRegistry.snapshot` — JSON-able nested dict (the
    ``/metrics?format=json`` and ``/stats`` endpoints);
  * :meth:`MetricsRegistry.exposition` — Prometheus-style text lines (the
    plain ``/metrics`` endpoint), counters/gauges as ``name value``,
    histograms as ``name{quantile="p50"} value`` plus ``_count``/``_sum``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, Optional

import numpy as np


class Counter:
    """Monotonic counter."""

    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._lock = threading.Lock()
        self._value = 0.0  # guarded-by: self._lock

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._lock = threading.Lock()
        self._value = 0.0  # guarded-by: self._lock

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, d: float) -> None:
        with self._lock:
            self._value += d

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Percentiles over a bounded window of observations.

    Keeps the last ``window`` samples (same retention policy as
    ``StepTimer``) plus lifetime ``count``/``sum`` — percentiles reflect
    recent behaviour, totals reflect the whole run.
    """

    def __init__(self, name: str, help_: str = "", window: int = 1024):
        self.name, self.help = name, help_
        self._lock = threading.Lock()
        self._window: Deque[float] = (
            deque(maxlen=window))  # guarded-by: self._lock
        self._count = 0  # guarded-by: self._lock
        self._sum = 0.0  # guarded-by: self._lock

    def observe(self, v: float) -> None:
        with self._lock:
            self._window.append(float(v))
            self._count += 1
            self._sum += float(v)

    def summary(self) -> dict:
        with self._lock:
            if not self._count:
                return {"count": 0, "sum": 0.0}
            vals = np.asarray(self._window)
            return {
                "count": self._count,
                "sum": self._sum,
                "mean": float(vals.mean()),
                "p50": float(np.percentile(vals, 50)),
                "p95": float(np.percentile(vals, 95)),
                "p99": float(np.percentile(vals, 99)),
                "max": float(vals.max()),
            }


class MetricsRegistry:
    """Named get-or-create registry for the three metric kinds."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}  # guarded-by: self._lock
        self._gauges: Dict[str, Gauge] = {}  # guarded-by: self._lock
        self._histograms: Dict[str, Histogram] = (
            {})  # guarded-by: self._lock

    def counter(self, name: str, help_: str = "") -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name, help_)
            return self._counters[name]

    def gauge(self, name: str, help_: str = "") -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name, help_)
            return self._gauges[name]

    def histogram(self, name: str, help_: str = "",
                  window: int = 1024) -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(name, help_, window)
            return self._histograms[name]

    def snapshot(self, extra: Optional[dict] = None) -> dict:
        """JSON-able snapshot of every registered metric."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        snap = {
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {n: g.value for n, g in sorted(gauges.items())},
            "histograms": {n: h.summary()
                           for n, h in sorted(hists.items())},
        }
        if extra:
            snap.update(extra)
        return snap

    def exposition(self) -> str:
        """Prometheus-style text form."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        lines = []
        for n, c in sorted(counters.items()):
            if c.help:
                lines.append(f"# HELP {n} {c.help}")
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {c.value:g}")
        for n, g in sorted(gauges.items()):
            if g.help:
                lines.append(f"# HELP {n} {g.help}")
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {g.value:g}")
        for n, h in sorted(hists.items()):
            s = h.summary()
            if h.help:
                lines.append(f"# HELP {n} {h.help}")
            lines.append(f"# TYPE {n} summary")
            for q in ("p50", "p95", "p99"):
                if q in s:
                    lines.append(f'{n}{{quantile="{q}"}} {s[q]:g}')
            lines.append(f"{n}_count {s['count']}")
            lines.append(f"{n}_sum {s['sum']:g}")
        return "\n".join(lines) + "\n"
