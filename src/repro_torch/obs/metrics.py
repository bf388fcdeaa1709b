"""Process-wide MetricsRegistry: counters, gauges, histograms.

Twin of `repro/obs/metrics.py` (pure Python, copied as it is).

The recording helpers (`inc` / `gauge_set` / `observe`) are gated on one
module bool kept in sync by obs.core.enable/disable, so instrumented hot
paths pay a single flag check while telemetry is off.

Sharded/multi-host runs aggregate by *host-side* merge — `snapshot()` is
plain JSON-able data, and `merge_snapshots()` folds any number of per-host
snapshots into one (sum counters, max gauges, merge histogram moments) —
no collective, no device traffic, no participation of the kernels.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

_active = False                    # mirror of core._metrics_on


def set_active(on: bool) -> None:
    global _active
    _active = bool(on)


def active() -> bool:
    return _active


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    __slots__ = ("count", "total", "min", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricsRegistry:
    """Named counters/gauges/histograms behind one lock (cheap: the hot
    instrumented paths increment a handful of times per *dispatch*, not
    per element)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            return h

    def value(self, name: str, default: float = 0.0) -> float:
        """Current counter value (0.0 when never incremented)."""
        with self._lock:
            c = self._counters.get(name)
            return c.value if c is not None else default

    def gauge_value(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            g = self._gauges.get(name)
            return g.value if g is not None else default

    def snapshot(self) -> dict:
        """JSON-able copy of everything recorded so far."""
        with self._lock:
            return {
                "counters": {k: c.value
                             for k, c in sorted(self._counters.items())},
                "gauges": {k: g.value
                           for k, g in sorted(self._gauges.items())},
                "histograms": {
                    k: {"count": h.count, "total": h.total,
                        "min": h.min, "max": h.max}
                    for k, h in sorted(self._hists.items()) if h.count},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    def merge_snapshot(self, snap: dict) -> None:
        """Fold another host's snapshot into this registry (counters sum,
        gauges take the max — peak semantics — histograms merge moments)."""
        for k, v in (snap.get("counters") or {}).items():
            self.counter(k).inc(v)
        for k, v in (snap.get("gauges") or {}).items():
            g = self.gauge(k)
            g.set(max(g.value, v))
        for k, v in (snap.get("histograms") or {}).items():
            h = self.histogram(k)
            with self._lock:
                h.count += int(v.get("count", 0))
                h.total += float(v.get("total", 0.0))
                h.min = min(h.min, float(v.get("min", h.min)))
                h.max = max(h.max, float(v.get("max", h.max)))


REGISTRY = MetricsRegistry()


def inc(name: str, v: float = 1.0) -> None:
    """Increment a counter (no-op while metrics are disabled)."""
    if _active:
        REGISTRY.counter(name).inc(v)


def gauge_set(name: str, v: float) -> None:
    if _active:
        REGISTRY.gauge(name).set(v)


def observe(name: str, v: float) -> None:
    if _active:
        REGISTRY.histogram(name).observe(v)


def value(name: str, default: float = 0.0) -> float:
    return REGISTRY.value(name, default)


def gauge_value(name: str, default: float = 0.0) -> float:
    return REGISTRY.gauge_value(name, default)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()


def counter_delta(before: dict, after: Optional[dict] = None) -> dict:
    """after.counters - before.counters (after defaults to a fresh
    snapshot) — the benchmark harness stamps this per suite."""
    after = snapshot() if after is None else after
    b = before.get("counters") or {}
    return {k: v - b.get(k, 0.0)
            for k, v in (after.get("counters") or {}).items()
            if v != b.get(k, 0.0)}


def merge_snapshots(snaps: Iterable[dict]) -> dict:
    """Pure host-side merge of per-host snapshots: counters
    sum, gauges max (peak semantics), histogram moments combine. Returns
    one snapshot dict of the same shape."""
    merged = MetricsRegistry()
    for s in snaps:
        merged.merge_snapshot(s)
    return merged.snapshot()
