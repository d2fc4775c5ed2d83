"""Process-local metrics registry (a copy of the JAX package's
`obs/metrics.py`; pure Python).

Counters, gauges, and histograms keyed by dotted names, snapshotted into
the serve CLI's JSON output. Not a client for any metrics backend: a JSON
snapshot is the whole export story. Everything is thread-safe and cheap
enough to live on hot paths — a counter inc is one lock + add.

Conventions:
  * names are dotted lowercase (`serve.requests`);
  * counters count events, gauges record the latest value, histograms
    summarize a distribution as {count, mean, min, max, p50, p95};
  * `registry` is the process-wide instance; `MetricsRegistry()` gives
    tests and in-process callers an isolated one;
  * `snapshot()` returns a flat {name: number-or-dict} JSON-ready dict.
"""
from __future__ import annotations

import threading


class Counter:
    """Monotone event count."""

    def __init__(self) -> None:
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Latest-value metric (e.g. rounds executed by the most recent solve)."""

    def __init__(self) -> None:
        self.value: float | int | None = None

    def set(self, value) -> None:
        self.value = value

    def snapshot(self):
        return self.value


def _percentile(sorted_values: list[float], q: float) -> float:
    """Linear-interpolation percentile of an already-sorted list."""
    n = len(sorted_values)
    if n == 1:
        return sorted_values[0]
    pos = (q / 100.0) * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_values[lo] * (1.0 - frac) + sorted_values[hi] * frac


class Histogram:
    """Distribution summary; observations are retained in memory (the
    intended scale is control-plane events — requests, chunks, epochs —
    not per-token samples)."""

    def __init__(self) -> None:
        self._values: list[float] = []
        self._lock = threading.Lock()

    def observe(self, value) -> None:
        with self._lock:
            self._values.append(float(value))

    @property
    def count(self) -> int:
        return len(self._values)

    def percentile(self, q: float) -> float:
        with self._lock:
            if not self._values:
                raise ValueError("empty histogram has no percentiles")
            return _percentile(sorted(self._values), q)

    def snapshot(self) -> dict:
        with self._lock:
            if not self._values:
                return {"count": 0}
            values = sorted(self._values)
        return {
            "count": len(values),
            "mean": sum(values) / len(values),
            "min": values[0],
            "max": values[-1],
            "p50": _percentile(values, 50.0),
            "p95": _percentile(values, 95.0),
        }


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    Re-registering a name with a different metric type raises — a typo'd
    reuse must fail loudly, not silently fork the series."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, cls):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = cls()
            elif not isinstance(metric, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(metric).__name__}, "
                    f"not a {cls.__name__}"
                )
            return metric

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        """Flat {name: value} dict; histogram values are summary sub-dicts."""
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: metric.snapshot() for name, metric in items}

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


# The process-wide registry every instrumented module shares.
registry = MetricsRegistry()
