"""Dependency-free metric primitives: counters, gauges, fixed-bucket
histograms with a trailing sample window, and a registry with snapshots.

Counterpart of ``ddls_tpu/telemetry/metrics.py:54-237, 397-697``, trimmed
to what serving reads (no spans, transfers or sinks yet). Every mutation
takes the metric's own lock; registry create-or-get takes the registry
lock. Histogram bucket counts, count, sum, min and max are exact over the
metric's lifetime; percentiles are exact over the trailing ``window``
samples.
"""
from __future__ import annotations

import bisect
import threading
from collections import deque
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

# geometric ~1-2.5-5 ladder from 10 us to 30 s
DEFAULT_LATENCY_BUCKETS_S: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0, 30.0)

# trailing-window size for exact percentiles: a long-lived process must
# not hold one float per observation ever made
DEFAULT_WINDOW = 8192


class Counter:
    """Monotonic event counter."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-value-wins instantaneous measurement."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value: Optional[float] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    @property
    def value(self) -> Optional[float]:
        return self._value


class Histogram:
    """Fixed-bucket histogram + trailing raw-sample window. ``buckets`` are
    ascending upper bounds (a sample lands in the first bucket whose bound
    it does not exceed; one overflow bucket catches the rest)."""

    __slots__ = ("name", "bounds", "_counts", "_count", "_sum", "_min",
                 "_max", "window", "_lock")

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
                 window: int = DEFAULT_WINDOW):
        self.name = name
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.bounds) + 1)  # + overflow
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self.window: Optional[deque] = (deque(maxlen=int(window))
                                        if window else None)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._counts[bisect.bisect_left(self.bounds, value)] += 1
            self._count += 1
            self._sum += value
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value
            if self.window is not None:
                self.window.append(value)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min(self) -> Optional[float]:
        return self._min

    @property
    def max(self) -> Optional[float]:
        return self._max

    def window_values(self) -> list:
        """Copy of the trailing window taken under the lock."""
        if self.window is None:
            return []
        with self._lock:
            return list(self.window)

    def percentile(self, q: float) -> Optional[float]:
        """Exact percentile over the trailing window; bucket-interpolated
        when no window exists."""
        vals = self.window_values()
        if vals:
            return float(np.percentile(
                np.asarray(vals, dtype=np.float64), q))
        if self._count:
            return percentile_from_bucket_counts(
                self.bounds, self._counts, q, lo=self._min, hi=self._max)
        return None

    def bucket_counts(self) -> Dict[str, int]:
        """Nonzero buckets only, keyed by upper bound ('+inf' overflow)."""
        out = {}
        for bound, n in zip(self.bounds, self._counts):
            if n:
                out[repr(bound)] = n
        if self._counts[-1]:
            out["+inf"] = self._counts[-1]
        return out

    def summary(self) -> Dict[str, Any]:
        if not self._count:
            return {"count": 0}
        return {
            "count": self._count,
            "sum": self._sum,
            "mean": self._sum / self._count,
            "min": self._min,
            "max": self._max,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "buckets": self.bucket_counts(),
        }


def percentile_from_bucket_counts(bounds: Sequence[float],
                                  counts: Sequence[int], q: float,
                                  lo: Optional[float] = None,
                                  hi: Optional[float] = None
                                  ) -> Optional[float]:
    """Walk the cumulative counts to the bucket holding rank
    ``q/100 * count`` and interpolate linearly between its bounds, clamped
    to the observed [lo, hi] when known."""
    total = int(sum(counts))
    if not total:
        return None
    target = (q / 100.0) * total
    cum = 0
    for i, n in enumerate(counts):
        if not n:
            continue
        if cum + n >= target:
            b_lo = bounds[i - 1] if i > 0 else (lo if lo is not None
                                                else 0.0)
            b_hi = (bounds[i] if i < len(bounds)
                    else (hi if hi is not None else bounds[-1]))
            if lo is not None:
                b_lo = max(b_lo, lo) if i == 0 else b_lo
            if hi is not None:
                b_hi = min(b_hi, hi)
            frac = (target - cum) / n
            return float(b_lo + (b_hi - b_lo) * min(max(frac, 0.0), 1.0))
        cum += n
    return float(bounds[-1] if hi is None else hi)


class Registry:
    """A named collection of metrics. Private instances are cheap and
    always-on: each server's stats use one, so concurrent servers never
    share counters."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
                  window: int = DEFAULT_WINDOW) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(
                    name, buckets=buckets, window=window)
            return h

    def histogram_items(self):
        with self._lock:
            return list(self._histograms.items())

    def counter_items(self):
        with self._lock:
            return [(n, c.value) for n, c in self._counters.items()]

    def event(self, kind: str, **fields) -> None:
        """A discrete occurrence, tallied as ``event.<kind>`` (plus
        ``event.<kind>.<phase>`` when a ``phase`` field is given)."""
        name = f"event.{kind}"
        self.counter(name).inc()
        phase = fields.get("phase")
        if phase is not None:
            self.counter(f"{name}.{phase}").inc()

    def snapshot(self) -> Dict[str, Any]:
        """JSON-friendly dump of every live metric; empty sections are
        omitted."""
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()
                      if g.value is not None}
            hists = dict(self._histograms)
        out: Dict[str, Any] = {}
        if counters:
            out["counters"] = counters
        if gauges:
            out["gauges"] = gauges
        hist_section = {n: h.summary() for n, h in hists.items() if h.count}
        if hist_section:
            out["histograms"] = hist_section
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters = {}
            self._gauges = {}
            self._histograms = {}


def aggregate_snapshots(snaps: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge ``Registry.snapshot()`` dicts into one fleet rollup. Exact
    merges only: counters and gauges sum, histogram count/sum/min/max and
    bucket counts add, and the merged percentiles come from bucket
    interpolation (trailing windows cannot be merged order-faithfully)."""
    counters: Dict[str, int] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Dict[str, Any]] = {}
    for snap in snaps:
        if not snap:
            continue
        for name, value in (snap.get("counters") or {}).items():
            counters[name] = counters.get(name, 0) + int(value)
        for name, value in (snap.get("gauges") or {}).items():
            if value is not None:
                gauges[name] = gauges.get(name, 0.0) + float(value)
        for name, summ in (snap.get("histograms") or {}).items():
            if not summ.get("count"):
                continue
            agg = hists.setdefault(name, {
                "count": 0, "sum": 0.0, "min": None, "max": None,
                "buckets": {}})
            agg["count"] += int(summ["count"])
            agg["sum"] += float(summ.get("sum", 0.0))
            for bound, n in (summ.get("buckets") or {}).items():
                agg["buckets"][bound] = (agg["buckets"].get(bound, 0)
                                         + int(n))
            for key, pick in (("min", min), ("max", max)):
                v = summ.get(key)
                if v is not None:
                    agg[key] = (v if agg[key] is None
                                else pick(agg[key], v))
    for agg in hists.values():
        agg["mean"] = agg["sum"] / agg["count"]
        bounds = sorted(float(b) for b in agg["buckets"] if b != "+inf")
        cnts = [agg["buckets"].get(repr(b), agg["buckets"].get(str(b), 0))
                for b in bounds]
        cnts.append(agg["buckets"].get("+inf", 0))
        for q in (50, 95, 99):
            agg[f"p{q}"] = percentile_from_bucket_counts(
                bounds, cnts, q, lo=agg["min"], hi=agg["max"])
    out: Dict[str, Any] = {}
    if counters:
        out["counters"] = counters
    if gauges:
        out["gauges"] = gauges
    if hists:
        out["histograms"] = hists
    return out
