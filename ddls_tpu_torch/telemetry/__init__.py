"""Telemetry of the port: the metric primitives serving reads, plus a
process-global registry (disabled by default) behind a gated event API.

Counterpart of ``ddls_tpu/telemetry/__init__.py``, trimmed to what the
serve stack and the simulator call: hot paths reach the global registry
only through ``record_event`` and ``inc``, which return at once while
telemetry is off.
"""
from __future__ import annotations

from ddls_tpu_torch.telemetry.metrics import (DEFAULT_LATENCY_BUCKETS_S,
                                              DEFAULT_WINDOW, Counter, Gauge,
                                              Histogram, Registry,
                                              aggregate_snapshots,
                                              percentile_from_bucket_counts)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry",
    "DEFAULT_LATENCY_BUCKETS_S", "DEFAULT_WINDOW",
    "percentile_from_bucket_counts", "aggregate_snapshots",
    "registry", "enabled", "enable", "disable", "record_event", "inc",
]

_GLOBAL = Registry(enabled=False)


def registry() -> Registry:
    """The process-global registry (for snapshots and tests)."""
    return _GLOBAL


def enabled() -> bool:
    return _GLOBAL.enabled


def enable() -> Registry:
    """Turn the global registry on (existing metrics are kept)."""
    _GLOBAL.enabled = True
    return _GLOBAL


def disable() -> None:
    _GLOBAL.enabled = False


def record_event(kind: str, **fields) -> None:
    if _GLOBAL.enabled:
        _GLOBAL.event(kind, **fields)


def inc(name: str, n: int = 1) -> None:
    if _GLOBAL.enabled:
        _GLOBAL.counter(name).inc(n)
