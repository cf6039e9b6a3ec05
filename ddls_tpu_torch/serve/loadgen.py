"""Seeded, fingerprinted open-loop arrival traces.

Port: a copy of the trace half of ``ddls_tpu/serve/loadgen.py`` (:46-180):
``rate_at``, ``generate_trace``, ``trace_fingerprint`` and
``validate_trace``. The simulator replays a trace's arrivals as its job
interarrival distribution (``demands.distributions.LoadgenInterarrival``,
the scenario specs' ``arrival={"kind": "loadgen", ...}``). The SLO
accounting, the JSON helpers and the command line are not ported.

The arrival process is a non-homogeneous Poisson approximation
(interarrival ``Exp(1)/rate(t)`` at the current instant's rate) with
``rate(t) = base_rps * diurnal(t) * burst(t)``; sizes draw a Pareto tail
mapped into ``[0, 1)`` ranks; tenants draw from a 1/(k+1) zipf-ish
weighting. Everything is a pure function of the seed and the knobs: same
seed, same fingerprint, bit-same trace.
"""
from __future__ import annotations

import hashlib
import json
import math
from typing import Any, Dict

import numpy as np

TRACE_SCHEMA = "ddls_tpu.serve.trace/v1"

# knobs recorded in trace["meta"] and folded into the fingerprint; a new
# generator knob MUST be added here or two differently-shaped traces
# could fingerprint identically
_META_KEYS = ("seed", "n_requests", "base_rps", "diurnal_period_s",
              "diurnal_amplitude", "burst_factor", "burst_period_s",
              "burst_duty", "size_tail_alpha", "n_tenants")


def rate_at(t: float, base_rps: float, diurnal_period_s: float,
            diurnal_amplitude: float, burst_factor: float,
            burst_period_s: float, burst_duty: float) -> float:
    """Instantaneous offered rate: diurnal sinusoid times a periodic
    burst window (the first ``burst_duty`` fraction of every
    ``burst_period_s`` runs at ``burst_factor`` x)."""
    rate = base_rps
    if diurnal_amplitude and diurnal_period_s > 0:
        rate *= 1.0 + diurnal_amplitude * math.sin(
            2.0 * math.pi * t / diurnal_period_s)
    if burst_factor != 1.0 and burst_period_s > 0 and burst_duty > 0:
        if (t % burst_period_s) < burst_duty * burst_period_s:
            rate *= burst_factor
    return max(rate, 1e-9)


def generate_trace(n_requests: int, base_rps: float, seed: int = 0,
                   diurnal_period_s: float = 30.0,
                   diurnal_amplitude: float = 0.5,
                   burst_factor: float = 3.0,
                   burst_period_s: float = 10.0,
                   burst_duty: float = 0.2,
                   size_tail_alpha: float = 1.5,
                   n_tenants: int = 4) -> Dict[str, Any]:
    """One seeded open-loop trace. ``diurnal_amplitude=0`` and
    ``burst_factor=1`` degrade to a plain Poisson process at
    ``base_rps`` (what the bench's ``--load poisson`` fleet path uses,
    so poisson runs are fingerprinted through the same machinery)."""
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if base_rps <= 0:
        raise ValueError(f"base_rps must be > 0, got {base_rps}")
    if not 0.0 <= diurnal_amplitude < 1.0:
        raise ValueError("diurnal_amplitude must be in [0, 1) (a full "
                         "amplitude would zero the rate)")
    rng = np.random.RandomState(int(seed))
    arrivals = np.empty(n_requests, dtype=np.float64)
    t = 0.0
    for i in range(n_requests):
        lam = rate_at(t, base_rps, diurnal_period_s, diurnal_amplitude,
                      burst_factor, burst_period_s, burst_duty)
        t += rng.exponential(1.0 / lam)
        arrivals[i] = t
    # heavy-tailed size rank in [0, 1): Pareto(alpha) mapped through
    # 1 - 1/x — most requests small, a fat tail of near-max graphs
    u = rng.uniform(0.0, 1.0, size=n_requests)
    x = np.power(1.0 - u, -1.0 / float(size_tail_alpha))
    size_frac = 1.0 - 1.0 / x
    # zipf-ish tenant skew: w_k ∝ 1/(k+1)
    weights = 1.0 / (np.arange(int(n_tenants)) + 1.0)
    weights /= weights.sum()
    tenant_idx = rng.choice(int(n_tenants), size=n_requests, p=weights)
    meta = {"seed": int(seed), "n_requests": int(n_requests),
            "base_rps": float(base_rps),
            "diurnal_period_s": float(diurnal_period_s),
            "diurnal_amplitude": float(diurnal_amplitude),
            "burst_factor": float(burst_factor),
            "burst_period_s": float(burst_period_s),
            "burst_duty": float(burst_duty),
            "size_tail_alpha": float(size_tail_alpha),
            "n_tenants": int(n_tenants)}
    return {
        "schema": TRACE_SCHEMA,
        "meta": meta,
        "arrival_s": arrivals,
        "size_frac": size_frac,
        "tenant": [f"tenant-{int(k)}" for k in tenant_idx],
    }


def trace_fingerprint(trace: Dict[str, Any]) -> str:
    """Stable 16-hex-digit content fingerprint: meta knobs + the arrival
    / size arrays (rounded to ns / 1e-12 so the fingerprint survives
    JSON round-trips) + tenants. Two bench lines with equal fingerprints
    measured the identical offered load."""
    h = hashlib.sha256()
    meta = trace.get("meta") or {}
    h.update(json.dumps({k: meta.get(k) for k in _META_KEYS},
                        sort_keys=True).encode())
    h.update(np.round(np.asarray(trace["arrival_s"], dtype=np.float64),
                      9).tobytes())
    h.update(np.round(np.asarray(trace["size_frac"], dtype=np.float64),
                      12).tobytes())
    h.update("\x00".join(trace["tenant"]).encode())
    return h.hexdigest()[:16]


def validate_trace(trace: Dict[str, Any]) -> None:
    """Schema validator (the ``--selftest`` surface, also run by the
    bench before driving a trace): raises ``ValueError`` naming the
    first violated invariant."""
    if not isinstance(trace, dict):
        raise ValueError(f"trace must be a dict, got {type(trace)}")
    if trace.get("schema") != TRACE_SCHEMA:
        raise ValueError(f"unknown trace schema {trace.get('schema')!r} "
                         f"(expected {TRACE_SCHEMA!r})")
    meta = trace.get("meta")
    if not isinstance(meta, dict):
        raise ValueError("trace missing 'meta' dict")
    missing = [k for k in _META_KEYS if k not in meta]
    if missing:
        raise ValueError(f"trace meta missing keys {missing}")
    for key in ("arrival_s", "size_frac", "tenant"):
        if key not in trace:
            raise ValueError(f"trace missing {key!r}")
    arr = np.asarray(trace["arrival_s"], dtype=np.float64)
    size = np.asarray(trace["size_frac"], dtype=np.float64)
    tenants = trace["tenant"]
    n = int(meta["n_requests"])
    if not (arr.shape == size.shape == (n,)) or len(tenants) != n:
        raise ValueError(
            f"trace length mismatch: meta says {n}, arrays are "
            f"{arr.shape}/{size.shape}/{len(tenants)}")
    if not np.all(np.isfinite(arr)) or (n and arr[0] < 0):
        raise ValueError("arrival_s must be finite and non-negative")
    if np.any(np.diff(arr) < 0):
        raise ValueError("arrival_s must be non-decreasing (open-loop "
                         "schedule)")
    if not np.all(np.isfinite(size)) or np.any((size < 0) | (size >= 1)):
        raise ValueError("size_frac must lie in [0, 1)")
    if not all(isinstance(t, str) and t for t in tenants):
        raise ValueError("tenant entries must be non-empty strings")
