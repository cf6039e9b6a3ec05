"""Online policy serving on the card: bucketed padding + deadline
microbatching + one fixed-shape forward per bucket + heuristic degraded
mode, scaled out as a multi-replica fleet with routing and quotas.

Counterpart of ``ddls_tpu/serve`` (see docs/serving.md for the design).
Entry points:

* :class:`PolicyServer` — in-process request/response server;
* :class:`Router` / :class:`ReplicaSet` / :func:`build_fleet` — the
  multi-replica fleet (serve/fleet.py);
* :class:`ObsBucketer` / :func:`default_buckets` / :func:`fit_buckets`
  — (max_nodes, max_edges) bucket ladders;
* :class:`MicrobatchEngine` — flush-on-fill-or-deadline queueing;
* :func:`load_export` — an exported policy ``.npz`` -> model + params;
* ``python -m ddls_tpu_torch.serve`` — the stdin/JSON front end.
"""
from ddls_tpu_torch.serve.bucketing import (BucketOverflowError, BucketSpec,
                                            ObsBucketer, default_buckets)
from ddls_tpu_torch.serve.fleet import (FleetResponse, ReplicaSet, Router,
                                        TokenBucket, build_fleet,
                                        fit_buckets)
from ddls_tpu_torch.serve.microbatch import MicrobatchEngine, PendingRequest
from ddls_tpu_torch.serve.server import (DEFAULT_FALLBACK_DEGREE,
                                         BucketForward, PolicyServer,
                                         ServeResponse, ServeStats,
                                         load_export, resolve_device)

__all__ = [
    "BucketForward",
    "BucketOverflowError",
    "BucketSpec",
    "DEFAULT_FALLBACK_DEGREE",
    "FleetResponse",
    "MicrobatchEngine",
    "ObsBucketer",
    "PendingRequest",
    "PolicyServer",
    "ReplicaSet",
    "Router",
    "ServeResponse",
    "ServeStats",
    "TokenBucket",
    "build_fleet",
    "default_buckets",
    "fit_buckets",
    "load_export",
    "resolve_device",
]
