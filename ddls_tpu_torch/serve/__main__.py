"""Online policy-serving front end: JSON requests on stdin, decisions on
stdout (counterpart of ``scripts/serve_policy.py``).

    python -m ddls_tpu_torch.serve [--params export.npz] [--device cuda]

Each input line is one request::

    {"id": "job-17", "obs": {"node_features": [[...]], "edge_features":
     [[...]], "graph_features": [...], "edges_src": [...], "edges_dst":
     [...], "node_split": [n], "edge_split": [m], "action_set": [...],
     "action_mask": [...]}}

``obs`` is the encoded observation dict (any pad bound — the server
re-pads onto its buckets). Each answered request emits one line::

    {"id": "job-17", "action": 8, "source": "policy", "reason": "batched",
     "bucket": 1, "latency_ms": 3.2}

Requests route through the fleet ``Router`` into ``--replicas N``
PolicyServers (one by default), each microbatching per bucket, with the
``FixedDegreePacking`` fallback when the queue saturates, a graph fits no
bucket, or the forward fails. An optional ``tenant`` field feeds affinity
routing and, with ``--quota-rps``, per-tenant admission (quota sheds
answer ``action: null``, ``source: "shed"``). A summary JSON line lands on
stderr at EOF.

``--params`` is an export ``.npz`` (``scripts/export_torch_serve_fixture
.py``); it defaults to the shipped ``ppo_price_mixed``. ``--device``
defaults to ``cuda`` and fails where there is no card.

``--selftest`` serves the shipped request fixture through the whole
pipeline, checks every greedy action against the recorded JAX one, runs a
forced-saturation pass through the fallback, prints one
``{"selftest": "ok", ...}`` line and exits 0.
"""
from __future__ import annotations

import argparse
import json
import os
import select
import sys

import numpy as np

_OBS_INT_KEYS = ("edges_src", "edges_dst", "node_split", "edge_split",
                 "action_set", "action_mask")

# the default ladder's top bucket: env_load32_price_mixed's pad bounds,
# the environment the shipped policy was trained on
DEFAULT_MAX_NODES, DEFAULT_MAX_EDGES = 150, 512


class LineAssembler:
    """Splits raw fd chunks into complete lines. The serving loop selects
    on the stdin fd, and select() reports readable once per CHUNK, not
    once per line — so every complete line in a chunk must be handled
    before returning to select (a buffered readline would strand the rest
    of a burst while select blocks)."""

    def __init__(self):
        self._buf = b""

    def feed(self, chunk: bytes) -> list:
        self._buf += chunk
        *lines, self._buf = self._buf.split(b"\n")
        return [ln.decode("utf-8", "replace") for ln in lines]

    def flush(self) -> list:
        """The final unterminated line at EOF, if any."""
        buf, self._buf = self._buf, b""
        return [buf.decode("utf-8", "replace")] if buf.strip() else []


def obs_from_json(obj: dict) -> dict:
    obs = {}
    for key, val in obj.items():
        dtype = np.int32 if key in _OBS_INT_KEYS else np.float32
        obs[key] = np.asarray(val, dtype=dtype)
    for key in ("node_split", "edge_split"):
        obs[key] = np.atleast_1d(obs[key])
    return obs


def parse_buckets(text):
    if not text:
        return None
    return [tuple(int(x) for x in b.split("x")) for b in text.split(",")]


def make_fleet(args, model, params, **overrides):
    """The fleet the front end serves through (one replica by default, so
    the protocol and answer bits are the single-server path's). Quota
    shedding only arms when ``--quota-rps`` is set."""
    from ddls_tpu_torch.envs.baselines import FixedDegreePacking
    from ddls_tpu_torch.serve import build_fleet

    kwargs = dict(
        n_replicas=args.replicas, routing=args.routing,
        shed_enabled=bool(args.quota_rps),
        quota_rps=args.quota_rps or None,
        quota_burst=args.quota_burst or None,
        buckets=parse_buckets(args.buckets),
        max_nodes=DEFAULT_MAX_NODES, max_edges=DEFAULT_MAX_EDGES,
        max_batch=args.max_batch, deadline_s=args.deadline_ms / 1e3,
        max_queue=args.max_queue,
        fallback=FixedDegreePacking(degree=args.degree),
        device=args.device)
    kwargs.update(overrides)
    return build_fleet(model, params, **kwargs)


def run_selftest(args, model, params) -> int:
    """The shipped request fixture through the fleet: every request must
    get a policy answer equal to the JAX policy's recorded greedy action;
    then a 2-deep queue must answer the overflow from the heuristic
    without dropping a request. One JSON line, rc 0 on ok."""
    from ddls_tpu_torch.envs.baselines import FixedDegreePacking
    from ddls_tpu_torch.serve.fixture import load_requests

    pool, recorded = load_requests()
    fleet = make_fleet(args, model, params)
    ids = [fleet.submit(o) for o in pool]
    responses = fleet.drain()
    by_id = {r.request_id: r for r in responses}
    ok = (sorted(by_id) == sorted(ids)
          and all(by_id[i].source == "policy"
                  and by_id[i].action == int(recorded["jax_actions"][k])
                  for k, i in enumerate(ids)))

    sat = make_fleet(args, model, params, max_queue=2, deadline_s=10.0)
    rule = FixedDegreePacking(degree=args.degree)
    sat_ids = [sat.submit(o) for o in pool]
    sat_responses = sat.poll() + sat.drain()
    fb = [r for r in sat_responses if r.source == "fallback"]
    ok = (ok and sorted(r.request_id for r in sat_responses) == sorted(
        sat_ids) and len(fb) > 0
          and all(r.reason == "saturated"
                  and r.action == rule.compute_action(pool[r.request_id])
                  for r in fb))
    summary = fleet.replica_set.replicas[0].server.stats.summary()
    print(json.dumps({"selftest": "ok" if ok else "FAILED",
                      "device": args.device,
                      "n_requests": len(pool),
                      "n_fallback_saturated": len(fb),
                      **{f"serve_{k}": v for k, v in summary.items()
                         if not isinstance(v, dict)}}), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    from ddls_tpu_torch.serve.fixture import EXPORT_PATH

    parser = argparse.ArgumentParser(
        prog="python -m ddls_tpu_torch.serve",
        description="Serve partition-degree decisions over stdin/stdout")
    parser.add_argument("--params", default=EXPORT_PATH,
                        help="exported policy .npz (default: the shipped "
                             "ppo_price_mixed)")
    parser.add_argument("--device", default="cuda",
                        help="where the forward runs (cuda or cpu)")
    parser.add_argument("--buckets", default=None,
                        help="explicit ladder, e.g. '38x128,75x256' "
                             "(default: the halving ladder under "
                             "150x512)")
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--deadline-ms", type=float, default=10.0)
    parser.add_argument("--max-queue", type=int, default=64)
    parser.add_argument("--replicas", type=int, default=1,
                        help="PolicyServer replicas behind the fleet "
                             "Router (stdout protocol unchanged)")
    parser.add_argument("--routing",
                        choices=("affinity", "least_loaded",
                                 "round_robin", "hash"),
                        default="affinity",
                        help="fleet routing policy (affinity = "
                             "consistent-hash on the request's "
                             "'tenant' field, least-loaded otherwise)")
    parser.add_argument("--quota-rps", type=float, default=0.0,
                        help="per-tenant token-bucket admission rate; "
                             "0 disables quotas")
    parser.add_argument("--quota-burst", type=float, default=0.0,
                        help="quota burst size (default: --quota-rps)")
    parser.add_argument("--degree", type=int, default=8,
                        help="FixedDegreePacking fallback degree")
    parser.add_argument("--selftest", action="store_true",
                        help="serve the shipped request fixture and check "
                             "it against the recorded JAX actions; no "
                             "stdin")
    args = parser.parse_args(argv)

    from ddls_tpu_torch.serve import load_export, resolve_device

    resolve_device(args.device)  # fail fast when CUDA is asked for and absent
    model, params, _graph_dim = load_export(args.params)
    if args.selftest:
        return run_selftest(args, model, params)

    server = make_fleet(args, model, params)
    rid_to_client: dict = {}

    def emit_responses(responses) -> None:
        for r in responses:
            print(json.dumps({
                "id": rid_to_client.pop(r.request_id, r.request_id),
                "action": r.action, "source": r.source,
                "reason": r.reason, "bucket": r.bucket_idx,
                "latency_ms": round(r.latency_s * 1e3, 3)}), flush=True)

    def handle_line(line: str) -> None:
        if not line.strip():
            return
        # one malformed line errors to ITS client and never kills the
        # serving loop (or the batches already queued)
        client_id = None
        try:
            obj = json.loads(line)
            tenant = None
            if isinstance(obj, dict):
                client_id = obj.get("id")
                tenant = obj.get("tenant")
            rid = server.submit(obs_from_json(obj["obs"]), tenant=tenant)
            rid_to_client[rid] = (client_id if client_id is not None
                                  else rid)
        except Exception as exc:
            print(json.dumps({
                "id": client_id,
                "error": f"{type(exc).__name__}: {exc}"}),
                flush=True)

    # select-with-timeout pump: deadline flushes must fire while BLOCKED
    # on input, or an interactive client deadlocks against its own partial
    # batch until EOF. Reads go through os.read on the raw fd +
    # LineAssembler, NOT buffered readline.
    fd = sys.stdin.fileno()
    lines_in = LineAssembler()
    stdin_open = True
    while stdin_open:
        deadline = server.next_deadline()
        timeout = (None if deadline is None
                   else max(0.0, deadline - server.clock()))
        ready, _, _ = select.select([fd], [], [], timeout)
        if ready:
            chunk = os.read(fd, 1 << 16)
            if not chunk:
                stdin_open = False
                for line in lines_in.flush():
                    handle_line(line)
            else:
                for line in lines_in.feed(chunk):
                    handle_line(line)
        emit_responses(server.poll())
    emit_responses(server.drain())
    print(json.dumps({"serve_stats": server.summary()}),
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
