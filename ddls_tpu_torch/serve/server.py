"""In-process online policy server: bucket -> microbatch -> one flat-batched
forward on the card -> partition-degree decision.

Counterpart of ``ddls_tpu/serve/server.py``, with the same request
contract, responses, stats and degraded mode. Three design rules:

* **Fixed program shapes.** Every bucket runs one program shape: the
  flattened mega-graph forward (``GNNPolicy.flat_batched``) at a fixed
  batch size ``max_batch``. Partial flushes are padded by replicating the
  first request's rows. Every kernel of the forward computes a row, node or
  graph from that item's own inputs in a fixed order (the segment mean
  walks a destination-sorted CSR, no atomics), so a request's outputs are
  the same bits whatever rides in the other slots: batching never changes
  an answer (pinned in tests/test_torch_serve.py and by chip_smoke.py).
* **Deadline microbatching.** Requests queue per bucket and flush on fill
  or when the oldest has waited ``deadline_s`` (serve/microbatch.py), so
  the per-flush costs (one host-to-device copy, the launches, one
  read-back) are shared by the batch.
* **Heuristic degraded mode.** When the queue saturates, a request fits no
  bucket, or the forward fails, the answer comes from the rule-extracted
  ``FixedDegreePacking`` heuristic (envs/baselines.py). The server never
  blocks on the device and never drops a request.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; asking for CUDA where there is none raises — there is no
silent CPU fallback. The server is single-threaded and
clock-parameterised: ``submit``/``poll`` take an optional ``now``.
"""
from __future__ import annotations

import copy
import json
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ddls_tpu_torch import telemetry
from ddls_tpu_torch.envs.baselines import FixedDegreePacking
from ddls_tpu_torch.envs.obs import EDGE_FEATURE_DIM, NODE_FEATURE_DIM
from ddls_tpu_torch.models.convert import (checkpoint_graph_feature_dim,
                                           params_from_flax)
from ddls_tpu_torch.models.policy import GNNPolicy, flat_graph_inputs
from ddls_tpu_torch.serve.bucketing import (BucketOverflowError, BucketSpec,
                                            ObsBucketer, default_buckets)
from ddls_tpu_torch.serve.microbatch import MicrobatchEngine, PendingRequest

# the canonical 32-server extraction (rule_extraction.md): what the shipped
# ppo_price_mixed policy implements
DEFAULT_FALLBACK_DEGREE = 8

# every encoded-obs key the batched forward stacks PLUS action_set, which
# every heuristic-fallback path reads; validated at submit so one
# malformed request errors to ITS caller instead of poisoning a batch
_REQUIRED_OBS_KEYS = ("node_features", "edge_features", "graph_features",
                      "edges_src", "edges_dst", "node_split", "edge_split",
                      "action_set", "action_mask")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is usable (entry points never fall back to the CPU silently)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                f"pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _validate_obs(obs: Dict[str, Any], widths: Dict[str, int]) -> None:
    """Reject a malformed obs at submit, before it can reach a batch: the
    per-row feature widths come from the obs contract, the
    ``graph_features``/``action_mask`` widths from the server's model.
    Without these checks one bad request would pass submit and fail inside
    the forward — downgrading its co-batched requests to the heuristic, or
    latching degraded mode on a healthy card."""
    missing = [k for k in _REQUIRED_OBS_KEYS if k not in obs]
    if missing:
        raise ValueError(f"request obs missing keys {missing}")
    for key, dim in (("node_features", NODE_FEATURE_DIM),
                     ("edge_features", EDGE_FEATURE_DIM)):
        arr = np.asarray(obs[key])
        if arr.ndim != 2 or arr.shape[1] != dim:
            raise ValueError(f"obs[{key!r}] must be 2-D [rows, {dim}], "
                             f"got shape {arr.shape}")
    # split counts must agree with the rows present: an inflated split
    # would zero-fill phantom "real" rows, a negative one truncates
    for split_key, rows_key, row_count in (
            ("node_split", "node_features",
             int(np.asarray(obs["node_features"]).shape[0])),
            ("edge_split", "edge_features",
             int(np.asarray(obs["edge_features"]).shape[0]))):
        split = np.asarray(obs[split_key]).reshape(-1)
        if split.size != 1:
            raise ValueError(f"obs[{split_key!r}] must hold one count, "
                             f"got {split.size} values")
        count = int(split[0])
        if not 0 <= count <= row_count:
            raise ValueError(f"obs[{split_key!r}]={count} out of range "
                             f"for {row_count} {rows_key} rows")
    m = int(np.asarray(obs["edge_split"]).reshape(-1)[0])
    n = int(np.asarray(obs["node_split"]).reshape(-1)[0])
    for key in ("edges_src", "edges_dst"):
        arr = np.asarray(obs[key])
        if arr.ndim != 1 or arr.shape[0] < m:
            raise ValueError(f"obs[{key!r}] must be 1-D with >= "
                             f"edge_split={m} entries, got shape "
                             f"{arr.shape}")
        # REAL edges must point at REAL nodes of THIS graph: in the
        # flattened mega-graph an out-of-range endpoint would land in a
        # co-batched graph's nodes (or past the batch, on the card)
        real = arr[:m]
        if m and (int(real.min()) < 0 or int(real.max()) >= n):
            raise ValueError(
                f"obs[{key!r}] endpoints must lie in [0, "
                f"node_split={n}) for the first edge_split={m} edges; "
                f"got range [{int(real.min())}, {int(real.max())}]")
    for key in ("graph_features", "action_mask"):
        arr = np.asarray(obs[key])
        if arr.ndim != 1:
            raise ValueError(f"obs[{key!r}] must be 1-D, "
                             f"got shape {arr.shape}")
        if int(arr.shape[0]) != widths[key]:
            raise ValueError(f"obs[{key!r}] width {arr.shape[0]} != "
                             f"{widths[key]} (this server's model)")
    n_mask = int(np.asarray(obs["action_mask"]).shape[0])
    if np.asarray(obs["action_set"]).shape != (n_mask,):
        raise ValueError(
            f"obs['action_set'] shape "
            f"{np.asarray(obs['action_set']).shape} != action_mask's "
            f"({n_mask},)")


@dataclass
class ServeResponse:
    request_id: int
    action: int
    source: str           # "policy" | "fallback"
    reason: str           # "batched" | "saturated" | "overflow"
                          # | "invalid" | "degraded"
    bucket_idx: Optional[int]
    latency_s: float
    batch_fill: Optional[int] = None   # real requests in the flushed batch


# trailing-window size for the percentile/occupancy samples
STATS_WINDOW = 8192

# batch-fill fractions land in (0, 1]: an eighth-ladder matches the
# default max_batch=8
_OCCUPANCY_BUCKETS = tuple((i + 1) / 8 for i in range(8))


class ServeStats:
    """Serving accounting: counters + fixed-bucket latency/occupancy
    histograms in a PRIVATE always-on ``telemetry.Registry`` (concurrent
    servers never share counters). ``summary()`` keeps the JAX server's
    JSON shape; ``n_compiles`` counts the distinct program shapes run."""

    def __init__(self, registry: Optional[telemetry.Registry] = None):
        self.registry = (registry if registry is not None
                         else telemetry.Registry(enabled=True))
        r = self.registry
        self._requests = r.counter("serve.requests")
        self._policy = r.counter("serve.policy")
        self._fallback = r.counter("serve.fallback")
        self._flushes = r.counter("serve.flushes")
        self._degraded = r.counter("serve.degraded_transitions")
        self._compiles = r.gauge("serve.compiles")
        self._latency = r.histogram("serve.latency_s",
                                    window=STATS_WINDOW)
        self._occupancy = r.histogram("serve.batch_occupancy",
                                      buckets=_OCCUPANCY_BUCKETS,
                                      window=STATS_WINDOW)

    def record_request(self) -> None:
        self._requests.inc()

    def record_bucket_hit(self, bucket_idx: int) -> None:
        self.registry.counter(f"serve.bucket_hits.{bucket_idx}").inc()

    def record_response(self, resp: ServeResponse) -> None:
        self._latency.observe(resp.latency_s)
        if resp.source == "policy":
            self._policy.inc()
        else:
            self._fallback.inc()
            self.registry.counter(
                f"serve.fallback_reason.{resp.reason}").inc()

    def record_flush(self, fill: int, capacity: int,
                     bucket_idx: Optional[int] = None,
                     cause: Optional[str] = None) -> None:
        self._flushes.inc()
        occ = fill / capacity
        self._occupancy.observe(occ)
        if bucket_idx is not None:
            self.registry.histogram(
                f"serve.batch_occupancy.bucket{bucket_idx}",
                buckets=_OCCUPANCY_BUCKETS,
                window=STATS_WINDOW).observe(occ)
        if cause is not None:
            self.registry.counter(f"serve.flush_cause.{cause}").inc()

    def record_degraded_transition(self) -> None:
        self._degraded.inc()

    def _prefixed_counts(self, prefix: str) -> Dict[str, int]:
        return {name[len(prefix):]: value
                for name, value in self.registry.counter_items()
                if name.startswith(prefix)}

    @property
    def n_requests(self) -> int:
        return self._requests.value

    @property
    def n_policy(self) -> int:
        return self._policy.value

    @property
    def n_fallback(self) -> int:
        return self._fallback.value

    @property
    def n_flushes(self) -> int:
        return self._flushes.value

    @property
    def degraded_transitions(self) -> int:
        return self._degraded.value

    @property
    def n_compiles(self) -> int:
        return int(self._compiles.value or 0)

    @n_compiles.setter
    def n_compiles(self, value: int) -> None:
        self._compiles.set(int(value))

    @property
    def fallback_reasons(self) -> Dict[str, int]:
        return self._prefixed_counts("serve.fallback_reason.")

    @property
    def flush_causes(self) -> Dict[str, int]:
        return self._prefixed_counts("serve.flush_cause.")

    @property
    def bucket_hits(self) -> Dict[int, int]:
        return {int(k): v
                for k, v in self._prefixed_counts(
                    "serve.bucket_hits.").items()}

    @property
    def latencies_s(self):
        return self._latency.window

    @property
    def occupancies(self):
        return self._occupancy.window

    def summary(self) -> Dict[str, Any]:
        n_requests = self.n_requests
        n_fallback = self.n_fallback
        lat = self._latency
        return {
            "n_requests": n_requests,
            "n_policy": self.n_policy,
            "n_fallback": n_fallback,
            "fallback_rate": (n_fallback / n_requests
                              if n_requests else 0.0),
            "fallback_reasons": self.fallback_reasons,
            "bucket_hits": {str(k): v
                            for k, v in sorted(self.bucket_hits.items())},
            "n_flushes": self.n_flushes,
            "n_compiles": self.n_compiles,
            "p50_latency_ms": (lat.percentile(50) * 1e3
                               if lat.count else None),
            "p99_latency_ms": (lat.percentile(99) * 1e3
                               if lat.count else None),
            "batch_occupancy": (float(np.mean(np.asarray(
                self._occupancy.window_values(), dtype=np.float64)))
                                if self._occupancy.count else None),
            "flush_causes": self.flush_causes,
            "degraded_transitions": self.degraded_transitions,
        }


# the batch as it crosses to the device: every field is 4 bytes wide, so
# one int32 staging buffer holds them all and one copy moves the batch
_FLOAT_FIELDS = ("node_features", "edge_features", "graph_features",
                 "node_mask")


def _batch_layout(b: int, n: int, e: int, g: int, a: int
                  ) -> List[Tuple[str, Tuple[int, ...]]]:
    return [("node_features", (b, n, NODE_FEATURE_DIM)),
            ("edge_features", (b, e, EDGE_FEATURE_DIM)),
            ("graph_features", (b, g)),
            ("action_mask", (b, a)),
            ("src", (b * e,)),
            ("node_mask", (b * n,)),
            ("csr_row_ptr", (b * n + 1,)),
            ("csr_col", (b * e,))]


class _StagedBatch:
    """One program shape's reused host staging buffer (pinned when the
    forward runs on the card) and its per-field views, numpy on the host
    side and torch on the device side after the copy."""

    def __init__(self, layout, device: torch.device):
        words = sum(int(np.prod(shape)) for _, shape in layout)
        self.host = torch.empty(words, dtype=torch.int32,
                                pin_memory=device.type == "cuda")
        flat = self.host.numpy()
        self.fields: List[Tuple[str, int, Tuple[int, ...], bool]] = []
        self.arrays: Dict[str, np.ndarray] = {}
        off = 0
        for name, shape in layout:
            size = int(np.prod(shape))
            is_float = name in _FLOAT_FIELDS
            view = flat[off:off + size]
            self.arrays[name] = (view.view(np.float32) if is_float
                                 else view).reshape(shape)
            self.fields.append((name, off, shape, is_float))
            off += size

    def to_device(self, device: torch.device) -> Dict[str, torch.Tensor]:
        dev = self.host.to(device, non_blocking=True)
        out = {}
        for name, off, shape, is_float in self.fields:
            view = dev[off:off + int(np.prod(shape))]
            out[name] = (view.view(torch.float32) if is_float
                         else view).view(shape)
        return out


class BucketForward:
    """The fixed-shape batched forward for one bucket ladder.

    ``forward(obs_list)`` stacks up to ``max_batch`` same-bucket
    observations (free slots padded with replicas of the first) and runs
    ``GNNPolicy.flat_batched``, returning per-request (masked logits,
    values, greedy actions) as numpy. The forward owns a private copy of
    the model with ``params`` loaded, on ``device``; the copy to the
    device and the read-back are one transfer each.
    """

    def __init__(self, model: GNNPolicy, params: Dict[str, torch.Tensor],
                 max_batch: int, device="cuda",
                 apply_fn: Optional[Callable] = None):
        self.device = resolve_device(device)
        self.model = copy.deepcopy(model).to(self.device).eval()
        self.load_params(params)
        self.max_batch = int(max_batch)
        self._apply = apply_fn or (lambda m, batch: m.flat_batched(batch))
        self._program_shapes: set = set()
        self._staging: Dict[tuple, _StagedBatch] = {}

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        self.model.load_state_dict(params)

    @property
    def n_compiles(self) -> int:
        """Distinct program shapes run (the JAX server's compile count)."""
        return len(self._program_shapes)

    def stack(self, obs_list: Sequence[Dict[str, np.ndarray]]
              ) -> Tuple[_StagedBatch, int]:
        """Host-side batch assembly, separate from the device call so the
        server can tell malformed request DATA (stack fails here) from a
        failing forward (run fails below). The batch lands in a per-shape
        REUSED staging buffer: reuse is safe because ``run`` reads the
        results back (which waits for the forward, and so for the copy
        out of the buffer) before returning, and the next ``stack`` cannot
        happen until then. Builds the flattened mega-graph's CSR here."""
        if not obs_list:
            raise ValueError("empty batch")
        if len(obs_list) > self.max_batch:
            raise ValueError(f"batch of {len(obs_list)} exceeds max_batch "
                             f"{self.max_batch}")
        n_real = len(obs_list)
        filled = list(obs_list) + [obs_list[0]] * (self.max_batch - n_real)
        first = filled[0]
        n = np.asarray(first["node_features"]).shape[0]
        e = np.asarray(first["edge_features"]).shape[0]
        g = np.asarray(first["graph_features"]).shape[0]
        a = np.asarray(first["action_mask"]).shape[0]
        key = (self.max_batch, n, e, g, a)
        staged = self._staging.get(key)
        if staged is None:
            staged = self._staging[key] = _StagedBatch(
                _batch_layout(*key), self.device)
        arrays = staged.arrays
        for k in ("node_features", "edge_features", "graph_features",
                  "action_mask"):
            np.stack([np.asarray(o[k]) for o in filled], out=arrays[k])
        src, node_mask, row_ptr, col = flat_graph_inputs(
            np.stack([np.asarray(o["edges_src"]) for o in filled]),
            np.stack([np.asarray(o["edges_dst"]) for o in filled]),
            np.stack([np.asarray(o["node_split"]).reshape(-1)[:1]
                      for o in filled]),
            np.stack([np.asarray(o["edge_split"]).reshape(-1)[:1]
                      for o in filled]), n)
        arrays["src"][...] = src
        arrays["node_mask"][...] = node_mask
        arrays["csr_row_ptr"][...] = row_ptr
        arrays["csr_col"][...] = col
        return staged, n_real

    def run(self, staged: _StagedBatch, n_real: int
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One host-to-device copy, the forward, one read-back: (masked
        logits [n_real, A], values [n_real], greedy actions [n_real])."""
        batch = staged.to_device(self.device)
        self._program_shapes.add(tuple(
            (name, shape) for name, _, shape, _ in staged.fields))
        with torch.inference_mode():
            logits, values, actions = self._apply(self.model, batch)
            packed = torch.cat([logits, values[:, None],
                                actions[:, None].to(logits.dtype)], dim=1)
        out = packed.cpu().numpy()
        a = logits.shape[1]
        return (out[:n_real, :a], out[:n_real, a],
                out[:n_real, a + 1].astype(np.int64))

    def forward(self, obs_list: Sequence[Dict[str, np.ndarray]]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        staged, n_real = self.stack(obs_list)
        return self.run(staged, n_real)


class PolicyServer:
    """Batched online partition-degree serving from a policy's params.

    Parameters
    ----------
    model, params : the port's ``GNNPolicy`` and its state dict
        (``load_export`` returns both).
    buckets : (max_nodes, max_edges) ladder; defaults to a 3-step halving
        ladder under ``max_nodes``/``max_edges``.
    max_batch : microbatch size = the fixed batch of every program shape.
    deadline_s : latency budget before a partial batch flushes.
    max_queue : total queued requests before saturation fallback.
    fallback : heuristic actor for degraded mode (default
        ``FixedDegreePacking(8)``, the checkpoint-extracted rule).
    device : where the forward runs; ``"cuda"`` unless the caller asks for
        ``"cpu"`` (raises when CUDA is absent).
    apply_fn : test hook — replaces the batched forward
        (``apply_fn(model, batch)``), e.g. with one that raises.
    clock : test hook — the time source for deadlines/latency.

    The request's ``graph_features``/``action_mask`` widths are the
    model's own (``graph_feature_dim``, ``n_actions``): a client built
    against another env config is rejected at submit.
    """

    def __init__(self, model: GNNPolicy, params: Dict[str, torch.Tensor],
                 buckets: Optional[Sequence[BucketSpec]] = None,
                 max_nodes: int = 32, max_edges: Optional[int] = None,
                 max_batch: int = 8, deadline_s: float = 0.01,
                 max_queue: int = 64,
                 fallback=None,
                 device="cuda",
                 apply_fn: Optional[Callable] = None,
                 clock: Callable[[], float] = time.perf_counter):
        # arena reuse: bucketed obs land in recycled per-bucket arrays;
        # leases are released at the end of each flush in _run_batch
        self.bucketer = ObsBucketer(
            buckets if buckets is not None
            else default_buckets(max_nodes, max_edges),
            reuse_arenas=True, max_pool_per_bucket=max(int(max_queue), 1))
        self.engine = MicrobatchEngine(len(self.bucketer.buckets),
                                       max_batch=max_batch,
                                       deadline_s=deadline_s,
                                       max_queue=max_queue)
        self._forward = BucketForward(model, params, max_batch,
                                      device=device, apply_fn=apply_fn)
        self.fallback = (fallback if fallback is not None
                         else FixedDegreePacking(
                             degree=DEFAULT_FALLBACK_DEGREE))
        self.clock = clock
        self.stats = ServeStats()
        self.degraded = False
        # fleet lifecycle flags: ``draining`` tells a Router to stop
        # routing here while queued work finishes normally; ``closed``
        # rejects new submits after close()
        self.draining = False
        self.closed = False
        self._next_id = 0
        self._ready: List[ServeResponse] = []
        self._submit_time: Dict[int, float] = {}
        self._obs_widths = {"action_mask": int(model.n_actions),
                            "graph_features": int(model.graph_feature_dim)}

    # ---------------------------------------------------------------- intake
    def submit(self, obs: Dict[str, np.ndarray],
               now: Optional[float] = None,
               meta: Optional[dict] = None) -> int:
        """Accept one request; returns its request_id. The decision arrives
        via ``poll``/``drain``. Raises ``ValueError`` (before any state
        changes) for a malformed obs."""
        if self.closed:
            raise RuntimeError("PolicyServer is closed")
        _validate_obs(obs, self._obs_widths)
        now = self.clock() if now is None else now
        rid = self._next_id
        self._next_id += 1
        self.stats.record_request()
        self._submit_time[rid] = now

        # fallback answers complete at the clock's now, not the (possibly
        # backdated) arrival instant
        if self.degraded:
            self._resolve_fallback(rid, obs, self.clock(), reason="degraded")
            return rid
        if self.engine.would_saturate():
            # saturation degrades quality, not availability
            self._resolve_fallback(rid, obs, self.clock(),
                                   reason="saturated")
            return rid
        try:
            idx, bucketed = self.bucketer.bucket_obs(obs)
        except BucketOverflowError:
            self._resolve_fallback(rid, obs, self.clock(), reason="overflow")
            return rid
        self.stats.record_bucket_hit(idx)
        self.engine.submit(PendingRequest(
            request_id=rid, bucket_idx=idx, obs=bucketed,
            enqueue_time=now, meta=meta))
        return rid

    # ---------------------------------------------------------------- serving
    def poll(self, now: Optional[float] = None,
             force: bool = False) -> List[ServeResponse]:
        """Flush every due microbatch and return all completed responses
        (including fallback answers resolved at submit time)."""
        real_time = now is None
        now = self.clock() if real_time else now
        for idx, reqs in self.engine.due_batches(now, force=force):
            self._run_batch(idx, reqs, now, reread_clock=real_time,
                            force=force)
        out, self._ready = self._ready, []
        return out

    def drain(self, now: Optional[float] = None) -> List[ServeResponse]:
        """Force-flush everything still queued (shutdown / end of input)."""
        return self.poll(now=now, force=True)

    def serve_one(self, obs: Dict[str, np.ndarray]) -> ServeResponse:
        """Synchronous single-request convenience: submit + immediate
        drain, matched by request id — responses the drain resolves for
        OTHER queued requests stay pending for the caller's next ``poll``.
        Runs the same program shape as full batches, so the answer is
        bit-identical to the batched path."""
        rid = self.submit(obs)
        resolved = self.drain()
        mine = next(r for r in resolved if r.request_id == rid)
        self._ready.extend(r for r in resolved if r.request_id != rid)
        return mine

    def next_deadline(self) -> Optional[float]:
        return self.engine.next_deadline()

    def queued(self) -> int:
        return self.engine.queued()

    # ------------------------------------------------------- fleet lifecycle
    def begin_drain(self) -> None:
        """Stop being a routing target; queued work keeps flushing
        normally via ``poll`` (never a degraded latch, never a drop)."""
        self.draining = True

    def end_drain(self) -> None:
        self.draining = False

    def swap_params(self, params: Dict[str, torch.Tensor],
                    now: Optional[float] = None) -> None:
        """Checkpoint hot-swap, drain-then-swap: everything already
        admitted is answered by the OLD params (answers stay queued for
        the next ``poll``), then the forward's params are replaced."""
        # drain FIRST, then re-park: ``poll`` rebinds ``_ready``
        pending = self.drain(now=now)
        self._ready.extend(pending)
        self._forward.load_params(params)

    def reconfigure_buckets(self, buckets: Sequence[BucketSpec],
                            now: Optional[float] = None) -> None:
        """Bucket-ladder re-fit: drain (old ladder answers everything
        already admitted), then rebuild the bucketer + microbatch queues
        on the new ladder; stats/degraded state carry over."""
        pending = self.drain(now=now)
        self._ready.extend(pending)
        eng = self.engine
        self.bucketer = ObsBucketer(
            buckets, reuse_arenas=True,
            max_pool_per_bucket=max(int(eng.max_queue), 1))
        self.engine = MicrobatchEngine(len(self.bucketer.buckets),
                                       max_batch=eng.max_batch,
                                       deadline_s=eng.deadline_s,
                                       max_queue=eng.max_queue)

    def close(self, now: Optional[float] = None) -> List[ServeResponse]:
        """Drain-aware, idempotent shutdown: the first call answers every
        already-admitted request and returns those responses; later calls
        return ``[]``. New submits raise after close."""
        if self.closed:
            return []
        self.draining = True
        responses = self.drain(now=now)
        self.closed = True
        return responses

    # --------------------------------------------------------------- internal
    def _run_batch(self, bucket_idx: int, reqs: List[PendingRequest],
                   now: float, reread_clock: bool = True,
                   force: bool = False) -> None:
        try:
            self._run_batch_inner(bucket_idx, reqs, now, reread_clock,
                                  force)
        finally:
            # every path below is done with the bucketed obs, so the
            # arenas recycle here
            for r in reqs:
                self.bucketer.release(bucket_idx, r.obs)

    def _run_batch_inner(self, bucket_idx: int, reqs: List[PendingRequest],
                         now: float, reread_clock: bool = True,
                         force: bool = False) -> None:
        # a full batch always means fill (the engine pops full batches
        # before deadline/force partials)
        cause = ("fill" if len(reqs) >= self.engine.max_batch
                 else ("drain" if force else "deadline"))
        self.stats.record_flush(len(reqs), self.engine.max_batch,
                                bucket_idx=bucket_idx, cause=cause)
        try:
            staged, n_real = self._forward.stack([r.obs for r in reqs])
        except Exception:
            # host-side batch assembly failed: malformed request DATA,
            # not a failing forward — answer from the heuristic but do
            # NOT latch degraded
            done = self.clock() if reread_clock else now
            for r in reqs:
                self._resolve_fallback(r.request_id, r.obs, done,
                                       reason="invalid")
            return
        try:
            _logits, _values, actions = self._forward.run(staged, n_real)
            self.stats.n_compiles = self._forward.n_compiles
        except Exception:
            # the forward failed (a dead card, a kernel that raised):
            # answer this batch from the heuristic and stop offering the
            # device path to later requests
            if not self.degraded:
                self.stats.record_degraded_transition()
                telemetry.record_event("serve_degraded",
                                       bucket_idx=bucket_idx,
                                       batch_fill=len(reqs))
            self.degraded = True
            done = self.clock() if reread_clock else now
            for r in reqs:
                self._resolve_fallback(r.request_id, r.obs, done,
                                       reason="degraded")
            return
        done = self.clock() if reread_clock else now
        for r, action in zip(reqs, actions):
            # the greedy action is kernel K4's, over the masked logits
            self._emit(ServeResponse(
                request_id=r.request_id, action=int(action),
                source="policy", reason="batched", bucket_idx=bucket_idx,
                latency_s=done - self._submit_time.pop(r.request_id),
                batch_fill=len(reqs)))

    def _resolve_fallback(self, rid: int, obs, done: float,
                          reason: str) -> None:
        action = int(self.fallback.compute_action(obs))
        self._emit(ServeResponse(
            request_id=rid, action=action, source="fallback", reason=reason,
            bucket_idx=None,
            latency_s=done - self._submit_time.pop(rid)))

    def _emit(self, resp: ServeResponse) -> None:
        self.stats.record_response(resp)
        self._ready.append(resp)


# keys of the export's ``arch`` entry that describe where the weights came
# from rather than the model
_ARCH_METADATA = ("checkpoint", "env_config", "pad_max_nodes",
                  "pad_max_edges")


def load_export(path: str) -> Tuple[GNNPolicy, Dict[str, torch.Tensor], int]:
    """``(model, params, graph_feature_dim)`` from an export ``.npz``
    (``scripts/export_torch_serve_fixture.py``): the flattened flax tree
    under ``params/...`` keys plus a JSON ``arch`` entry. The model is
    built on the CPU from ``arch`` and holds ``params`` (a state dict,
    also returned for the server and for hot swaps)."""
    with np.load(path, allow_pickle=False) as data:
        arch = json.loads(str(data["arch"]))
        tree = {k: data[k] for k in data.files if k.startswith("params/")}
    kwargs = {k: v for k, v in arch.items() if k not in _ARCH_METADATA}
    model = GNNPolicy(device="cpu", **kwargs)
    graph_dim = checkpoint_graph_feature_dim(tree)
    if graph_dim != model.graph_feature_dim:
        raise ValueError(f"{path}: params were trained at graph width "
                         f"{graph_dim}, arch says "
                         f"{model.graph_feature_dim}")
    params = params_from_flax(tree, model)
    model.load_state_dict(params)
    return model, params, graph_dim
