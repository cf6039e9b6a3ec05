"""Observation encoding for the PAC-ML job-partitioning MDP.

Encodes the queued job's computation graph + cluster state into fixed-size
padded arrays ready to batch onto TPU (reference:
ddls/environments/ramp_job_partitioning/observations/
ramp_job_partitioning_observation.py:15):

* ``node_features`` [max_nodes, 5]: compute cost (normalised by the job's max
  op cost), is-max-compute flag, memory cost (normalised), is-max-memory
  flag, depth (normalised by max depth);
* ``edge_features`` [max_edges, 2]: dep size (normalised by the job's max dep
  size), is-max-size flag;
* ``graph_features``: 17 normalised job+cluster scalars (counts, sequential
  JCT, SLA, totals, op-cost moments, dep-size moments, mounted-worker and
  running-job fractions) concatenated with the action mask;
* ``edges_src``/``edges_dst`` [max_edges]: integer endpoints (insertion
  order), zero-padded; ``node_split``/``edge_split``: true counts.

``max_edges`` is the fully connected bound ``max_nodes*(max_nodes-1)/2``
(reference: :52). Action-mask validity per the reference (:80-131): action a
(= max partitions per op; 0 = do not place) is valid iff it is 1 or even, at
most max_partitions_per_op, at most the number of free workers, and (a > 1)
some symmetric block shape of a servers exists in the topology.

One deliberate fix vs the reference: its is-max-compute flag compares an op
id against a per-device dict and is constantly False
(ramp_job_partitioning_observation.py:533); here the flag is real.

Port: a copy of ``ddls_tpu/envs/obs.py`` (the whole encoder, the
masked-pad re-padding the serving bucketer uses, and ``ObsWriter``, the
writer of the shared-memory rollout transport).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional

import numpy as np

from ddls_tpu_torch.agents.block_search import block_shapes_for, factor_pairs
from ddls_tpu_torch.envs import spaces

NODE_FEATURE_DIM = 5
EDGE_FEATURE_DIM = 2
GRAPH_FEATURE_DIM = 17


def graph_feature_width(n_actions: int,
                        include_candidate_prices: bool = False) -> int:
    """The encoded ``graph_features`` vector width: base graph features +
    the action mask + candidate prices when enabled. Single owner of the
    formula — the observation space below and serving's
    ``build_model_from_config`` (serve/server.py) both derive from it, so
    a layout change here cannot silently desynchronise them."""
    return GRAPH_FEATURE_DIM + n_actions * (
        2 if include_candidate_prices else 1)


@lru_cache(maxsize=None)
def _block_shape_exists(action: int, ramp_shape: tuple) -> bool:
    """Static per-(action, topology) half of the validity test, memoised:
    this runs per action per decision on the hot path (both the mask
    encoder and candidate pricing call it)."""
    return bool(block_shapes_for(factor_pairs(action), ramp_shape))


def action_is_valid(action: int, env) -> bool:
    if action == 0:
        return True
    if action != 1 and action % 2 != 0:
        return False
    if action > env.max_partitions_per_op:
        return False
    free_workers = (env.cluster.topology.num_workers
                    - len(env.cluster.mounted_workers))
    if action > free_workers:
        return False
    if action == 1:
        return True
    # valid iff some symmetric block shape of `action` servers fits the
    # topology; block_shapes_for already filters to fitting shapes
    return _block_shape_exists(action, env.cluster.topology.shape)


class RampJobPartitioningObservation:
    def __init__(self,
                 max_partitions_per_op: int,
                 pad_obs_kwargs: Optional[dict] = None,
                 machine_epsilon: float = 1e-7,
                 include_candidate_prices: bool = False):
        self.max_partitions_per_op = max_partitions_per_op
        self.pad_obs_kwargs = pad_obs_kwargs or {}
        self.machine_epsilon = machine_epsilon
        # opt-in decision-time candidate-price features: one entry per
        # action, min(priced lookahead JCT / max-acceptable JCT, 2)/2 —
        # 0.5 is exactly the SLA boundary, 1.0 = unpriceable/unplaceable.
        # This is the information OracleJCT acts on; exposing it makes
        # the oracle's policy linearly representable from the observation
        # (docs/results_round4/RESULTS.md §3). Requires the env's
        # candidate_pricing to be enabled.
        self.include_candidate_prices = include_candidate_prices
        self.max_nodes = int(self.pad_obs_kwargs.get("max_nodes", 0))
        # the reference pads edges to the fully-connected worst-case bound
        # (jobs_generator.py:320-324); that is hugely wasteful on TPU (the
        # real graphs are sparse DAGs), so a tighter cap can be configured
        self.max_edges = int(self.pad_obs_kwargs.get(
            "max_edges", (self.max_nodes * (self.max_nodes - 1)) // 2))
        self.observation_space: Optional[spaces.Dict] = None

    def reset(self, env) -> None:
        n_actions = self.max_partitions_per_op + 1
        if self.max_nodes:
            max_n, max_e = self.max_nodes, self.max_edges
        else:
            # unpadded mode: shapes follow the queued job's true size
            job = list(env.cluster.job_queue.jobs.values())[0]
            max_n, max_e = job.graph.n_ops, job.graph.n_deps
        self.observation_space = spaces.Dict({
            "action_set": spaces.Box(0, self.max_partitions_per_op,
                                     (n_actions,), np.int32),
            "action_mask": spaces.Box(0, 1, (n_actions,), np.int32),
            "node_features": spaces.Box(
                0.0, 1.0, (max_n, NODE_FEATURE_DIM), np.float32),
            "edge_features": spaces.Box(
                0.0, 1.0, (max_e, EDGE_FEATURE_DIM), np.float32),
            "graph_features": spaces.Box(
                0.0, 1.0,
                (graph_feature_width(n_actions,
                                     self.include_candidate_prices),),
                np.float32),
            "edges_src": spaces.Box(0, max_n - 1, (max_e,), np.int32),
            "edges_dst": spaces.Box(0, max_n - 1, (max_e,), np.int32),
            "node_split": spaces.Box(0, max_n, (1,), np.int32),
            "edge_split": spaces.Box(0, max_e, (1,), np.int32),
        })

    # ------------------------------------------------------------------ encode
    def extract(self, env, done: bool) -> Dict[str, np.ndarray]:
        job = list(env.cluster.job_queue.jobs.values())[0]
        return self.encode(job, env)

    def get_action_set_and_mask(self, env):
        action_set = np.arange(self.max_partitions_per_op + 1, dtype=np.int32)
        mask = np.array([action_is_valid(a, env) for a in action_set],
                        dtype=np.int32)
        return action_set, mask

    def encode(self, job, env) -> Dict[str, np.ndarray]:
        graph = job.graph
        n, m = graph.n_ops, graph.n_deps
        if self.max_nodes and n > self.max_nodes:
            raise ValueError(
                f"job has {n} ops but pad_obs max_nodes={self.max_nodes}; "
                "increase max_nodes or use smaller graphs")
        if self.max_nodes and m > self.max_edges:
            raise ValueError(
                f"job has {m} deps but max_edges={self.max_edges}")

        arrays = graph.finalize()
        node_feats = self._node_features(job, arrays)
        edge_feats = self._edge_features(job, arrays)
        graph_feats = self._graph_features(job, env)
        action_set, action_mask = self.get_action_set_and_mask(env)
        graph_feats = np.concatenate(
            [graph_feats, action_mask.astype(np.float32)])
        if self.include_candidate_prices:
            graph_feats = np.concatenate(
                [graph_feats, self._price_features(job, env)])

        srcs = arrays["edge_src"].astype(np.int32)
        dsts = arrays["edge_dst"].astype(np.int32)

        max_n = self.max_nodes or n
        max_e = self.max_edges or m
        obs = {
            "action_set": action_set,
            "action_mask": action_mask,
            "node_features": _pad2(node_feats, max_n),
            "edge_features": _pad2(edge_feats, max_e),
            "graph_features": graph_feats.astype(np.float32),
            "edges_src": _pad1(srcs, max_e),
            "edges_dst": _pad1(dsts, max_e),
            "node_split": np.array([n], dtype=np.int32),
            "edge_split": np.array([m], dtype=np.int32),
        }
        for key, val in obs.items():
            if not np.all(np.isfinite(val)):
                raise ValueError(f"observation field {key} contains NaN/inf")
        return obs

    def _price_features(self, job, env) -> np.ndarray:
        """Per-action priced-JCT/SLA ratios (candidate_pricing must be on;
        see __init__). Encoded so 0.5 is the acceptance boundary."""
        if not getattr(env, "candidate_pricing", None):
            raise ValueError(
                "include_candidate_prices needs the env's "
                "candidate_pricing enabled")
        prices = getattr(env, "candidate_prices", None) or {}
        limit = max(job.max_acceptable_jct, 1e-30)
        feats = np.ones(self.max_partitions_per_op + 1, np.float32)
        for a, priced in prices.items():
            if priced is not None:
                feats[a] = min(priced[0] / limit, 2.0) / 2.0
        return feats

    def _node_features(self, job, arrays) -> np.ndarray:
        compute, memory, depth = (arrays["compute"], arrays["memory"],
                                  arrays["depth"])
        max_c = max(job.immutable["max_compute_cost"], 1e-30)
        max_m = max(job.immutable["max_memory_cost"], 1e-30)
        max_d = max(job.immutable["max_depth"], 1)
        feats = np.stack([
            compute / max_c,
            (compute == job.immutable["max_compute_cost"]).astype(np.float64),
            memory / max_m,
            (memory == job.immutable["max_memory_cost"]).astype(np.float64),
            depth / max_d,
        ], axis=1)
        return np.clip(feats, 0.0, 1.0)

    def _edge_features(self, job, arrays) -> np.ndarray:
        sizes = arrays["edge_size"]
        max_s = max(job.immutable["max_dep_size"], 1e-30)
        feats = np.stack([
            sizes / max_s,
            (sizes == job.immutable["max_dep_size"]).astype(np.float64),
        ], axis=1)
        return np.clip(feats, 0.0, 1.0)

    def _graph_features(self, job, env) -> np.ndarray:
        params = env.cluster.jobs_generator.jobs_params
        arrays = job.graph.finalize()

        def norm(val, key) -> float:
            lo, hi = params[f"min_{key}"], params[f"max_{key}"]
            if hi - lo == 0:
                return 1.0
            return float((val - lo) / (hi - lo))

        max_c = max(job.immutable["max_compute_cost"], 1e-30)
        max_m = max(job.immutable["max_memory_cost"], 1e-30)
        max_s = max(job.immutable["max_dep_size"], 1e-30)
        compute_norm = arrays["compute"] / max_c
        memory_norm = arrays["memory"] / max_m
        sizes = arrays["edge_size"]

        topo = env.cluster.topology
        feats = [
            norm(job.graph.n_ops, "job_total_num_ops"),
            norm(job.graph.n_deps, "job_total_num_deps"),
            norm(job.seq_completion_time, "job_sequential_completion_times"),
            norm(job.max_acceptable_jct,
                 "max_acceptable_job_completion_times"),
            norm(job.max_acceptable_jct_frac,
                 "max_acceptable_job_completion_time_fracs"),
            job.max_acceptable_jct_frac,
            norm(job.immutable["job_total_op_memory_cost"],
                 "job_total_op_memory_costs"),
            norm(job.immutable["job_total_dep_size"], "job_total_dep_sizes"),
            norm(job.num_training_steps, "job_num_training_steps"),
            float(np.mean(compute_norm)),
            float(np.median(compute_norm)),
            float(np.mean(memory_norm)),
            float(np.median(memory_norm)),
            float(np.mean(sizes) / max_s) if len(sizes) else 0.0,
            float(np.median(sizes) / max_s) if len(sizes) else 0.0,
            len(env.cluster.mounted_workers) / topo.num_workers,
            len(env.cluster.jobs_running) / topo.num_workers,
        ]
        assert len(feats) == GRAPH_FEATURE_DIM
        return np.clip(np.array(feats, dtype=np.float32), 0.0, 1.0)


def _pad2(x: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n, x.shape[1]), dtype=np.float32)
    out[:len(x)] = x
    return out


def _pad1(x: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,), dtype=x.dtype)
    out[:len(x)] = x
    return out


def _pad_into(x: np.ndarray, dst: np.ndarray, rows: int,
              key: str) -> None:
    """Write ``x`` into the first ``len(x)`` rows of ``dst`` and zero the
    rest — the in-place twin of ``_pad2``/``_pad1`` (the destination may
    hold stale bytes from a previous occupant, so the dead region must be
    re-zeroed, exactly the masked-pad policy)."""
    if dst.shape[0] != rows:
        raise ValueError(f"out[{key!r}] has {dst.shape[0]} rows, pad "
                         f"target is {rows}")
    k = len(x)
    dst[:k] = x
    dst[k:] = 0


# fields pad_obs_to re-pads; everything else passes through unchanged
_REPADDED_KEYS = ("node_features", "edge_features", "edges_src",
                  "edges_dst", "node_split", "edge_split")


def pad_obs_to(obs: Dict[str, np.ndarray], max_nodes: int,
               max_edges: int,
               out: Optional[Dict[str, np.ndarray]] = None
               ) -> Dict[str, np.ndarray]:
    """Re-pad an encoded observation to a different (max_nodes, max_edges)
    pad target, keeping exactly the true rows (``node_split``/``edge_split``)
    and zero-filling the rest — the same masked-pad policy ``encode`` uses,
    so the repad changes which rows are dead padding but never a real row.
    The serving bucketer (serve/bucketing.py) uses this to snap incoming
    observations, whatever bound the client padded to, onto its fixed
    bucket shapes.

    ``out`` (encode-into-destination): a dict of caller-owned destination
    arrays — shared-memory slab slices (rl/shm.py), serve arenas
    (serve/bucketing.py) — written in place instead of allocated. Padded
    fields land under the same policy (real rows copied, dead region
    zeroed — bit-for-bit with the allocating path); any other field
    present in ``out`` (graph_features, action_mask, ...) is copied into
    its destination; obs fields absent from ``out`` pass through by
    reference. The returned dict maps each written field to its ``out``
    array."""
    n = int(np.asarray(obs["node_split"]).reshape(-1)[0])
    m = int(np.asarray(obs["edge_split"]).reshape(-1)[0])
    if n > max_nodes:
        raise ValueError(f"obs has {n} ops but pad target "
                         f"max_nodes={max_nodes}")
    if m > max_edges:
        raise ValueError(f"obs has {m} deps but pad target "
                         f"max_edges={max_edges}")
    node = np.asarray(obs["node_features"], dtype=np.float32)[:n]
    edge = np.asarray(obs["edge_features"], dtype=np.float32)[:m]
    if out is None:
        res = dict(obs)
        res["node_features"] = _pad2(node, max_nodes)
        res["edge_features"] = _pad2(edge, max_edges)
        for key in ("edges_src", "edges_dst"):
            res[key] = _pad1(np.asarray(obs[key], dtype=np.int32)[:m],
                             max_edges)
        res["node_split"] = np.array([n], dtype=np.int32)
        res["edge_split"] = np.array([m], dtype=np.int32)
        return res
    res = dict(obs)
    _pad_into(node, out["node_features"], max_nodes, "node_features")
    _pad_into(edge, out["edge_features"], max_edges, "edge_features")
    for key in ("edges_src", "edges_dst"):
        _pad_into(np.asarray(obs[key], dtype=np.int32)[:m], out[key],
                  max_edges, key)
    out["node_split"][...] = n
    out["edge_split"][...] = m
    for key, dst in out.items():
        if key not in _REPADDED_KEYS:
            np.copyto(dst, np.asarray(obs[key]))
    res.update(out)
    return res


class ObsWriter:
    """``pad_obs_to(obs, max_nodes, max_edges, out=out)`` bound to one pad
    target: the subprocess env worker (``rl/rollout.py``) builds one per
    slab attachment, so each step's write carries the pad target instead
    of reading it off the destination."""

    def __init__(self, max_nodes: int, max_edges: int):
        self.max_nodes = int(max_nodes)
        self.max_edges = int(max_edges)

    def write(self, obs: Dict[str, np.ndarray],
              out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return pad_obs_to(obs, self.max_nodes, self.max_edges, out=out)
