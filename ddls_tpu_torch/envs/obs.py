"""The serving side of the observation contract
(counterpart of ``ddls_tpu/envs/obs.py:39-54, 270-356``, trimmed to what a
server needs: the feature widths and the masked-pad re-padding the bucketer
uses; the encoder itself stays with the simulator).

An encoded observation holds ``node_features`` [max_nodes, 5],
``edge_features`` [max_edges, 2], ``graph_features`` (17 job and cluster
scalars + the action mask [+ candidate prices]), ``edges_src`` /
``edges_dst`` [max_edges], ``node_split`` / ``edge_split`` (the true
counts), ``action_set`` and ``action_mask``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

NODE_FEATURE_DIM = 5
EDGE_FEATURE_DIM = 2
GRAPH_FEATURE_DIM = 17


def graph_feature_width(n_actions: int,
                        include_candidate_prices: bool = False) -> int:
    """The encoded ``graph_features`` width: base graph features + the
    action mask + candidate prices when enabled."""
    return GRAPH_FEATURE_DIM + n_actions * (
        2 if include_candidate_prices else 1)


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
    rest (the destination may hold a previous occupant's bytes)."""
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
    """Re-pad an encoded observation to (max_nodes, max_edges), keeping
    exactly the true rows (``node_split``/``edge_split``) and zero-filling
    the rest, so the re-pad moves the dead masked region and never a real
    row.

    ``out``: caller-owned destination arrays (the serving arenas) written
    in place instead of allocated — padded fields under the same policy,
    every other field present in ``out`` copied into its destination, obs
    fields absent from ``out`` passed through by reference."""
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
