"""The shipped serving fixture: the exported ``ppo_price_mixed`` policy and
a pool of real requests with the JAX policy's answers to them.

Both files are made from the JAX package by
``scripts/export_torch_serve_fixture.py`` and travel with the port as
numpy archives, so a machine with neither JAX nor orbax can load the
shipped policy and check the port's answers against the reference's.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
EXPORT_PATH = os.path.join(DATA_DIR, "ppo_price_mixed.npz")
REQUESTS_PATH = os.path.join(DATA_DIR, "serve_requests_price_mixed.npz")

# the encoded-observation keys of each request, stacked [n_requests, ...]
OBS_KEYS = ("node_features", "edge_features", "graph_features", "edges_src",
            "edges_dst", "node_split", "edge_split", "action_set",
            "action_mask")
# the reference's answers, recorded beside the requests
RECORDED_KEYS = ("jax_logits", "jax_values", "jax_actions")


def load_requests(path: str = REQUESTS_PATH
                  ) -> Tuple[List[Dict[str, np.ndarray]],
                             Dict[str, np.ndarray]]:
    """``(requests, recorded)``: one encoded obs dict per request and the
    JAX policy's ``jax_logits`` [n, A], ``jax_values`` [n] and
    ``jax_actions`` [n] for them."""
    with np.load(path, allow_pickle=False) as data:
        stacked = {k: data[k] for k in OBS_KEYS}
        recorded = {k: data[k] for k in RECORDED_KEYS}
    n = stacked["node_features"].shape[0]
    requests = [{k: np.ascontiguousarray(v[i]) for k, v in stacked.items()}
                for i in range(n)]
    return requests, recorded
