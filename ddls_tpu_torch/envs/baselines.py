"""The heuristic the server answers from in degraded mode
(counterpart of ``ddls_tpu/envs/baselines.py:17-20, 161-207``, trimmed to
``FixedDegreePacking``).
"""
from __future__ import annotations

import numpy as np


def _valid_actions(obs) -> np.ndarray:
    action_set = np.asarray(obs["action_set"])
    mask = np.asarray(obs["action_mask"]).astype(bool)
    return action_set[mask]


class FixedDegreePacking:
    """Partition every job to one fixed degree ``d`` when a ``d``-server
    block is free (``d`` is a valid action), otherwise decline (action 0).

    The decision rule the shipped 32-server policies converged to: the
    JAX package's rule extraction (docs/results_round5/rule_extraction.md)
    found them all to be exactly this rule at d = 8, so degraded-mode
    answers agree with the policy at the extracted degree."""

    name = "fixed_degree_packing"

    def __init__(self, degree: int = 8):
        self.degree = degree

    def compute_action(self, obs, **kwargs) -> int:
        return self.degree if self.degree in _valid_actions(obs) else 0
