"""The host-side observation contract and degraded-mode heuristic that
serving needs (the simulator itself is not part of the port yet)."""
from ddls_tpu_torch.envs.baselines import FixedDegreePacking
from ddls_tpu_torch.envs.obs import (EDGE_FEATURE_DIM, GRAPH_FEATURE_DIM,
                                     NODE_FEATURE_DIM, graph_feature_width,
                                     pad_obs_to)

__all__ = ["FixedDegreePacking", "NODE_FEATURE_DIM", "EDGE_FEATURE_DIM",
           "GRAPH_FEATURE_DIM", "graph_feature_width", "pad_obs_to"]
