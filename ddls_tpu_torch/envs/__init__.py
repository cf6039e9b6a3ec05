"""The PAC-ML job-partitioning environment (copy of ``ddls_tpu/envs``,
host only: the observation encoder, rewards, spaces and
``RampJobPartitioningEnvironment``) and the degraded-mode heuristic that
serving answers from."""
from ddls_tpu_torch.envs.baselines import FixedDegreePacking
from ddls_tpu_torch.envs.obs import (EDGE_FEATURE_DIM, GRAPH_FEATURE_DIM,
                                     NODE_FEATURE_DIM,
                                     RampJobPartitioningObservation,
                                     graph_feature_width, pad_obs_to)
from ddls_tpu_torch.envs.partitioning_env import \
    RampJobPartitioningEnvironment

__all__ = ["FixedDegreePacking", "NODE_FEATURE_DIM", "EDGE_FEATURE_DIM",
           "GRAPH_FEATURE_DIM", "RampJobPartitioningObservation",
           "RampJobPartitioningEnvironment", "graph_feature_width",
           "pad_obs_to"]
