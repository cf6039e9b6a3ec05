"""Reinforcement learning in the port: the PPO learner (``rl/ppo.py``),
counterpart of ``ddls_tpu/rl/ppo.py`` on one device."""
from ddls_tpu_torch.rl.ppo import (METRIC_KEYS, PPOConfig, PPOLearner,
                                   StagedTraj, TrainState,
                                   categorical_entropy, compute_gae,
                                   gae_normalize, ppo_config_from_rllib,
                                   ppo_loss)

__all__ = ["METRIC_KEYS", "PPOConfig", "PPOLearner", "StagedTraj",
           "TrainState", "categorical_entropy", "compute_gae",
           "gae_normalize", "ppo_config_from_rllib", "ppo_loss"]
