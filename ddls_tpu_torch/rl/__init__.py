"""Reinforcement learning in the port: the shared learner base
(``rl/learner.py``), the PPO, IMPALA, PG, Ape-X DQN and ES learners
(``rl/ppo.py``, ``rl/impala.py``, ``rl/pg.py``, ``rl/dqn.py``,
``rl/es.py``, counterparts of ``ddls_tpu/rl``'s on one device), the
actor-critic loss IMPALA and PG share (``rl/actor_critic.py``) and the
rollout collector."""
from ddls_tpu_torch.rl.actor_critic import AC_METRIC_KEYS, ac_logp, ac_loss
from ddls_tpu_torch.rl.dqn import (ApexDQNLearner, DQNConfig,
                                   PrioritizedReplayBuffer, dqn_act,
                                   dqn_td_loss)
from ddls_tpu_torch.rl.es import ESConfig, ESLearner, es_act, es_update
from ddls_tpu_torch.rl.impala import ImpalaConfig, ImpalaLearner, vtrace
from ddls_tpu_torch.rl.learner import Learner, StagedTraj, TrainState
from ddls_tpu_torch.rl.pg import PGConfig, PGLearner, reward_to_go
from ddls_tpu_torch.rl.ppo import (METRIC_KEYS, PPOConfig, PPOLearner,
                                   categorical_entropy, compute_gae,
                                   gae_normalize, ppo_config_from_rllib,
                                   ppo_loss)

__all__ = ["AC_METRIC_KEYS", "ApexDQNLearner", "DQNConfig", "ESConfig",
           "ESLearner", "ImpalaConfig", "ImpalaLearner", "Learner",
           "METRIC_KEYS", "PGConfig", "PGLearner", "PPOConfig", "PPOLearner",
           "PrioritizedReplayBuffer", "StagedTraj", "TrainState", "ac_logp",
           "ac_loss", "categorical_entropy", "compute_gae", "dqn_act",
           "dqn_td_loss", "es_act", "es_update", "gae_normalize",
           "ppo_config_from_rllib", "ppo_loss", "reward_to_go", "vtrace"]
