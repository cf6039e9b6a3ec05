"""Training in the port: the PPO, Ape-X DQN, IMPALA, PG and ES epoch loops
(sequential or pipelined, over in-process or subprocess envs), lazy
metrics, checkpoint evaluation and torch checkpoints (counterpart of
``ddls_tpu/train``); ``python -m ddls_tpu_torch.train`` is the entry
point."""
from ddls_tpu_torch.train.checkpointer import (Checkpointer,
                                               restore_train_state,
                                               save_train_state)
from ddls_tpu_torch.train.loops import (ApexDQNEpochLoop, ESEpochLoop,
                                        ImpalaEpochLoop, PGEpochLoop,
                                        RLEpochLoop, RLEvalLoop,
                                        build_epoch_loop_kwargs,
                                        build_policy_from_model_config,
                                        dqn_config_from_rllib,
                                        es_config_from_rllib,
                                        impala_config_from_rllib,
                                        init_like_flax, make_epoch_loop,
                                        pg_config_from_rllib)

__all__ = ["ApexDQNEpochLoop", "Checkpointer", "ESEpochLoop",
           "ImpalaEpochLoop", "PGEpochLoop", "RLEpochLoop", "RLEvalLoop",
           "build_epoch_loop_kwargs", "build_policy_from_model_config",
           "dqn_config_from_rllib", "es_config_from_rllib",
           "impala_config_from_rllib", "init_like_flax", "make_epoch_loop",
           "pg_config_from_rllib", "restore_train_state",
           "save_train_state"]
