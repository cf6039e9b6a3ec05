"""Training in the port: the sequential PPO epoch loop, checkpoint
evaluation and torch checkpoints (counterpart of ``ddls_tpu/train``);
``python -m ddls_tpu_torch.train`` is the entry point."""
from ddls_tpu_torch.train.checkpointer import (Checkpointer,
                                               restore_train_state,
                                               save_train_state)
from ddls_tpu_torch.train.loops import (RLEpochLoop, RLEvalLoop,
                                        build_epoch_loop_kwargs,
                                        build_policy_from_model_config,
                                        init_like_flax, make_epoch_loop)

__all__ = ["Checkpointer", "restore_train_state", "save_train_state",
           "RLEpochLoop", "RLEvalLoop", "build_epoch_loop_kwargs",
           "build_policy_from_model_config", "init_like_flax",
           "make_epoch_loop"]
