"""Vanilla policy-gradient (REINFORCE) learner in PyTorch.

Counterpart of ``ddls_tpu/rl/pg.py`` on one device (the JAX learner on a
1-device mesh): ``PGConfig`` :31, the discounted reward-to-go cut at every
``done`` with a zero tail (``reward_to_go`` :49), and one full-batch
update per collected trajectory with the ``_loss`` :141 metrics
(``METRIC_KEYS``) and optax's ``chain(clip_by_global_norm(grad_clip),
adam(lr))`` (no clip unless ``grad_clip`` is set). The policy network's
value head is computed and left out of the loss, so its parameters get
zero gradients and adam leaves them exactly in place, as optax does.

One update runs: ``reward_to_go`` (K11), the full-batch forward (K1-K4),
the loss and its gradient (K12 with ``vf_coeff = ent_coeff = 0``),
autograd through K5/K6, then adam.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ddls_tpu_torch import kernels
from ddls_tpu_torch.rl.actor_critic import AC_METRIC_KEYS, ac_loss
from ddls_tpu_torch.rl.learner import (Learner, StagedTraj, TrainState,
                                       tb_to_rows)

METRIC_KEYS = ("policy_loss", "total_loss", "mean_return_to_go")


@dataclasses.dataclass
class PGConfig:
    lr: float = 4e-4  # RLlib PG default
    gamma: float = 0.99
    grad_clip: Optional[float] = None
    train_batch_size: int = 200


# ------------------------------------------------------- reward-to-go, K11
def reward_to_go_plain(rewards: torch.Tensor, dones: torch.Tensor,
                       gamma: float) -> torch.Tensor:
    """Discounted reward-to-go over [T, B], cut at episode ends
    (``ddls_tpu/rl/pg.py:reward_to_go``). ``gamma * not_done`` is a
    float32 product whatever the rewards' type, as the reference's weak
    typing makes it."""
    not_done = 1.0 - dones.to(torch.float32)
    g = torch.zeros_like(rewards[0])
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        g = rewards[t] + gamma * not_done[t] * g
        out.append(g)
    return torch.stack(out[::-1])


def reward_to_go(rewards: torch.Tensor, dones: torch.Tensor,
                 gamma: float) -> torch.Tensor:
    """K11: the returns [T, B] of ``rewards`` and ``dones`` (0/1) [T, B],
    float32 on the card (see ``reward_to_go_plain``)."""
    if kernels.on_cpu(rewards, dones):
        return reward_to_go_plain(rewards, dones, gamma)
    kernels.check_cuda("rewards", rewards, torch.float32)
    if rewards.dim() != 2:
        raise ValueError(f"rewards must be [T, B], got "
                         f"{tuple(rewards.shape)}")
    t_len, lanes = rewards.shape
    kernels.check_cuda("dones", dones, torch.float32, (t_len, lanes))
    returns = torch.empty_like(rewards)
    if rewards.numel():
        kernels.launch("reward_to_go", rewards.data_ptr(), dones.data_ptr(),
                       returns.data_ptr(), t_len, lanes, float(gamma))
    return returns


# -------------------------------------------------------------- the learner
class PGLearner(Learner):
    """REINFORCE on one device over ``model`` (a ``GNNPolicy``): one update
    per staged trajectory. ``device`` is ``"cuda"`` unless the caller asks
    for ``"cpu"``; raises when CUDA is asked for and absent."""

    def loss_and_grads(self, state: TrainState, traj: StagedTraj):
        """The full-batch loss at the current params: its metrics [7]
        (``AC_METRIC_KEYS``), the gradient of the total loss with respect
        to ``state.params`` and the returns [T, B]."""
        returns = reward_to_go(traj["rewards"], traj["dones"],
                               self.cfg.gamma)
        with torch.enable_grad():
            logits, values, _ = self.model.flat_batched(
                self.full_batch(traj))
            values = values.detach()  # the value head is not in the loss
            total, metrics = ac_loss(
                logits, values, traj["actions"], tb_to_rows(returns),
                values, traj["old_logp"], traj.t_len, False, 0.0, 0.0, 1.0)
            grads = self._loss_grads(total, state)
        return metrics.detach(), grads, returns

    def train_step(self, state: TrainState, traj: StagedTraj,
                   last_values: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One REINFORCE update on a staged [T, B] trajectory. PG needs no
        bootstrap values and draws no randomness: ``last_values`` and
        ``generator`` are accepted, as the reference's ``train_step``
        takes them, and not read. Returns the state (updated in place) and
        the metrics (``METRIC_KEYS``) as device tensors."""
        del last_values, generator
        metrics, grads, _ = self.loss_and_grads(state, traj)
        with torch.no_grad():
            self._apply_optimizer(state, grads)
        state.step += 1
        keys = {"mean_return_to_go": "mean_weight"}
        return state, {k: metrics[AC_METRIC_KEYS.index(keys.get(k, k))]
                       for k in METRIC_KEYS}
