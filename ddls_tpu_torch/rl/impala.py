"""IMPALA learner in PyTorch: the V-trace off-policy actor-critic update.

Counterpart of ``ddls_tpu/rl/impala.py`` on one device (the JAX learner on
a 1-device mesh): the same config fields (``ImpalaConfig`` :41), the same
V-trace (``vtrace`` :69), the same single full-batch update per collected
trajectory (``ImpalaLearner._train_step``) with the ``_loss`` :201 metrics
(``METRIC_KEYS``), and optax's ``chain(clip_by_global_norm(grad_clip),
adam(lr))`` or, with ``opt_type: rmsprop``, ``rmsprop(lr, decay,
epsilon, momentum)`` (``Learner._apply_optimizer``). Acting, staging and
batch assembly are the shared ``Learner``'s.

One update runs: the full-batch forward (K1-K4), the action's
log-probability under it (K12's ``ac_logp``), ``vtrace`` (K10) on the
detached fresh values and log-probabilities (the reference's
``stop_gradient``), the loss and its gradient (K12), autograd through
K5/K6, then the optimiser. The staged rows are B-major (row = b * T + t)
and V-trace runs T-major, as the reference's forward does, so the rows
are mapped to [T, B] before K10 and back after it.

The reference's ``pipeline_depth`` (stale collection on a background
thread) is not ported: the port's loop collects and updates in turn.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ddls_tpu_torch import kernels
from ddls_tpu_torch.rl.actor_critic import AC_METRIC_KEYS, ac_logp, ac_loss
from ddls_tpu_torch.rl.learner import (Learner, StagedTraj, TrainState,
                                       rows_to_tb, tb_to_rows)

METRIC_KEYS = ("policy_loss", "vf_loss", "entropy", "total_loss",
               "mean_rho", "clip_rho_fraction")


@dataclasses.dataclass
class ImpalaConfig:
    lr: float = 5e-4
    gamma: float = 0.99
    vtrace_clip_rho_threshold: float = 1.0
    vtrace_clip_pg_rho_threshold: float = 1.0
    vtrace_drop_last_ts: bool = True
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: Optional[float] = 40.0
    opt_type: str = "adam"
    # rmsprop branch (reference impala.yaml decay/momentum/epsilon)
    decay: float = 0.99
    momentum: float = 0.0
    epsilon: float = 0.1
    train_batch_size: int = 500


# ------------------------------------------------------------- V-trace, K10
def vtrace_plain(behavior_logp, target_logp, rewards, values, dones,
                 last_values, gamma: float, clip_rho: float = 1.0,
                 clip_pg_rho: float = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """V-trace targets and policy-gradient advantages over [T, B] tensors
    (``ddls_tpu/rl/impala.py:vtrace``): returns (vs, pg_adv), both [T, B].
    ``dones[t]`` cuts the bootstrap across episode ends; ``not_done`` is
    float32 whatever the values' type, as the reference's."""
    rho = torch.exp(target_logp - behavior_logp)
    clipped_rho = torch.clamp(rho, max=clip_rho)
    cs = torch.clamp(rho, max=1.0)
    not_done = 1.0 - dones.to(torch.float32)
    next_values = torch.cat([values[1:], last_values[None]], dim=0)
    deltas = clipped_rho * (rewards + gamma * next_values * not_done
                            - values)
    acc = torch.zeros_like(last_values)
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        acc = deltas[t] + gamma * cs[t] * not_done[t] * acc
        out.append(acc)
    vs = values + torch.stack(out[::-1])
    next_vs = torch.cat([vs[1:], last_values[None]], dim=0)
    pg_adv = torch.clamp(rho, max=clip_pg_rho) * (
        rewards + gamma * next_vs * not_done - values)
    return vs, pg_adv


def vtrace(behavior_logp: torch.Tensor, target_logp: torch.Tensor,
           rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
           last_values: torch.Tensor, gamma: float, clip_rho: float = 1.0,
           clip_pg_rho: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10: (vs, pg_adv) [T, B] from ``behavior_logp``, ``target_logp``,
    ``rewards``, ``values`` and ``dones`` (0/1) [T, B] and ``last_values``
    [B], float32 on the card, no gradient (see ``vtrace_plain``)."""
    if kernels.on_cpu(behavior_logp, target_logp, rewards, values, dones,
                      last_values):
        return vtrace_plain(behavior_logp, target_logp, rewards, values,
                            dones, last_values, gamma, clip_rho, clip_pg_rho)
    kernels.check_cuda("rewards", rewards, torch.float32)
    if rewards.dim() != 2:
        raise ValueError(f"rewards must be [T, B], got "
                         f"{tuple(rewards.shape)}")
    t_len, lanes = rewards.shape
    for name, t in (("behavior_logp", behavior_logp),
                    ("target_logp", target_logp), ("values", values),
                    ("dones", dones)):
        kernels.check_cuda(name, t, torch.float32, (t_len, lanes))
    kernels.check_cuda("last_values", last_values, torch.float32, (lanes,))
    vs = torch.empty_like(rewards)
    pg_adv = torch.empty_like(rewards)
    if rewards.numel():
        kernels.launch("vtrace", behavior_logp.data_ptr(),
                       target_logp.data_ptr(), rewards.data_ptr(),
                       values.data_ptr(), dones.data_ptr(),
                       last_values.data_ptr(), vs.data_ptr(),
                       pg_adv.data_ptr(), t_len, lanes, float(gamma),
                       float(clip_rho), float(clip_pg_rho))
    return vs, pg_adv


# -------------------------------------------------------------- the learner
class ImpalaLearner(Learner):
    """IMPALA on one device over ``model`` (a ``GNNPolicy``): one V-trace
    update per staged trajectory. ``device`` is ``"cuda"`` unless the
    caller asks for ``"cpu"``; raises when CUDA is asked for and absent."""

    def loss_and_grads(self, state: TrainState, traj: StagedTraj,
                       last_values: Optional[torch.Tensor] = None):
        """The full-batch loss at the current params: its metrics [7]
        (``AC_METRIC_KEYS``), the gradient of the total loss with respect
        to ``state.params``, and V-trace's ``(target_logp, vs, pg_adv)``
        [T, B] (the reference's ``stop_gradient``-ed values)."""
        cfg = self.cfg
        if last_values is None:
            last_values = traj["last_values"]
        with torch.enable_grad():
            logits, values, _ = self.model.flat_batched(
                self.full_batch(traj))
            target_logp = rows_to_tb(
                ac_logp(logits.detach(), traj["actions"]), traj)
            vs, pg_adv = vtrace(
                rows_to_tb(traj["old_logp"], traj), target_logp,
                traj["rewards"], rows_to_tb(values.detach(), traj),
                traj["dones"], last_values, cfg.gamma,
                cfg.vtrace_clip_rho_threshold,
                cfg.vtrace_clip_pg_rho_threshold)
            total, metrics = ac_loss(
                logits, values, traj["actions"], tb_to_rows(pg_adv),
                tb_to_rows(vs), traj["old_logp"], traj.t_len,
                cfg.vtrace_drop_last_ts, cfg.vf_loss_coeff,
                cfg.entropy_coeff, cfg.vtrace_clip_rho_threshold)
            grads = self._loss_grads(total, state)
        return metrics.detach(), grads, (target_logp, vs, pg_adv)

    def train_step(self, state: TrainState, traj: StagedTraj,
                   last_values: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One V-trace update on a staged [T, B] trajectory (``stage_traj``,
        which carries the bootstrap values; ``last_values``, when given,
        replaces them). The update draws no randomness: ``generator`` is
        accepted, as the reference's ``rng``, and not read. Returns the
        state (updated in place) and the metrics (``METRIC_KEYS``) as
        device tensors."""
        del generator
        metrics, grads, _ = self.loss_and_grads(state, traj, last_values)
        with torch.no_grad():
            self._apply_optimizer(state, grads)
        state.step += 1
        return state, {k: metrics[AC_METRIC_KEYS.index(k)]
                       for k in METRIC_KEYS}
