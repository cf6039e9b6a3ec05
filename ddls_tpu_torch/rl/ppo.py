"""PPO learner in PyTorch: GAE, the clipped-surrogate loss and minibatched
SGD epochs over a [T, B] trajectory.

Counterpart of ``ddls_tpu/rl/ppo.py`` on one device (the JAX learner on a
1-device mesh, dp width D = 1): the same algorithm, config fields, metric
keys and minibatch grid, with the optimiser's arithmetic copied from optax
(``clip_by_global_norm`` then ``adam``). Three routines of the update are
hand-written CUDA kernels on the card, each beside its plain PyTorch
version, which the wrappers take for tensors on the CPU:

* ``gae_normalize`` (K7): the reverse GAE recurrence, the value targets
  and the advantage normalisation in one launch;
* ``ppo_loss`` (K8): the loss, its six metrics and its gradient with
  respect to the logits and the values in one launch, wrapped in a
  ``torch.autograd.Function``;
* the policy's backward (K5, K6 and K4's pass-through), through the
  autograd wrappers in ``models/`` and ``ops/``.

Acting, staging, on-device minibatch assembly and the optimiser are the
shared ``Learner``'s (``rl/learner.py``).

Randomness: ``train_step`` takes either the per-epoch permutations (as the
parity tests and ``chip_smoke.py`` hand over JAX's) or an explicit
``torch.Generator`` on the learner's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ddls_tpu_torch import kernels
from ddls_tpu_torch.rl.learner import (Learner, StagedTraj, TrainState,
                                       reject_unknown_algo_keys, tb_to_rows)

METRIC_KEYS = ("policy_loss", "vf_loss", "kl", "entropy", "total_loss",
               "clip_frac")


@dataclasses.dataclass
class PPOConfig:
    lr: float = 2.785e-4
    gamma: float = 0.997
    gae_lambda: float = 1.0
    clip_param: float = 0.18
    vf_clip_param: float = 10.0
    vf_loss_coeff: float = 1.0
    entropy_coeff: float = 0.003
    kl_coeff: float = 0.2
    kl_target: float = 0.01
    num_sgd_iter: int = 50
    sgd_minibatch_size: int = 128
    # consumed by an epoch loop, which sizes rollouts so that
    # rollout_length x num_envs == train_batch_size (the learner itself
    # takes whatever [T, B] batch it is handed)
    train_batch_size: int = 4000
    grad_clip: Optional[float] = None
    normalize_advantages: bool = True


# RLlib PPO keys (algo/ppo.yaml) -> PPOConfig fields
_RLLIB_TO_PPO = {
    "lr": "lr",
    "gamma": "gamma",
    "lambda": "gae_lambda",
    "lambda_": "gae_lambda",
    "kl_coeff": "kl_coeff",
    "kl_target": "kl_target",
    "clip_param": "clip_param",
    "vf_clip_param": "vf_clip_param",
    "vf_loss_coeff": "vf_loss_coeff",
    "entropy_coeff": "entropy_coeff",
    "num_sgd_iter": "num_sgd_iter",
    "sgd_minibatch_size": "sgd_minibatch_size",
    "train_batch_size": "train_batch_size",
    "grad_clip": "grad_clip",
}


def ppo_config_from_rllib(algo_config: Optional[Mapping[str, Any]]
                          ) -> PPOConfig:
    """Translate an RLlib-style PPO config dict (``algo/ppo.yaml``'s
    ``algo_config``) into a ``PPOConfig``; raises on a key nothing
    consumes, so a swept hyperparameter can never be a silent no-op."""
    reject_unknown_algo_keys("ppo", algo_config or {}, _RLLIB_TO_PPO)
    kwargs = {}
    for src, dst in _RLLIB_TO_PPO.items():
        if algo_config and algo_config.get(src) is not None:
            kwargs[dst] = algo_config[src]
    return PPOConfig(**kwargs)


# ----------------------------------------------------------------- GAE, K7
def compute_gae(rewards: torch.Tensor, values: torch.Tensor,
                dones: torch.Tensor, last_values: torch.Tensor,
                gamma: float, lam: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalised advantage estimation over [T, B] tensors (``dones[t]``:
    the episode ended at step t, no bootstrap across it). Returns
    (advantages, value_targets), both [T, B]. ``not_done`` is float32
    whatever the values' type, as the reference's (``dones.astype(
    jnp.float32)``): so ``gamma * lam * not_done`` rounds the coefficient
    to float32 in a float64 run too, exactly as JAX's weak typing does."""
    next_values = torch.cat([values[1:], last_values[None]], dim=0)
    not_done = 1.0 - dones.to(torch.float32)
    deltas = rewards + gamma * next_values * not_done - values
    carry = torch.zeros_like(last_values)
    advs = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * lam * not_done[t] * carry
        advs.append(carry)
    advs = torch.stack(advs[::-1])
    return advs, advs + values


def gae_normalize_plain(rewards, values, dones, last_values, gamma: float,
                        lam: float, normalize: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``compute_gae``, then (when ``normalize``) the advantages as
    ``(adv - mean) / (std + 1e-8)`` with the population std (``jnp.std``);
    the targets come from the raw advantages, as in ``_train_step``."""
    advs, targets = compute_gae(rewards, values, dones, last_values, gamma,
                                lam)
    if normalize:
        mean = advs.mean()
        centered = advs - mean
        advs = centered / (torch.sqrt((centered * centered).mean()) + 1e-8)
    return advs, targets


def gae_normalize(rewards: torch.Tensor, values: torch.Tensor,
                  dones: torch.Tensor, last_values: torch.Tensor,
                  gamma: float, lam: float, normalize: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: (advantages, value_targets) [T, B] from ``rewards``, ``values``
    and ``dones`` (0/1) [T, B] and ``last_values`` [B], float32 on the
    card (see ``gae_normalize_plain``)."""
    if kernels.on_cpu(rewards, values, dones, last_values):
        return gae_normalize_plain(rewards, values, dones, last_values,
                                   gamma, lam, normalize)
    kernels.check_cuda("rewards", rewards, torch.float32)
    if rewards.dim() != 2:
        raise ValueError(f"rewards must be [T, B], got "
                         f"{tuple(rewards.shape)}")
    t_len, lanes = rewards.shape
    kernels.check_cuda("values", values, torch.float32, (t_len, lanes))
    kernels.check_cuda("dones", dones, torch.float32, (t_len, lanes))
    kernels.check_cuda("last_values", last_values, torch.float32, (lanes,))
    advs = torch.empty_like(rewards)
    targets = torch.empty_like(rewards)
    if rewards.numel():
        kernels.launch("gae_normalize", rewards.data_ptr(),
                       values.data_ptr(), dones.data_ptr(),
                       last_values.data_ptr(), advs.data_ptr(),
                       targets.data_ptr(), t_len, lanes, float(gamma),
                       float(gamma * lam), int(bool(normalize)))
    return advs, targets


# --------------------------------------------------------------- loss, K8
def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Entropy of softmax(logits) per row; masked (finfo.min) logits have
    p = 0 and add nothing, nor any gradient."""
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    return -torch.sum(torch.where(p > 0, p * logp,
                                  torch.zeros((), dtype=logp.dtype)), dim=-1)


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def ppo_loss_plain(logits, values, actions, old_logp, old_values, advs,
                   targets, kl_coeff, cfg: PPOConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The clipped-surrogate PPO loss with the KL penalty on one minibatch
    (``ddls_tpu/rl/ppo.py:ppo_loss``): returns ``(total, metrics)``,
    ``metrics`` the [6] tensor in ``METRIC_KEYS`` order. ``torch.minimum``
    and ``torch.maximum`` pass half the gradient to each side at a tie, as
    ``jnp.minimum``/``jnp.maximum`` (and ``jnp.clip``, max then min) do;
    ``torch.clamp`` would pass all of it."""
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = torch.gather(logp_all, 1, actions.long()[:, None])[:, 0]
    ratio = torch.exp(logp - old_logp)
    clipped = torch.minimum(
        torch.maximum(ratio, _const(1.0 - cfg.clip_param, ratio)),
        _const(1.0 + cfg.clip_param, ratio))
    surr = torch.minimum(ratio * advs, clipped * advs)
    policy_loss = -torch.mean(surr)
    kl = torch.mean(old_logp - logp)
    vf_err = (values - targets) ** 2
    vf_clipped = old_values + torch.minimum(
        torch.maximum(values - old_values, _const(-cfg.vf_clip_param,
                                                  values)),
        _const(cfg.vf_clip_param, values))
    vf_err_clipped = (vf_clipped - targets) ** 2
    vf_loss = 0.5 * torch.mean(torch.maximum(vf_err, vf_err_clipped))
    entropy = torch.mean(categorical_entropy(logits))
    total = (policy_loss + kl_coeff * kl + cfg.vf_loss_coeff * vf_loss
             - cfg.entropy_coeff * entropy)
    clip_frac = torch.mean((torch.abs(ratio - 1.0) > cfg.clip_param).to(
        logits.dtype))
    metrics = torch.stack([policy_loss, vf_loss, kl, entropy,
                           total.to(logits.dtype), clip_frac])
    return total, metrics


def ppo_loss_grad_plain(logits, values, actions, old_logp, old_values, advs,
                        targets, kl_coeff, cfg: PPOConfig):
    """K8's whole output from the plain version: ``(total, metrics,
    d total / d logits, d total / d values)``, the gradient by autograd."""
    logits = logits.detach().requires_grad_(True)
    values = values.detach().requires_grad_(True)
    with torch.enable_grad():
        total, metrics = ppo_loss_plain(logits, values, actions, old_logp,
                                        old_values, advs, targets, kl_coeff,
                                        cfg)
        dlogits, dvalues = torch.autograd.grad(total, (logits, values))
    return total.detach(), metrics.detach(), dlogits, dvalues


# K8's launch: a row takes a group of lanes holding at most four actions
# each, a CTA up to 1,024 threads (two passes of rows before a cluster is
# worth its barriers), a cluster up to 8 CTAs (the portable size)
PPO_LOSS_THREADS = 1024
PPO_LOSS_MAX_CTAS = 8


def ppo_loss_launch(m: int, a: int) -> Tuple[int, int, int]:
    """K8's (lanes a row, threads a CTA, CTAs of the one cluster) for ``m``
    rows of ``a`` actions: functions of (M, A) alone, so are the order of
    its sums and the bits of its result."""
    lanes = 1
    while 4 * lanes < a:
        lanes *= 2
    per_pass = PPO_LOSS_THREADS // lanes
    ctas = min(PPO_LOSS_MAX_CTAS, max(1, -(-m // (2 * per_pass))))
    rows = -(-m // ctas)
    threads = 32
    while threads < min(rows * lanes, PPO_LOSS_THREADS):
        threads *= 2
    return lanes, threads, ctas


def _ppo_loss_cuda(logits, values, actions, old_logp, old_values, advs,
                   targets, kl_coeff, cfg: PPOConfig):
    """K8: (total [], metrics [6], dlogits [M, A], dvalues [M])."""
    kernels.check_cuda("logits", logits, torch.float32)
    if logits.dim() != 2 or not 0 < logits.shape[1] <= 64:
        raise ValueError(f"logits must be [M, A] with A <= 64, got "
                         f"{tuple(logits.shape)}")
    m, a = logits.shape
    for name, t in (("values", values), ("old_logp", old_logp),
                    ("old_values", old_values), ("advs", advs),
                    ("targets", targets)):
        kernels.check_cuda(name, t, torch.float32, (m,))
    kernels.check_cuda("actions", actions, torch.int32, (m,))
    kernels.check_cuda("kl_coeff", kl_coeff, torch.float32, ())
    metrics = logits.new_empty(len(METRIC_KEYS))
    total = logits.new_empty(())
    dlogits = torch.empty_like(logits)
    dvalues = torch.empty_like(values)
    if m:
        kernels.launch("ppo_loss", logits.data_ptr(), values.data_ptr(),
                       actions.data_ptr(), old_logp.data_ptr(),
                       old_values.data_ptr(), advs.data_ptr(),
                       targets.data_ptr(), kl_coeff.data_ptr(),
                       metrics.data_ptr(), total.data_ptr(),
                       dlogits.data_ptr(), dvalues.data_ptr(), m, a,
                       *ppo_loss_launch(m, a),
                       float(1.0 - cfg.clip_param),
                       float(1.0 + cfg.clip_param), float(cfg.clip_param),
                       float(cfg.vf_clip_param), float(cfg.vf_loss_coeff),
                       float(cfg.entropy_coeff))
    return total, metrics, dlogits, dvalues


class _PPOLoss(torch.autograd.Function):
    """K8 computes the gradient in the forward launch; the backward scales
    the saved gradient by the incoming one."""

    @staticmethod
    def forward(ctx, logits, values, actions, old_logp, old_values, advs,
                targets, kl_coeff, cfg):
        total, metrics, dlogits, dvalues = _ppo_loss_cuda(
            logits, values, actions, old_logp, old_values, advs, targets,
            kl_coeff, cfg)
        ctx.save_for_backward(dlogits, dvalues)
        ctx.mark_non_differentiable(metrics)
        return total, metrics

    @staticmethod
    def backward(ctx, d_total, d_metrics):
        dlogits, dvalues = ctx.saved_tensors
        return (dlogits * d_total, dvalues * d_total, None, None, None,
                None, None, None, None)


def ppo_loss(logits: torch.Tensor, values: torch.Tensor,
             actions: torch.Tensor, old_logp: torch.Tensor,
             old_values: torch.Tensor, advs: torch.Tensor,
             targets: torch.Tensor, kl_coeff: torch.Tensor, cfg: PPOConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: ``(total, metrics [6])`` of one minibatch (``ppo_loss_plain``),
    differentiable with respect to ``logits`` [M, A] (masked, float32) and
    ``values`` [M]; ``actions`` [M] int32, ``kl_coeff`` a float32 scalar
    tensor on the same device."""
    if kernels.on_cpu(logits, values, actions, old_logp, old_values, advs,
                      targets, kl_coeff):
        return ppo_loss_plain(logits, values, actions, old_logp, old_values,
                              advs, targets, kl_coeff, cfg)
    return _PPOLoss.apply(logits, values, actions, old_logp, old_values,
                          advs, targets, kl_coeff, cfg)


# -------------------------------------------------------------- the learner
class PPOLearner(Learner):
    """PPO on one device over ``model`` (a ``GNNPolicy``); acting, staging,
    batch assembly and the optimiser are ``Learner``'s. ``device`` is
    ``"cuda"`` unless the caller asks for ``"cpu"``; raises when CUDA is
    asked for and absent."""

    def init_state(self, params: Optional[Mapping[str, Any]] = None
                   ) -> TrainState:
        """``Learner.init_state`` with the KL coefficient afresh."""
        state = super().init_state(params)
        state.kl_coeff = torch.tensor(self.cfg.kl_coeff, dtype=torch.float32,
                                      device=self.device)
        return state

    # ----------------------------------------------------------- update
    def flat_advantages(self, traj: StagedTraj,
                        last_values: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """GAE of the staged trajectory (normalised advantages, value
        targets from the raw ones), each flattened to [T*B] in the
        reference's row order (``to_rows``: row = b * T + t)."""
        cfg = self.cfg
        if last_values is None:
            last_values = traj["last_values"]
        advs, targets = gae_normalize(traj["rewards"], traj["values"],
                                      traj["dones"], last_values,
                                      cfg.gamma, cfg.gae_lambda,
                                      cfg.normalize_advantages)
        return tb_to_rows(advs), tb_to_rows(targets)

    def loss_and_grads(self, state: TrainState, staged: StagedTraj,
                       idx: torch.Tensor, advs: torch.Tensor,
                       targets: torch.Tensor
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The loss of the samples ``idx`` at the current params: its
        metrics [6] (``METRIC_KEYS``) and the gradient of the total loss
        with respect to ``state.params``, on the device."""
        batch = self.minibatch(staged, idx)
        with torch.enable_grad():
            logits, values, _ = self.model.flat_batched(batch)
            total, metrics = ppo_loss(
                logits, values, staged["actions"].index_select(0, idx),
                staged["old_logp"].index_select(0, idx),
                staged["old_values"].index_select(0, idx),
                advs.index_select(0, idx), targets.index_select(0, idx),
                state.kl_coeff, self.cfg)
            grads = list(torch.autograd.grad(total, state.params))
        return metrics.detach(), grads

    def _minibatch_step(self, state: TrainState, staged: StagedTraj,
                        idx: torch.Tensor, advs: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
        """One SGD step on the samples ``idx``; returns the minibatch's
        metrics [6] (``METRIC_KEYS``) on the device."""
        metrics, grads = self.loss_and_grads(state, staged, idx, advs,
                                             targets)
        with torch.no_grad():
            self._apply_optimizer(state, grads)
        state.step += 1
        return metrics

    def train_step(self, state: TrainState, traj: StagedTraj,
                   last_values: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   perms: Optional[Any] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One PPO update on a staged [T, B] trajectory (``stage_traj``,
        which carries the bootstrap values; ``last_values``, when given,
        replaces them): GAE, then ``num_sgd_iter`` epochs of minibatches of
        ``sgd_minibatch_size`` rows of a fresh permutation each (the
        remainder of each epoch is dropped, as in the reference), then the
        adaptive-KL update. ``perms`` [num_sgd_iter, T*B] hands over the
        permutations; otherwise they are drawn with ``generator`` (a
        ``torch.Generator`` on the learner's device). Returns the state
        (updated in place) and the metrics of the last epoch, averaged over
        its minibatches, plus ``kl_coeff``: device tensors."""
        cfg = self.cfg
        advs, targets = self.flat_advantages(traj, last_values)
        n = traj.t_len * traj.lanes
        mb = max(min(cfg.sgd_minibatch_size, n), 1)
        num_mb = n // mb
        if perms is not None:
            perms = torch.as_tensor(np.asarray(perms), dtype=torch.int64)
            if tuple(perms.shape) != (cfg.num_sgd_iter, n):
                raise ValueError(f"perms must be [{cfg.num_sgd_iter}, {n}], "
                                 f"got {tuple(perms.shape)}")
            perms = perms.to(self.device)
        elif generator is None:
            raise ValueError("train_step needs perms or a torch.Generator")
        last = None
        for epoch in range(cfg.num_sgd_iter):
            perm = (perms[epoch] if perms is not None else torch.randperm(
                n, generator=generator, device=self.device))
            last = [self._minibatch_step(state, traj,
                                         perm[k * mb:(k + 1) * mb], advs,
                                         targets)
                    for k in range(num_mb)]
        values = torch.stack(last).mean(dim=0)
        metrics = {k: values[i] for i, k in enumerate(METRIC_KEYS)}
        # RLlib's adaptive KL coefficient, on the device
        kl, kc = metrics["kl"], state.kl_coeff
        state.kl_coeff = torch.where(
            kl > 2.0 * cfg.kl_target, kc * 1.5,
            torch.where(kl < 0.5 * cfg.kl_target, kc * 0.5, kc))
        metrics["kl_coeff"] = state.kl_coeff
        return state, metrics
