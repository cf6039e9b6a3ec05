"""Ape-X DQN in PyTorch: epsilon-greedy acting, n-step transitions, a
prioritised replay buffer and the double/dueling DQN update.

Counterpart of ``ddls_tpu/rl/dqn.py`` on one device (the JAX learner on a
1-device mesh): ``DQNConfig`` :44, ``per_worker_epsilons`` :88,
``dueling_q_values`` :103, ``huber`` :114, ``PrioritizedReplayBuffer``
:121 (numpy over nested dicts of arrays), ``nstep_transitions`` :183 and
``ApexDQNLearner`` :218.

Acting (``eps_greedy_actions``) is the policy's forward (K1-K3 and the heads:
raw logits and values) and K13 (``dqn_act``), which forms the dueling Q,
masks it, and picks the greedy or the uniformly random valid action from
handed-in uniforms. One update (``train_step``) stages the replay sample
(one host-to-device copy: both halves' flattened graphs, trimmed to the
serving ladder's bucket), runs three forwards (the online network on
``obs`` with gradient, the online network on ``next_obs`` and the target
network on ``next_obs`` without), K14 (``dqn_td_loss``: the TD loss, its
metrics, the new priorities and the gradient with respect to the online
forward's logits and values), autograd through K5/K6, optax's
``chain(clip_by_global_norm, adam)``, then optax's ``periodic_update`` of
the target network; the metrics and ``|td|`` come back in one read-back.

Invalid actions are masked at selection only (greedy argmax and random
exploration); the Q-network itself runs unmasked (``apply_action_mask:
false``), as in the reference.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ddls_tpu_torch import kernels
from ddls_tpu_torch.models.policy import minibatch_gather
from ddls_tpu_torch.rl.learner import Learner, TrainState, pack_to_device

DQN_METRIC_KEYS = ("loss", "mean_q", "mean_td_error", "max_td_error")


@dataclasses.dataclass
class DQNConfig:
    lr: float = 4.121e-7
    gamma: float = 0.999
    n_step: int = 3
    train_batch_size: int = 512
    target_network_update_freq: int = 100_000  # in sampled transitions
    double_q: bool = True
    dueling: bool = True
    num_atoms: int = 1  # only 1 (non-distributional) is supported
    grad_clip: Optional[float] = 40.0
    # prioritised replay (reference replay_buffer_config)
    buffer_capacity: int = 100_000
    prioritized_replay_alpha: float = 0.9
    prioritized_replay_beta: float = 0.1
    prioritized_replay_eps: float = 1e-6
    learning_starts: int = 10_000
    # ratio of trained transitions to sampled transitions
    training_intensity: float = 1.0
    # per-worker epsilon-greedy exploration
    initial_epsilon: float = 1.0
    final_epsilon: float = 0.05
    epsilon_timesteps: int = 1_000_000

    def __post_init__(self):
        if self.num_atoms != 1:
            raise NotImplementedError(
                "distributional DQN (num_atoms > 1) is not supported; the "
                "reference's tuned config uses num_atoms 1")


def per_worker_epsilons(num_envs: int, env_steps: int,
                        cfg: DQNConfig) -> np.ndarray:
    """Ape-X exploration: worker i follows the global epsilon schedule
    raised to ``1 + 7 i / (B-1)`` (Horgan et al. 2018 eq. 1 shape; the
    reference uses RLlib's PerWorkerEpsilonGreedy with initial 1 ->
    final 0.05 over 1M timesteps)."""
    frac = min(env_steps / max(cfg.epsilon_timesteps, 1), 1.0)
    base = cfg.initial_epsilon + frac * (cfg.final_epsilon
                                         - cfg.initial_epsilon)
    if num_envs == 1:
        return np.asarray([base], np.float32)
    exps = 1.0 + 7.0 * np.arange(num_envs) / (num_envs - 1)
    return (base ** exps).astype(np.float32)


def dueling_q_values(logits: torch.Tensor, values: torch.Tensor,
                     dueling: bool) -> torch.Tensor:
    """Q [N, A] from the policy net's heads: with dueling, ``(v + l) -
    mean(l)``, the mean a left-to-right sum times ``1 / A`` in the logits'
    type (as K13 and K14 take it); otherwise the logits."""
    if not dueling:
        return logits
    total = logits[:, 0]
    for j in range(1, logits.shape[1]):
        total = total + logits[:, j]
    mean = total * (1.0 / logits.shape[1])
    return values[:, None] + logits - mean[:, None]


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    absx = torch.abs(x)
    return torch.where(absx <= delta, 0.5 * x * x,
                       delta * (absx - 0.5 * delta))


# ------------------------------------------------ K13: epsilon-greedy act
def dqn_act_plain(logits, values, mask, eps, u_explore, u_pick,
                  dueling: bool) -> torch.Tensor:
    """``_masked_q`` + ``_sample_actions`` of the reference with the
    uniforms handed in: the greedy action over the valid actions' Q, the
    Gumbel-max draw ``argmax(log(mask + 1e-30) - log(-log(u_pick)))``
    (float32, as the reference's) over every action with the invalid ones
    at -69.08, and ``u_explore < eps ? drawn : greedy``. Returns int32
    [B]."""
    q = dueling_q_values(logits, values, dueling)
    masked = torch.where(mask != 0, q,
                         torch.full_like(q, torch.finfo(q.dtype).min))
    greedy = torch.argmax(masked, dim=1)
    log_mask = torch.log(mask.to(torch.float32) + 1e-30)
    drawn = torch.argmax(
        log_mask - torch.log(-torch.log(u_pick.to(torch.float32))), dim=1)
    return torch.where(u_explore < eps, drawn, greedy).to(torch.int32)


def dqn_act(logits: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
            eps: torch.Tensor, u_explore: torch.Tensor, u_pick: torch.Tensor,
            dueling: bool) -> torch.Tensor:
    """K13: actions [B] (int32) from raw ``logits`` [B, A] and ``values``
    [B] (float32), the action ``mask`` [B, A] int32, ``eps`` [B], and the
    uniforms ``u_explore`` [B] in [0, 1) and ``u_pick`` [B, A] in [tiny, 1)
    (see ``dqn_act_plain``). A <= 32."""
    if kernels.on_cpu(logits, values, mask, eps, u_explore, u_pick):
        return dqn_act_plain(logits, values, mask, eps, u_explore, u_pick,
                             dueling)
    kernels.check_cuda("logits", logits, torch.float32)
    if logits.dim() != 2 or not 0 < logits.shape[1] <= 32:
        raise ValueError(f"logits must be [B, A] with 0 < A <= 32, got "
                         f"{tuple(logits.shape)}")
    rows, a = logits.shape
    kernels.check_cuda("mask", mask, torch.int32, (rows, a))
    kernels.check_cuda("u_pick", u_pick, torch.float32, (rows, a))
    for name, t in (("values", values), ("eps", eps),
                    ("u_explore", u_explore)):
        kernels.check_cuda(name, t, torch.float32, (rows,))
    actions = torch.empty(rows, dtype=torch.int32, device=logits.device)
    if rows:
        kernels.launch("dqn_act", logits.data_ptr(), values.data_ptr(),
                       mask.data_ptr(), eps.data_ptr(), u_explore.data_ptr(),
                       u_pick.data_ptr(), actions.data_ptr(), rows, a,
                       int(bool(dueling)), 1.0 / a)
    return actions


# ----------------------------------------------------- K14: the TD loss
def dqn_td_loss_plain(logits, values, next_logits, next_values, tgt_logits,
                      tgt_values, next_mask, actions, rewards, discounts,
                      weights, double_q: bool, dueling: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's ``loss_fn`` with its metrics after the three
    forwards: ``(loss, metrics [4] in DQN_METRIC_KEYS order, |td| [N])``,
    differentiable with respect to ``logits`` and ``values`` (the online
    network on ``obs``); the next-state Q's carry no gradient."""
    q = dueling_q_values(logits, values, dueling)
    q_sel = torch.gather(q, 1, actions.long()[:, None])[:, 0]
    with torch.no_grad():
        q_target = dueling_q_values(tgt_logits, tgt_values, dueling)
        src = (dueling_q_values(next_logits, next_values, dueling)
               if double_q else q_target)
        src = torch.where(next_mask != 0, src,
                          torch.full_like(src, torch.finfo(src.dtype).min))
        best = torch.argmax(src, dim=1)
        next_q = torch.gather(q_target, 1, best[:, None])[:, 0]
        target = rewards + discounts * next_q
    td = q_sel - target
    loss = torch.mean(weights * huber(td))
    td_abs = torch.abs(td.detach())
    metrics = torch.stack([loss.detach(), torch.mean(q_sel.detach()),
                           torch.mean(td_abs), torch.max(td_abs)])
    return loss, metrics, td_abs


def dqn_td_loss_grad_plain(logits, values, *args):
    """K14's whole output from the plain version: ``(loss, metrics, |td|,
    d loss / d logits, d loss / d values)``, the gradient by autograd."""
    logits = logits.detach().requires_grad_(True)
    values = values.detach().requires_grad_(True)
    with torch.enable_grad():
        loss, metrics, td_abs = dqn_td_loss_plain(logits, values, *args)
        dlogits, dvalues = torch.autograd.grad(loss, (logits, values),
                                               allow_unused=True,
                                               materialize_grads=True)
    return loss.detach(), metrics, td_abs, dlogits, dvalues


def _dqn_td_loss_cuda(logits, values, next_logits, next_values, tgt_logits,
                      tgt_values, next_mask, actions, rewards, discounts,
                      weights, double_q: bool, dueling: bool):
    """K14: (loss [], metrics [4], |td| [N], dlogits [N, A], dvalues
    [N])."""
    kernels.check_cuda("logits", logits, torch.float32)
    if logits.dim() != 2 or not 0 < logits.shape[1] <= 32:
        raise ValueError(f"logits must be [N, A] with 0 < A <= 32, got "
                         f"{tuple(logits.shape)}")
    rows, a = logits.shape
    for name, t in (("next_logits", next_logits),
                    ("tgt_logits", tgt_logits)):
        kernels.check_cuda(name, t, torch.float32, (rows, a))
    kernels.check_cuda("next_mask", next_mask, torch.int32, (rows, a))
    kernels.check_cuda("actions", actions, torch.int32, (rows,))
    for name, t in (("values", values), ("next_values", next_values),
                    ("tgt_values", tgt_values), ("rewards", rewards),
                    ("discounts", discounts), ("weights", weights)):
        kernels.check_cuda(name, t, torch.float32, (rows,))
    rowterms = logits.new_empty((3, rows))
    metrics = logits.new_empty(len(DQN_METRIC_KEYS))
    loss = logits.new_empty(())
    td_abs = torch.empty_like(values)
    dlogits = torch.empty_like(logits)
    dvalues = torch.empty_like(values)
    if rows:
        kernels.launch("dqn_td_loss", logits.data_ptr(), values.data_ptr(),
                       next_logits.data_ptr(), next_values.data_ptr(),
                       tgt_logits.data_ptr(), tgt_values.data_ptr(),
                       next_mask.data_ptr(), actions.data_ptr(),
                       rewards.data_ptr(), discounts.data_ptr(),
                       weights.data_ptr(), rowterms.data_ptr(),
                       metrics.data_ptr(), loss.data_ptr(),
                       td_abs.data_ptr(), dlogits.data_ptr(),
                       dvalues.data_ptr(), rows, a, int(bool(double_q)),
                       int(bool(dueling)), 1.0 / a, 1.0 / rows)
    return loss, metrics, td_abs, dlogits, dvalues


class _DQNTDLoss(torch.autograd.Function):
    """K14 computes the gradient in the forward launch; the backward scales
    the saved gradient by the incoming one."""

    @staticmethod
    def forward(ctx, logits, values, *args):
        loss, metrics, td_abs, dlogits, dvalues = _dqn_td_loss_cuda(
            logits, values, *args)
        ctx.save_for_backward(dlogits, dvalues)
        ctx.mark_non_differentiable(metrics, td_abs)
        return loss, metrics, td_abs

    @staticmethod
    def backward(ctx, d_loss, d_metrics, d_td_abs):
        dlogits, dvalues = ctx.saved_tensors
        return (dlogits * d_loss, dvalues * d_loss) + (None,) * 11


def dqn_td_loss(logits: torch.Tensor, values: torch.Tensor,
                next_logits: torch.Tensor, next_values: torch.Tensor,
                tgt_logits: torch.Tensor, tgt_values: torch.Tensor,
                next_mask: torch.Tensor, actions: torch.Tensor,
                rewards: torch.Tensor, discounts: torch.Tensor,
                weights: torch.Tensor, double_q: bool, dueling: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K14: ``(loss, metrics [4], |td| [N])`` of the double/dueling TD
    update (``dqn_td_loss_plain``), differentiable with respect to the
    online forward on ``obs``: ``logits`` [N, A] and ``values`` [N]
    (float32, raw heads). ``next_*`` is the online forward on ``next_obs``
    (read only with ``double_q``), ``tgt_*`` the target network's;
    ``next_mask`` [N, A] and ``actions`` [N] int32; ``rewards``,
    ``discounts`` (gamma^n, 0 across an episode end) and the importance
    ``weights`` [N]."""
    args = (next_logits, next_values, tgt_logits, tgt_values, next_mask,
            actions, rewards, discounts, weights, double_q, dueling)
    if kernels.on_cpu(logits, values, *args[:-2]):
        return dqn_td_loss_plain(logits, values, *args)
    return _DQNTDLoss.apply(logits, values, *args)


# ------------------------------------------------------------------ replay
def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of arrays of one structure."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


class PrioritizedReplayBuffer:
    """Host-side proportional prioritised replay over n-step transitions.

    Storage is a ring of preallocated numpy arrays (allocated from the first
    transition's nested-dict structure). Sampling is proportional to
    ``priority**alpha`` with importance weights ``(N * p)**-beta``
    normalised by their max (Schaul et al. 2016), matching the reference's
    MultiAgentPrioritizedReplayBuffer configuration.
    """

    def __init__(self, capacity: int, alpha: float, beta: float,
                 eps: float, seed: int = 0):
        self.capacity = int(capacity)
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self.rng = np.random.RandomState(seed)
        self.priorities = np.zeros(self.capacity, np.float64)
        self.storage: Optional[Dict[str, Any]] = None
        self.size = 0
        self.next_idx = 0
        self.max_priority = 1.0

    def _allocate(self, transition: Dict[str, Any]) -> None:
        def alloc(x):
            x = np.asarray(x)
            return np.zeros((self.capacity,) + x.shape, x.dtype)

        self.storage = _tree_map(alloc, transition)

    def add(self, transition: Dict[str, Any]) -> None:
        if self.storage is None:
            self._allocate(transition)
        i = self.next_idx

        def write(buf, x):
            buf[i] = x
            return buf

        _tree_map(write, self.storage, transition)
        self.priorities[i] = self.max_priority ** self.alpha
        self.next_idx = (i + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def sample(self, batch_size: int) -> Tuple[Dict[str, Any], np.ndarray,
                                               np.ndarray]:
        """Returns (batch tree of [batch_size, ...], indices, IS weights)."""
        p = self.priorities[:self.size]
        probs = p / p.sum()
        idx = self.rng.choice(self.size, size=batch_size, p=probs)
        weights = (self.size * probs[idx]) ** (-self.beta)
        weights = (weights / weights.max()).astype(np.float32)
        return self.gather(idx), idx, weights

    def gather(self, idx: np.ndarray) -> Dict[str, Any]:
        """The stored transitions ``idx`` as a batch tree (``sample``'s
        first output for indices drawn elsewhere)."""
        return _tree_map(lambda buf: buf[idx], self.storage)

    def update_priorities(self, idx: np.ndarray,
                          td_errors: np.ndarray) -> None:
        pri = np.abs(td_errors) + self.eps
        self.max_priority = max(self.max_priority, float(pri.max()))
        self.priorities[idx] = pri ** self.alpha


def train_batch(batch: Mapping[str, Any], weights: np.ndarray
                ) -> Dict[str, Any]:
    """A replay batch tree (``nstep_transitions``' keys) and its importance
    weights as the learner's update batch."""
    return {"obs": batch["obs"], "actions": batch["action"],
            "rewards": batch["reward"], "next_obs": batch["next_obs"],
            "discounts": batch["discount"], "weights": weights}


def nstep_transitions(steps: List[dict], n_step: int, gamma: float,
                      flush: bool) -> List[dict]:
    """Fold a per-env step list (dicts with obs/action/reward/done/next_obs)
    into n-step transitions (Ape-X workers do this before pushing to
    replay). ``steps`` is consumed from the front; with ``flush`` the tail
    is emitted with shortened horizons (episode end), otherwise it stays
    queued until enough future steps exist."""
    out = []
    limit = len(steps) if flush else len(steps) - n_step + 1
    consumed = 0
    for t in range(max(limit, 0)):
        horizon = min(n_step, len(steps) - t)
        ret, discount = 0.0, 1.0
        done = False
        for k in range(horizon):
            ret += discount * steps[t + k]["reward"]
            discount *= gamma
            if steps[t + k]["done"]:
                done = True
                horizon = k + 1
                break
        out.append({
            "obs": steps[t]["obs"],
            "action": np.int32(steps[t]["action"]),
            "reward": np.float32(ret),
            "next_obs": steps[t + horizon - 1]["next_obs"],
            # bootstrap factor: gamma^horizon, zero across episode ends
            "discount": np.float32(0.0 if done else gamma ** horizon),
        })
        consumed += 1
    del steps[:consumed]
    return out


# ----------------------------------------------------------------- learner
class ApexDQNLearner(Learner):
    """Ape-X DQN on one device over ``model`` (a ``GNNPolicy`` whose two
    heads combine into (dueling) Q-values). The target network is a copy of
    the model whose parameters are ``state.target_params``. ``device`` is
    ``"cuda"`` unless the caller asks for ``"cpu"``; raises when CUDA is
    asked for and absent."""

    def __init__(self, model, cfg: DQNConfig, device: str = "cuda"):
        super().__init__(model, cfg, device)
        self.target_model = copy.deepcopy(self.model).requires_grad_(False)
        # target sync cadence in updates (the reference counts sampled
        # transitions; with training_intensity 1 the two agree)
        self.sync_every = max(cfg.target_network_update_freq
                              // max(cfg.train_batch_size, 1), 1)

    def init_state(self, params: Optional[Mapping[str, Any]] = None
                   ) -> TrainState:
        """``Learner.init_state``, with the target network a copy of the
        params (the reference's ``DQNTrainState.create``)."""
        state = super().init_state(params)
        live = dict(self.target_model.named_parameters())
        state.target_params = [live[n] for n in self.names]
        with torch.no_grad():
            for dst, src in zip(state.target_params, state.params):
                dst.copy_(src)
        return state

    # ------------------------------------------------------------ acting
    def eps_greedy_actions(self, obs: Mapping[str, Any], eps: np.ndarray,
                           u_explore: torch.Tensor, u_pick: torch.Tensor
                           ) -> np.ndarray:
        """Per-env epsilon-greedy over valid actions (``_sample_actions``
        of the reference): the forward and K13 with ``eps`` [B] (host) and
        the uniforms ``u_explore`` [B] and ``u_pick`` [B, A] on the
        learner's device -> host actions [B] int32."""
        arrays = self.host_batch(obs)
        arrays["eps"] = np.asarray(eps, np.float32)
        with torch.no_grad():
            batch = pack_to_device(arrays, self.device)
            logits, values = self.model.trunk(batch)
            actions = dqn_act(logits, values, batch["action_mask"],
                              batch["eps"], u_explore, u_pick,
                              self.cfg.dueling)
            return actions.cpu().numpy()

    def greedy_actions(self, obs: Mapping[str, Any]) -> np.ndarray:
        """K13 at epsilon 0: the greedy action over the valid actions."""
        b, a = np.shape(obs["action_mask"])
        zeros = torch.zeros(b, dtype=self.dtype, device=self.device)
        return self.eps_greedy_actions(
            obs, np.zeros(b, np.float32), zeros,
            torch.full((b, a), 0.5, dtype=self.dtype, device=self.device))

    # ------------------------------------------------------------ update
    def stage_batch(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """A replay sample (``obs`` and ``next_obs`` dicts of [N, ...] host
        arrays at the env's pad, ``actions``, ``rewards``, ``discounts``,
        ``weights`` [N]) on the device in one host-to-device copy, each
        half's rows at the smallest bucket that holds them, then each half
        as one flattened graph by K20 (``minibatch_gather``)."""
        fdt = np.dtype(str(self.dtype).replace("torch.", ""))
        arrays, buckets = {}, {}
        for half in ("obs", "next_obs"):
            rows, n_b, e_b = self.row_arrays(batch[half])
            arrays.update({f"{half}/{k}": v for k, v in rows.items()})
            buckets[half] = (n_b, e_b)
        arrays["actions"] = np.asarray(batch["actions"], np.int32)
        for key in ("rewards", "discounts", "weights"):
            arrays[key] = np.asarray(batch[key], fdt)
        dev = pack_to_device(arrays, self.device)
        staged: Dict[str, Any] = {}
        rows = {"obs": {}, "next_obs": {}}
        for key, value in dev.items():
            half, _, name = key.rpartition("/")
            if half:
                rows[half][name] = value
            else:
                staged[key] = value
        idx = self._positions(len(arrays["actions"]))
        for half, (n_b, e_b) in buckets.items():
            staged[half] = minibatch_gather(rows[half], idx, n_b, e_b)
        return staged

    def loss_and_grads(self, state: TrainState, staged: Mapping[str, Any]
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  List[torch.Tensor]]:
        """The loss at the current params: its metrics [4]
        (``DQN_METRIC_KEYS``), ``|td|`` [N] and the gradient with respect
        to ``state.params``."""
        cfg = self.cfg
        nxt = staged["next_obs"]
        with torch.no_grad():
            tgt_logits, tgt_values = self.target_model.trunk(nxt)
            next_logits, next_values = (self.model.trunk(nxt)
                                        if cfg.double_q
                                        else (tgt_logits, tgt_values))
        with torch.enable_grad():
            logits, values = self.model.trunk(staged["obs"])
            loss, metrics, td_abs = dqn_td_loss(
                logits, values, next_logits, next_values, tgt_logits,
                tgt_values, nxt["action_mask"], staged["actions"],
                staged["rewards"], staged["discounts"], staged["weights"],
                cfg.double_q, cfg.dueling)
            grads = self._loss_grads(loss, state)
        return metrics, td_abs, grads

    def train_step(self, state: TrainState, batch: Mapping[str, Any]
                   ) -> Tuple[TrainState, Dict[str, float], np.ndarray]:
        """One update on a replay sample (host arrays, see
        ``stage_batch``): returns the state (updated in place), the metrics
        (``DQN_METRIC_KEYS``) as floats and ``|td|`` [N] for the priority
        update, read back together in one copy."""
        metrics, td_abs, grads = self.loss_and_grads(
            state, self.stage_batch(batch))
        with torch.no_grad():
            self._apply_optimizer(state, grads)
            state.step += 1
            # optax.periodic_update: the target takes the new params every
            # sync_every updates
            if state.step % self.sync_every == 0:
                torch._foreach_copy_(state.target_params, state.params)
            packed = torch.cat([metrics, td_abs]).cpu().numpy()
        return (state, dict(zip(DQN_METRIC_KEYS,
                                packed[:len(DQN_METRIC_KEYS)].tolist())),
                packed[len(DQN_METRIC_KEYS):])
