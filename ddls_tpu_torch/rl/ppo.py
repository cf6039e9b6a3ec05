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

Minibatches are assembled on the device: ``stage_traj`` copies the
trajectory to the card once (one host-to-device copy), with every sample's
flattened-graph arrays and both CSRs built on the host at that point;
per minibatch the samples are gathered and their CSRs offset and
concatenated with a few tensor ops, with no host round trip.

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
from ddls_tpu_torch.models.policy import (GRAD_INPUT_KEYS, GNNPolicy,
                                          prepare_flat_batch)
from ddls_tpu_torch.serve.bucketing import default_buckets
from ddls_tpu_torch.serve.server import resolve_device

METRIC_KEYS = ("policy_loss", "vf_loss", "kl", "entropy", "total_loss",
               "clip_frac")
# optax.adam's defaults (ddls_tpu/rl/ppo.py:204-208 takes optax.adam(lr))
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


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
# algo_config keys that an epoch loop consumes, not the learner
_LOOP_LEVEL_ALGO_KEYS = {"num_workers", "device_collector",
                         "device_bank_jobs", "use_jax_lookahead_memo"}


def ppo_config_from_rllib(algo_config: Optional[Mapping[str, Any]]
                          ) -> PPOConfig:
    """Translate an RLlib-style PPO config dict (``algo/ppo.yaml``'s
    ``algo_config``) into a ``PPOConfig``; raises on a key nothing
    consumes, so a swept hyperparameter can never be a silent no-op."""
    keys = set(algo_config or {})
    unknown = sorted(keys - set(_RLLIB_TO_PPO) - _LOOP_LEVEL_ALGO_KEYS)
    if unknown:
        raise ValueError(
            f"ppo algo_config keys {unknown} are not consumed; remove them. "
            f"Known keys: "
            f"{sorted(set(_RLLIB_TO_PPO) | _LOOP_LEVEL_ALGO_KEYS)}")
    kwargs = {}
    for src, dst in _RLLIB_TO_PPO.items():
        if algo_config and algo_config.get(src) is not None:
            kwargs[dst] = algo_config[src]
    return PPOConfig(**kwargs)


@dataclasses.dataclass
class TrainState:
    """The learner's state. ``params`` are the learner's model's own
    parameters, updated in place by ``train_step`` (a later ``init_state``
    overwrites them); ``mu``/``nu`` are adam's moments in ``names`` order;
    ``kl_coeff`` is a float32 scalar on the device (float32 as in the JAX
    ``TrainState``); ``step`` counts minibatch updates (adam's count)."""
    names: List[str]
    params: List[torch.Tensor]
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    kl_coeff: torch.Tensor
    step: int = 0

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in zip(self.names, self.params)}


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
    rowterms = logits.new_empty((5, m))
    metrics = logits.new_empty(len(METRIC_KEYS))
    total = logits.new_empty(())
    dlogits = torch.empty_like(logits)
    dvalues = torch.empty_like(values)
    if m:
        kernels.launch("ppo_loss", logits.data_ptr(), values.data_ptr(),
                       actions.data_ptr(), old_logp.data_ptr(),
                       old_values.data_ptr(), advs.data_ptr(),
                       targets.data_ptr(), kl_coeff.data_ptr(),
                       rowterms.data_ptr(), metrics.data_ptr(),
                       total.data_ptr(), dlogits.data_ptr(),
                       dvalues.data_ptr(), m, a,
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


# ------------------------------------------------------- staged trajectory
_TRAJ_OBS_KEYS = ("node_features", "edge_features", "graph_features",
                  "edges_src", "edges_dst", "node_split", "edge_split",
                  "action_mask")


def trim_bucket(node_split: np.ndarray, edge_split: np.ndarray,
                max_nodes: int, max_edges: int) -> Tuple[int, int]:
    """The smallest bucket of the serving ladder (``default_buckets`` of
    the pad bounds) that holds every sample's real nodes and edges. Padded
    rows get zero gradient and never reach a real row, so a trajectory
    trimmed to it trains the same real rows as at the full pad."""
    n_real = int(np.max(node_split)) if np.size(node_split) else 0
    e_real = int(np.max(edge_split)) if np.size(edge_split) else 0
    for n, e in default_buckets(max_nodes, max_edges):
        if n >= n_real and e >= e_real:
            return n, e
    return max_nodes, max_edges


def _sample_structure(obs: Dict[str, np.ndarray]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Per sample, the int32 row ``[src E | edge_dst E | dst row_ptr N+1 |
    dst col E | src row_ptr N+1 | src col E]`` of its own flattened graph
    (a batch of one) and its float node mask [N]: what the device offsets
    and concatenates into a minibatch."""
    n = obs["node_features"].shape[0]
    rows, masks = [], []
    for i in range(n):
        one = {k: obs[k][i:i + 1] for k in _TRAJ_OBS_KEYS}
        host = prepare_flat_batch(one)
        rows.append(np.concatenate([
            host["src"], host["edge_dst"], host["csr_row_ptr"],
            host["csr_col"], host["src_csr_row_ptr"], host["src_csr_col"]]))
        masks.append(host["node_mask"])
    return np.stack(rows).astype(np.int32), np.stack(masks)


@dataclasses.dataclass
class StagedTraj:
    """A trajectory on the learner's device (``PPOLearner.stage_traj``):
    per-sample rows in the B-major order of the reference's ``to_rows``
    (row = b * T + t), the [T, B] reward/value/done arrays for GAE, and
    each sample's flattened-graph structure, at the bucket (n_nodes,
    n_edges)."""
    tensors: Dict[str, torch.Tensor]
    t_len: int
    lanes: int
    n_nodes: int
    n_edges: int

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.tensors[key]


def _pack_to_device(arrays: Dict[str, np.ndarray], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """Every array in one pinned byte buffer, one host-to-device copy, then
    a typed view per array."""
    layout, offset = [], 0
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        offset = -(-offset // 8) * 8
        layout.append((name, arr, offset))
        offset += arr.nbytes
    host = torch.empty(max(offset, 1), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    flat = host.numpy()
    for _, arr, off in layout:
        flat[off:off + arr.nbytes] = arr.view(np.uint8).reshape(-1)
    dev = host.to(device, non_blocking=True)
    out = {}
    for name, arr, off in layout:
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        out[name] = dev[off:off + arr.nbytes].view(dtype).view(arr.shape)
    return out


# -------------------------------------------------------------- the learner
class PPOLearner:
    """PPO on one device over ``model`` (a ``GNNPolicy``). ``device`` is
    ``"cuda"`` unless the caller asks for ``"cpu"``; raises when CUDA is
    asked for and absent. The learner's float type is the model's (float32
    on the card; the CPU parity runs use float64)."""

    def __init__(self, model: GNNPolicy, cfg: PPOConfig,
                 device: str = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.dtype = next(model.parameters()).dtype
        self.names = sorted(n for n, _ in model.named_parameters())
        self._arange: Dict[int, torch.Tensor] = {}

    # ------------------------------------------------------------- state
    def init_state(self, params: Optional[Mapping[str, Any]] = None
                   ) -> TrainState:
        """Copy ``params`` (a state dict; default: the model's current
        parameters) into the model and start adam and the KL coefficient
        afresh."""
        live = dict(self.model.named_parameters())
        with torch.no_grad():
            if params is not None:
                missing = sorted(set(self.names) - set(params))
                if missing:
                    raise ValueError(f"params lack {missing}")
                for name in self.names:
                    live[name].copy_(torch.as_tensor(params[name]))
        plist = [live[n] for n in self.names]
        return TrainState(
            names=list(self.names), params=plist,
            mu=[torch.zeros_like(p) for p in plist],
            nu=[torch.zeros_like(p) for p in plist],
            kl_coeff=torch.tensor(self.cfg.kl_coeff, dtype=torch.float32,
                                  device=self.device))

    # ------------------------------------------------------------- acting
    def device_batch(self, obs: Mapping[str, Any]
                     ) -> Dict[str, torch.Tensor]:
        """A stacked host observation batch (the ``envs/obs.py`` keys, [B,
        ...] at the env's pad) as the forward's flattened-graph batch on
        the learner's device, trimmed to the smallest bucket of the serving
        ladder that holds it (as ``stage_traj`` trims) and copied in one
        host-to-device copy."""
        obs = {k: np.asarray(obs[k]) for k in _TRAJ_OBS_KEYS}
        n_b, e_b = trim_bucket(obs["node_split"], obs["edge_split"],
                               obs["node_features"].shape[1],
                               obs["edge_features"].shape[1])
        obs["node_features"] = obs["node_features"][:, :n_b]
        for key in ("edge_features", "edges_src", "edges_dst"):
            obs[key] = obs[key][:, :e_b]
        fdt = np.dtype(str(self.dtype).replace("torch.", ""))
        host = prepare_flat_batch(obs)
        arrays = {k: (v.astype(fdt) if v.dtype.kind == "f" else v)
                  for k, v in host.items() if k not in GRAD_INPUT_KEYS}
        return _pack_to_device(arrays, self.device)

    def sample_actions(self, obs: Mapping[str, Any], u: torch.Tensor
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched action sampling (``_sample_actions`` of the reference):
        the forward and K9 with the uniforms ``u`` [B, A] on the learner's
        device -> host (actions [B] int32, logp [B], values [B]) in one
        read-back."""
        with torch.no_grad():
            actions, logp, values = self.model.sample_batched(
                self.device_batch(obs), u)
            packed = torch.stack([actions.to(logp.dtype), logp,
                                  values]).cpu().numpy()
        return packed[0].astype(np.int32), packed[1], packed[2]

    def values(self, obs: Mapping[str, Any]) -> np.ndarray:
        """The value head alone on a stacked batch (the rollout's bootstrap
        values: no action is sampled, so K9 is not launched)."""
        with torch.no_grad():
            _, values = self.model.trunk(self.device_batch(obs))
            return values.cpu().numpy()

    def greedy_actions(self, obs: Mapping[str, Any]) -> np.ndarray:
        """Greedy actions of a stacked batch: the forward and K4."""
        with torch.no_grad():
            _, _, actions = self.model.flat_batched(self.device_batch(obs))
            return actions.cpu().numpy()

    # ------------------------------------------------------------ staging
    def stage_traj(self, traj: Mapping[str, Any], last_values: Any
                   ) -> StagedTraj:
        """Stage a host trajectory (``obs`` dict of [T, B, ...] arrays at
        the env's pad, ``actions``, ``logp``, ``values``, ``rewards``,
        ``dones`` [T, B]; ``last_values`` [B]) on the device with one
        host-to-device copy. The observations are trimmed to the smallest
        bucket of the serving ladder that holds every sample (see
        ``trim_bucket``), and every sample's flattened graph and both CSRs
        are built here, once."""
        obs = {k: np.asarray(traj["obs"][k]) for k in _TRAJ_OBS_KEYS}
        t_len, lanes = np.shape(traj["rewards"])
        n_pad, e_pad = obs["node_features"].shape[2], obs[
            "edge_features"].shape[2]
        n_b, e_b = trim_bucket(obs["node_split"], obs["edge_split"], n_pad,
                               e_pad)
        obs["node_features"] = obs["node_features"][:, :, :n_b]
        for key in ("edge_features", "edges_src", "edges_dst"):
            obs[key] = obs[key][:, :, :e_b]
        # the reference's to_rows: [T, B, ...] -> [B, T, ...] -> [B*T, ...]
        rows = {k: np.swapaxes(v, 0, 1).reshape((t_len * lanes,)
                                                + v.shape[2:])
                for k, v in obs.items()}
        n_actions = rows["action_mask"].shape[1]
        actions = np.swapaxes(np.asarray(traj["actions"]), 0, 1).reshape(-1)
        if actions.size and (actions.min() < 0
                             or actions.max() >= n_actions):
            raise ValueError(f"actions must lie in [0, {n_actions})")
        # (prepare_flat_batch, per sample, validates every real edge)
        structure, node_mask = _sample_structure(rows)
        fdt = np.dtype(str(self.dtype).replace("torch.", ""))

        def to_rows(x):
            return np.swapaxes(np.asarray(x), 0, 1).reshape(-1)

        arrays = {
            "node_features": rows["node_features"].astype(fdt),
            "edge_features": rows["edge_features"].astype(fdt),
            "graph_features": rows["graph_features"].astype(fdt),
            "action_mask": rows["action_mask"].astype(np.int32),
            "structure": structure, "node_mask": node_mask.astype(fdt),
            "actions": actions.astype(np.int32),
            "old_logp": to_rows(traj["logp"]).astype(fdt),
            "old_values": to_rows(traj["values"]).astype(fdt),
            "rewards": np.asarray(traj["rewards"], fdt),
            "values": np.asarray(traj["values"], fdt),
            "dones": np.asarray(traj["dones"]).astype(fdt),
            "last_values": np.asarray(last_values, fdt),
        }
        return StagedTraj(_pack_to_device(arrays, self.device), t_len, lanes,
                          n_b, e_b)

    def _positions(self, n: int) -> torch.Tensor:
        out = self._arange.get(n)
        if out is None:
            out = self._arange[n] = torch.arange(n, dtype=torch.int32,
                                                 device=self.device)
        return out

    def _offset_csr(self, row_ptr, col, m: int, n_nodes: int,
                    n_edges: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Concatenate m per-sample CSRs ([m, N+1] local row_ptr, [m, E]
        local col) into the flattened graph's: row_ptr shifted by the
        running edge count, col by each sample's edge offset and packed
        after the previous sample's real edges (``build_csr``'s layout;
        entries past the last real edge are 0)."""
        nnz = row_ptr[:, n_nodes]
        start = torch.cumsum(nnz, 0, dtype=torch.int32) - nnz
        flat_ptr = torch.cat([(row_ptr[:, :n_nodes]
                               + start[:, None]).reshape(-1),
                              (start[-1:] + nnz[-1:])])
        pos_e = self._positions(n_edges)
        slot = torch.where(pos_e[None, :] < nnz[:, None],
                           start[:, None] + pos_e[None, :],
                           torch.full_like(start[:, None], m * n_edges))
        edge_off = (self._positions(m) * n_edges)[:, None]
        flat_col = torch.zeros(m * n_edges + 1, dtype=torch.int32,
                               device=self.device)
        flat_col.scatter_(0, slot.reshape(-1).long(),
                          (col + edge_off).reshape(-1))
        return flat_ptr, flat_col[:-1]

    def minibatch(self, staged: StagedTraj, idx: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        """The flattened-graph batch of the samples ``idx`` [M] (int64 on
        the device), assembled on the device: equal, array for array, to
        ``prepare_flat_batch`` of the same samples."""
        n, e = staged.n_nodes, staged.n_edges
        m = idx.shape[0]
        s = staged["structure"].index_select(0, idx)
        p = 0
        parts = []
        for width in (e, e, n + 1, e, n + 1, e):
            parts.append(s[:, p:p + width])
            p += width
        src, edge_dst, dst_ptr, dst_col, src_ptr, src_col = parts
        node_off = (self._positions(m) * n)[:, None]
        row_ptr, col = self._offset_csr(dst_ptr, dst_col, m, n, e)
        s_row_ptr, s_col = self._offset_csr(src_ptr, src_col, m, n, e)
        return {
            "node_features": staged["node_features"].index_select(0, idx),
            "edge_features": staged["edge_features"].index_select(0, idx),
            "graph_features": staged["graph_features"].index_select(0, idx),
            "action_mask": staged["action_mask"].index_select(0, idx),
            "src": (src + node_off).reshape(-1),
            "node_mask": staged["node_mask"].index_select(0, idx).reshape(
                -1),
            "csr_row_ptr": row_ptr, "csr_col": col,
            "edge_dst": torch.where(edge_dst >= 0, edge_dst + node_off,
                                    edge_dst).reshape(-1),
            "src_csr_row_ptr": s_row_ptr, "src_csr_col": s_col,
        }

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
        return advs.t().reshape(-1), targets.t().reshape(-1)

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

    def _apply_optimizer(self, state: TrainState,
                         grads: List[torch.Tensor]) -> None:
        """optax's ``chain(clip_by_global_norm(grad_clip), adam(lr))`` then
        ``apply_updates``, in its arithmetic: keep ``g`` where the global
        norm is below ``grad_clip``, else ``g / norm * grad_clip`` (chosen
        on the device, no host round trip); ``mu = (1 - b1) g + b1 mu``,
        ``nu = (1 - b2) g^2 + b2 nu``, ``update = mu_hat / (sqrt(nu_hat) +
        eps)`` with ``x_hat = x / (1 - b^count)``, ``p += -lr update``."""
        cfg = self.cfg
        if cfg.grad_clip is not None:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            keep = norm < cfg.grad_clip
            one = torch.ones((), dtype=norm.dtype, device=norm.device)
            grads = torch._foreach_div(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(
                keep, one, torch.full_like(one, cfg.grad_clip)))
        count = state.step + 1
        scaled = torch._foreach_mul(grads, 1.0 - ADAM_B1)
        torch._foreach_mul_(state.mu, ADAM_B1)
        torch._foreach_add_(state.mu, scaled)
        squared = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(squared, 1.0 - ADAM_B2)
        torch._foreach_mul_(state.nu, ADAM_B2)
        torch._foreach_add_(state.nu, squared)
        mu_hat = torch._foreach_div(state.mu, 1.0 - ADAM_B1 ** count)
        denom = torch._foreach_div(state.nu, 1.0 - ADAM_B2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        updates = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(updates, -cfg.lr)
        torch._foreach_add_(state.params, updates)

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
