"""Evolution strategies in PyTorch: antithetic parameter perturbations,
centred-rank fitness shaping and an adam step on the score-function
gradient estimate (Salimans et al. 2017, arXiv 1703.03864).

Counterpart of ``ddls_tpu/rl/es.py`` on one device: ``ESConfig`` :32,
``centered_ranks`` :63 and ``ESLearner`` :71. The learner's parameters
travel as one flat vector in ``Learner.names`` order (``flat``), so a
population is a [P, n] stack and its noise a [P/2, n] buffer of per-leaf
slices.

* ``perturb`` draws the noise with ``torch.randn`` from an explicit
  generator and returns the antithetic stack ``theta +- sigma eps``, plain
  tensor code (the reference computes it outside its update too).
* ``pop_actions`` runs one forward per member on that member's own
  observation with the member's parameters (``torch.func.functional_call``:
  P forwards a step, K1-K3 and the heads each), then K16 (``es_act``),
  the noisy greedy pick over the masked logits.
* ``update`` is K15 (``es_update``: the centred ranks, the rank-weighted
  noise sum, the L2 term, the fitness metrics and the gradient's global
  norm) followed by optax's ``adam(stepsize)``, with no clip.
* ``evaluate_population`` and ``evaluate_mean_params`` step the envs for
  a window; fitness sums the rewards in float64, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ddls_tpu_torch import kernels
from ddls_tpu_torch.models.policy import FLOAT32_MIN
from ddls_tpu_torch.rl.learner import (TRAJ_OBS_KEYS, Learner, TrainState,
                                       pack_to_device)

ES_METRIC_KEYS = ("fitness_mean", "fitness_max", "fitness_std", "grad_norm")


@dataclasses.dataclass
class ESConfig:
    # reference es.yaml surface
    stepsize: float = 0.01
    noise_stdev: float = 0.02
    l2_coeff: float = 0.005
    episodes_per_batch: int = 1000
    report_length: int = 10
    # probability that an epoch also evaluates the UNPERTURBED mean params
    # (reported as eval_fitness_mean, never folded into the gradient)
    eval_prob: float = 0.03
    # Gaussian noise on the policy's action logits during fitness rollouts
    # (the discrete analogue of RLlib's action_noise_std; 0 = greedy)
    action_noise_std: float = 0.01
    train_batch_size: int = 2000

    @property
    def lr(self) -> float:
        """The adam step size, under the name ``Learner`` reads."""
        return self.stepsize

    @property
    def grad_clip(self) -> None:
        """``optax.adam(stepsize)`` alone: no clip."""
        return None


def _ranks(fitness: torch.Tensor) -> torch.Tensor:
    """``argsort(argsort(f))`` (stable, NaN above every number, -0 equal to
    0, as ``jnp.argsort`` orders them), in the fitness's type."""
    p = fitness.shape[0]
    nan = torch.isnan(fitness)
    idx = torch.arange(p, device=fitness.device)
    earlier = idx[None, :] < idx[:, None]  # [i, j]: j before i in index
    f_i, f_j = fitness[:, None], fitness[None, :]
    before = torch.where(
        nan[:, None], ~nan[None, :] | earlier,
        ~nan[None, :] & ((f_j < f_i) | ((f_j == f_i) & earlier)))
    return before.sum(dim=1).to(fitness.dtype)


def centered_ranks(fitness: torch.Tensor) -> torch.Tensor:
    """Fitness [P] -> centred ranks in [-0.5, 0.5]: the ranks (``_ranks``)
    over ``max(P - 1, 1)``, minus 0.5, in the fitness's type (the
    reference's eager ``centered_ranks``, which divides)."""
    ranks = _ranks(fitness)
    # a tensor denominator: true division on every device (a scalar would
    # become a multiplication by its reciprocal on the card)
    return ranks / torch.full_like(ranks, max(fitness.shape[0] - 1, 1)) - 0.5


def rank_weights(fitness: torch.Tensor) -> torch.Tensor:
    """The centred ranks as the reference's jitted ``_update`` computes
    them: XLA turns the division by the constant ``max(P - 1, 1)`` into a
    product with its reciprocal rounded to float32 once and fuses the
    ``- 0.5``, so each weight is ``fma(rank, f32(1 / (P - 1)), -0.5)``,
    rounded once (exact in float64, then rounded to the fitness's type).
    For P = 10 some weights are one float32 step off ``centered_ranks``'s
    quotients."""
    ranks = _ranks(fitness)
    recip = float(np.float32(1.0) / np.float32(max(fitness.shape[0] - 1, 1)))
    return (ranks.double() * recip - 0.5).to(fitness.dtype)


# ---------------------------------------------- K15: the ES gradient
def es_update_plain(fitness: torch.Tensor, eps: torch.Tensor,
                    theta: torch.Tensor, sigma: float, l2: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ESLearner._update``'s gradient and metrics (reference :172-197):
    ``fitness`` [P] float32, ``eps`` [P/2, n] and ``theta`` [n] in the
    parameters' type -> (g [n], metrics [4] in ``ES_METRIC_KEYS`` order,
    the rank weights [P] float32). ``g = -sum_k pw_k eps_k / (P sigma) +
    l2 theta`` with ``pw_k = w_k - w_{k + P/2}`` (``rank_weights``), the
    sum in pair order. In float32 it is the jitted reference's arithmetic
    on XLA's CPU backend, operation for operation: ``acc = pw_0 eps_0``,
    then ``acc = fma(pw_k, eps_k, acc)``; ``g = fma(l2, theta, (-acc) *
    f32(1 / (P sigma)))`` (each fma exact in float64, then rounded once).
    In float64 the same formula, a multiply and an add each."""
    p = fitness.shape[0]
    weights = rank_weights(fitness)
    half = p // 2
    pair_w = (weights[:half] - weights[half:]).to(eps.dtype)
    if eps.dtype == torch.float32:
        acc = pair_w[0] * eps[0]
        for k in range(1, half):
            acc = (pair_w[k].double() * eps[k].double()
                   + acc.double()).float()
        scale = float(np.float32(1.0) / np.float32(p * sigma))
        g = (float(np.float32(l2)) * theta.double()
             + ((-acc) * scale).double()).float()
    else:
        acc = pair_w[0] * eps[0]
        for k in range(1, half):
            acc = acc + pair_w[k] * eps[k]
        g = -acc * (1.0 / (p * sigma)) + l2 * theta
    metrics = torch.stack([fitness.mean(), fitness.max(),
                           fitness.std(correction=0)]).to(g.dtype)
    metrics = torch.cat([metrics, torch.linalg.vector_norm(g)[None]])
    return g, metrics, weights


def es_update(fitness: torch.Tensor, eps: torch.Tensor, theta: torch.Tensor,
              sigma: float, l2: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K15: ``(g [n], metrics [4], centred ranks [P])`` from the fitness
    [P] float32 (P even, at most 1024), the noise [P/2, n] and the
    parameters [n] (float32 on the card; see ``es_update_plain``)."""
    if kernels.on_cpu(fitness, eps, theta):
        return es_update_plain(fitness, eps, theta, sigma, l2)
    p = fitness.shape[0]
    kernels.check_cuda("fitness", fitness, torch.float32, (p,))
    if p < 2 or p % 2 or p > 1024:
        raise ValueError(f"the population must be even, 2..1024, got {p}")
    kernels.check_cuda("theta", theta, torch.float32)
    if theta.dim() != 1:
        raise ValueError(f"theta must be [n], got {tuple(theta.shape)}")
    n = theta.shape[0]
    kernels.check_cuda("eps", eps, torch.float32, (p // 2, n))
    grads = torch.empty_like(theta)
    weights = torch.empty_like(fitness)
    metrics = theta.new_empty(len(ES_METRIC_KEYS))
    if n:
        kernels.launch("es_update", fitness.data_ptr(), eps.data_ptr(),
                       theta.data_ptr(), grads.data_ptr(),
                       weights.data_ptr(), metrics.data_ptr(), p, n,
                       p * sigma, float(l2))
    return grads, metrics, weights


# ------------------------------------------------ K16: the noisy argmax
def es_act_plain(logits: torch.Tensor, mask: torch.Tensor,
                 noise: torch.Tensor, std: float) -> torch.Tensor:
    """``argmax((logits + max(log mask, finfo(float32).min)) + std
    noise)`` per member (the first maximum): the reference's
    ``_mask_logits`` then ``_pop_actions``'s noisy argmax. int32 [P]."""
    floor = torch.clamp(torch.log(mask.to(logits.dtype)), min=FLOAT32_MIN)
    return torch.argmax((logits + floor) + std * noise,
                        dim=1).to(torch.int32)


def es_act(logits: torch.Tensor, mask: torch.Tensor, noise: torch.Tensor,
           std: float) -> torch.Tensor:
    """K16: actions [P] (int32) from raw ``logits`` [P, A] float32, the
    action ``mask`` [P, A] int32 and the ``noise`` [P, A] float32 scaled by
    ``std`` (see ``es_act_plain``). A <= 32."""
    if kernels.on_cpu(logits, mask, noise):
        return es_act_plain(logits, mask, noise, std)
    kernels.check_cuda("logits", logits, torch.float32)
    if logits.dim() != 2 or not 0 < logits.shape[1] <= 32:
        raise ValueError(f"logits must be [P, A] with 0 < A <= 32, got "
                         f"{tuple(logits.shape)}")
    rows, a = logits.shape
    kernels.check_cuda("mask", mask, torch.int32, (rows, a))
    kernels.check_cuda("noise", noise, torch.float32, (rows, a))
    actions = torch.empty(rows, dtype=torch.int32, device=logits.device)
    if rows:
        kernels.launch("es_act", logits.data_ptr(), mask.data_ptr(),
                       noise.data_ptr(), actions.data_ptr(), rows, a,
                       float(std))
    return actions


# ----------------------------------------------------------------- learner
class _Trunk(nn.Module):
    """``model.trunk`` as a module's forward, for ``functional_call``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return self.model.trunk(batch)


class ESLearner(Learner):
    """Population ES on one device over ``model`` (a ``GNNPolicy``; the
    value head is unused). ``population`` must be even (antithetic pairs).
    ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``; raises
    when CUDA is asked for and absent."""

    def __init__(self, model, cfg: ESConfig, population: int,
                 device: str = "cuda"):
        if population % 2 != 0:
            raise ValueError(f"ES population must be even (antithetic "
                             f"pairs), got {population}")
        super().__init__(model, cfg, device)
        self.population = int(population)
        self._trunk = _Trunk(self.model)
        live = dict(self.model.named_parameters())
        self.shapes = [tuple(live[n].shape) for n in self.names]
        self.sizes = [live[n].numel() for n in self.names]

    # -------------------------------------------------------- flat params
    def flat(self, params) -> torch.Tensor:
        """A parameter list in ``names`` order (or a state dict) as one
        flat vector [n]."""
        if isinstance(params, Mapping):
            params = [params[n] for n in self.names]
        return torch.cat([torch.as_tensor(p).reshape(-1) for p in params])

    def unflat(self, vector: torch.Tensor) -> List[torch.Tensor]:
        """A flat [n] vector as per-leaf views in ``names`` order."""
        return [part.view(shape) for part, shape in
                zip(torch.split(vector, self.sizes), self.shapes)]

    # -------------------------------------------------------- population
    def perturb(self, params: List[torch.Tensor],
                generator: torch.Generator
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The antithetic population of ``params``: noise eps [P/2, n] from
        ``generator`` (standard normal, the learner's type and device) and
        the stack [P, n] of ``theta + sigma eps`` then ``theta - sigma
        eps``."""
        theta = self.flat(params)
        eps = torch.randn((self.population // 2, theta.shape[0]),
                          generator=generator, dtype=theta.dtype,
                          device=theta.device)
        return self.stack(theta, eps), eps

    def stack(self, theta: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """[P, n]: ``theta + sigma eps`` for the first half, ``theta -
        sigma eps`` for the second (the reference's ``_perturb``)."""
        scaled = self.cfg.noise_stdev * eps
        return torch.cat([theta[None] + scaled, theta[None] - scaled])

    def pop_actions(self, stacked: torch.Tensor, obs: Mapping[str, Any],
                    noise: torch.Tensor, noise_std: float) -> np.ndarray:
        """Member p's action on its own env (``obs`` [P, ...] host arrays):
        one forward per member with its row of ``stacked`` as the model's
        parameters (all members' batches in one host-to-device copy), then
        K16 with ``noise`` [P, A] on the device scaled by ``noise_std``.
        Returns host actions [P] int32."""
        arrays = {}
        for p in range(self.population):
            member = {k: np.asarray(obs[k])[p:p + 1] for k in TRAJ_OBS_KEYS}
            arrays.update({f"{p}/{k}": v for k, v in
                           self.host_batch(member).items()})
        mask = np.asarray(obs["action_mask"], np.int32)
        arrays["mask"] = mask if self.model.apply_action_mask \
            else np.ones_like(mask)
        dev = pack_to_device(arrays, self.device)
        logits = []
        with torch.no_grad():
            for p in range(self.population):
                batch = {k.partition("/")[2]: v for k, v in dev.items()
                         if k.partition("/")[0] == str(p)}
                params = {f"model.{n}": t for n, t in
                          zip(self.names, self.unflat(stacked[p]))}
                member_logits, _ = torch.func.functional_call(
                    self._trunk, params, (batch,))
                logits.append(member_logits)
            actions = es_act(torch.cat(logits), dev["mask"], noise,
                             noise_std)
            return actions.cpu().numpy()

    # ------------------------------------------------------------ update
    def update(self, state: TrainState, eps: torch.Tensor, fitness: Any,
               fetch: bool = True) -> Tuple[TrainState, Dict[str, Any]]:
        """An adam step (no clip) on the ES gradient estimate of the
        population drawn as ``eps`` [P/2, n] with ``fitness`` [P] (cast to
        float32, as the reference casts it): K15 then K19. Returns the
        state (updated in place) and the metrics (``ES_METRIC_KEYS``) as
        floats, or, with ``fetch`` False, as device scalars."""
        fit = torch.as_tensor(np.asarray(fitness, np.float32),
                              device=self.device)
        cfg = self.cfg
        with torch.no_grad():
            grads, metrics, _ = es_update(fit, eps, self.flat(state.params),
                                          cfg.noise_stdev, cfg.l2_coeff)
            self._apply_optimizer(state, self.unflat(grads))
            state.step += 1
        if not fetch:
            return state, dict(zip(ES_METRIC_KEYS, metrics.unbind()))
        return state, dict(zip(ES_METRIC_KEYS, metrics.cpu().tolist()))

    # --------------------------------------------------------- evaluation
    def evaluate_population(self, stacked: torch.Tensor, vec_env,
                            window: int,
                            generator: Optional[torch.Generator] = None,
                            noise_std: Optional[float] = None
                            ) -> np.ndarray:
        """Run every env for ``window`` steps, env p driven by member p;
        returns the summed rewards [P] (float64). Each step's noise is
        drawn from ``generator`` (standard normal on the learner's device)
        and scaled by ``noise_std`` (default ``cfg.action_noise_std``; 0
        draws none)."""
        std = self.cfg.action_noise_std if noise_std is None else noise_std
        fitness = np.zeros(self.population, dtype=np.float64)
        n_actions = np.asarray(vec_env.obs[0]["action_mask"]).shape[0]
        shape = (self.population, n_actions)
        for _ in range(window):
            if std:
                step_noise = torch.randn(shape, generator=generator,
                                         dtype=self.dtype,
                                         device=self.device)
            else:
                step_noise = torch.zeros(shape, dtype=self.dtype,
                                         device=self.device)
            actions = self.pop_actions(stacked, vec_env.stacked_obs(),
                                       step_noise, std)
            _, rewards, _ = vec_env.step(actions)
            fitness += rewards
        return fitness

    def evaluate_mean_params(self, params: List[torch.Tensor], vec_env,
                             window: int) -> float:
        """Fitness of the unperturbed params (``cfg.eval_prob``'s window):
        every env runs the same mean parameters, noise-free; returns the
        mean summed reward across envs."""
        theta = self.flat(params)
        stacked = theta[None].expand(self.population, -1)
        return float(np.mean(self.evaluate_population(
            stacked, vec_env, window, noise_std=0.0)))
