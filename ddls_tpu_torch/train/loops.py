"""The epoch loops, sequential and pipelined, and checkpoint evaluation.

Counterpart of ``ddls_tpu/train/loops.py``, trimmed to what the PPO,
IMPALA, PG, Ape-X DQN and ES loops read:
``_reject_unknown_algo_keys`` :59 (in
``rl/learner.py``), ``build_policy_from_model_config`` :127,
``_episode_summary`` :149, ``RLEpochLoop`` :181 (the ``__init__`` subset
of the sequential and pipelined modes with subprocess env workers, the
algo hooks ``_size_rollouts`` / ``_configure_algo`` / ``_make_learner``
:641-659, the pipelining plumbing ``_collect_and_stage`` /
``_next_batch`` / ``_harvest_metrics`` / ``_maybe_sync_metrics`` /
``sync_metrics`` / ``ring_stats`` :1027-1213, ``run`` :1283,
``_finalize_results`` :1350 with its periodic evaluation,
``make_eval_env`` :1378, ``evaluate`` :1392 with its global-RNG
isolation, the greedy episodes :1418-1498, ``save_agent_checkpoint`` /
``load_agent_checkpoint`` and ``close`` :1581), ``dqn_config_from_rllib``
:88-125, ``ApexDQNEpochLoop`` :1630-1822, ``impala_config_from_rllib`` /
``pg_config_from_rllib`` / ``es_config_from_rllib`` :1824-1862,
``ImpalaEpochLoop`` :1864, ``PGEpochLoop`` :1903, ``ESEpochLoop``
:1923-2047 and ``RLEvalLoop`` :2108.

One ``run()`` is one epoch: ``RolloutCollector.collect`` over the envs
(each step's forward through K1-K3, K17 and K9), then the learner's
``stage_traj`` and ``train_step`` (K20 assembles each minibatch, K17/K18
run the heads, K19 the optimiser; PPO: K5-K8; IMPALA: K10 and K12; PG:
K11 and K12, each with the policy's backward K5/K6). The envs are a
``ParallelVectorEnv`` of subprocess workers (``use_parallel_envs``:
``"auto"`` takes them on any host with more than one core, as the
reference does; ``vec_env_backend`` picks their pipe or shared-memory
transport) or an in-process ``VectorEnv``. Greedy evaluation takes K4,
every ``evaluation_interval`` epochs (``evaluation_duration`` episodes).
The Ape-X DQN loop acts through the forward and K13 into a prioritised
replay buffer and updates through K20, three forwards and K14; the ES
loop evaluates a population (one forward per member and K16 a step) and
updates through K15 and K19; each has its own ``run``. The learner and
the collector draw from two explicit ``torch.Generator``s on the loop's
device, seeded from ``seed`` (the IMPALA, PG and DQN updates draw
nothing; ES draws its population and its eval gate from the update stream
and its action noise from the collect stream).

``loop_mode``: ``"sequential"`` reads each update's metrics back at once
and collects on the plain schedule; ``"pipelined"`` (the configs' and the
reference's default) keeps the metrics on the card as ``LazyMetrics``
futures read back in one copy every ``metrics_sync_interval`` epochs (or
at an evaluation, ``sync_metrics`` or ``close``), and collects on the
deferred-fetch schedule over a trajectory ring where the envs run on the
shm transport. The two modes give the same params, metrics and episodes
bit for bit. ``pipeline_depth >= 1`` (IMPALA only, pipelined only) keeps
that many collections in flight on a background thread against a
snapshot of the pre-update params, whose lag V-trace corrects (reported
per batch as ``params_age_updates``).

Left out, each raising where it is asked for: the fused and sebulba
modes, the device collector, sharded parameter layouts, socket
collection, scenarios, the run ledger, warm starts, W&B, and the
multi-host fitness average of ES. The launcher's checkpoint and log
cadences belong to the launcher (not ported).
"""
from __future__ import annotations

import copy
import random
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ddls_tpu_torch.models.policy import GNNPolicy, gumbel_uniforms
from ddls_tpu_torch.rl.dqn import (ApexDQNLearner, DQNConfig,
                                   PrioritizedReplayBuffer,
                                   nstep_transitions, per_worker_epsilons,
                                   train_batch)
from ddls_tpu_torch.rl.es import ESConfig, ESLearner
from ddls_tpu_torch.rl.impala import ImpalaConfig, ImpalaLearner
from ddls_tpu_torch.rl.learner import reject_unknown_algo_keys
from ddls_tpu_torch.rl.pg import PGConfig, PGLearner
from ddls_tpu_torch.rl.ppo import PPOLearner, ppo_config_from_rllib
from ddls_tpu_torch.rl.ring import READY
from ddls_tpu_torch.rl.rollout import (OBS_KEYS, ParallelVectorEnv,
                                       RolloutCollector, VectorEnv,
                                       harvest_episode_record, stack_obs)
from ddls_tpu_torch.serve.server import resolve_device
from ddls_tpu_torch.train.checkpointer import (restore_train_state,
                                               save_train_state)
from ddls_tpu_torch.train.metrics import LazyMetrics, read_back
from ddls_tpu_torch.utils.common import (available_cores,
                                         get_class_from_path,
                                         recursive_update, seed_everything)

# flax's default Dense kernel init, lecun_normal: a normal truncated at two
# standard deviations, rescaled to keep the variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978

# the reference's options that the port does not honour, with the values
# that leave them off; any other value raises, as does any option the
# reference does not have
_UNPORTED_OPTIONS = {
    "param_sharding": ("replicated", None),
    "tp_size": (None,),
    "n_devices": (None, 1),
    "collect_transport": ("inprocess", None),
    "socket_config": (None, {}),
    "scenario": (None,),
    "run_ledger": (None,),
    "sebulba_config": (None, {}),
    "fused_config": (None, {}),
    "updates_per_epoch": (None, 4),
    "test_time_checkpoint_path": (None,),
    "initial_checkpoint_path": (None,),
    "path_to_model_cls": (None,),
    "wandb": (None,),
}
LOOP_MODES = ("sequential", "pipelined")


def build_policy_from_model_config(n_actions: int, graph_feature_dim: int,
                                   model_config: Optional[dict]
                                   ) -> GNNPolicy:
    """Build a ``GNNPolicy`` from the reference's model/gnn.yaml surface
    (the width of the encoder's graph vector is given, not inferred)."""
    model_config = model_config or {}
    cmc = model_config.get("custom_model_config", {})
    fcnet_hiddens = model_config.get("fcnet_hiddens") or (256, 256)
    return GNNPolicy(
        n_actions=n_actions,
        graph_feature_dim=graph_feature_dim,
        out_features_msg=cmc.get("out_features_msg", 32),
        out_features_hidden=cmc.get("out_features_hidden", 64),
        out_features_node=cmc.get("out_features_node", 16),
        out_features_graph=cmc.get("out_features_graph", 8),
        num_rounds=cmc.get("num_rounds", 2),
        module_depth=cmc.get("module_depth", 1),
        activation=cmc.get("aggregator_activation", "relu"),
        fcnet_hiddens=tuple(fcnet_hiddens),
        fcnet_activation=model_config.get("fcnet_activation", "relu"),
        apply_action_mask=cmc.get("apply_action_mask", True))


def init_like_flax(model: torch.nn.Module,
                   generator: torch.Generator) -> None:
    """flax's default initialisation: every Dense kernel lecun_normal,
    biases zero, LayerNorm scale one (the numbers differ from flax's: the
    generators differ)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".LayerNorm_" in name:
                p.fill_(1.0)
            else:
                std = (1.0 / p.shape[1]) ** 0.5 / _TRUNC_STD
                torch.nn.init.trunc_normal_(p, 0.0, std, -2.0 * std,
                                            2.0 * std, generator=generator)


def _episode_summary(episodes: List[dict]) -> Dict[str, float]:
    if not episodes:
        return {}
    out: Dict[str, float] = {
        "episode_reward_mean": float(np.mean(
            [e["episode_return"] for e in episodes])),
        "episode_reward_min": float(np.min(
            [e["episode_return"] for e in episodes])),
        "episode_reward_max": float(np.max(
            [e["episode_return"] for e in episodes])),
        "episode_len_mean": float(np.mean(
            [e["episode_length"] for e in episodes])),
        "episodes_this_iter": len(episodes),
    }
    # cluster custom metrics, averaged over episodes (what the reference's
    # RLlib callback surfaces as custom_metrics: ramp_cluster/utils.py:25-73)
    for key in ("num_jobs_completed", "num_jobs_blocked", "blocking_rate",
                "acceptance_rate", "mean_job_completion_time",
                "mean_job_completion_time_speedup"):
        vals = [e[key] for e in episodes if key in e]
        if vals:
            out[f"custom_metrics/{key}_mean"] = float(np.mean(vals))
    return out


class RLEpochLoop:
    """One epoch per ``run()`` call: a collect, then one learner update
    (PPO here; ``ImpalaEpochLoop`` and ``PGEpochLoop`` swap the learner
    through the algo hooks), with greedy evaluation every
    ``evaluation_interval`` epochs (None or 0: never).

    ``env_config`` / ``model`` / ``algo_config`` follow the reference's
    config surfaces; ``num_envs`` (default: ``algo_config.num_workers``)
    envs each step ``rollout_length`` (default: ``train_batch_size //
    num_envs``) times per epoch. ``loop_mode``, ``metrics_sync_interval``,
    ``pipeline_depth``, ``use_parallel_envs`` and ``vec_env_backend`` are
    the reference's (see the module docstring). ``device`` is ``"cuda"``
    unless the caller asks for ``"cpu"`` (raises when CUDA is asked for
    and absent). ``init_params`` (a state dict, e.g. ``load_export``'s)
    seeds the policy; without it the policy starts from ``init_like_flax``.
    """

    # collecting against stale params needs an off-policy correction:
    # ImpalaEpochLoop opts in
    SUPPORTS_STALE_COLLECTION = False

    def __init__(self,
                 path_to_env_cls: str,
                 env_config: dict,
                 model: Optional[dict] = None,
                 algo_config: Optional[dict] = None,
                 num_envs: Optional[int] = None,
                 rollout_length: Optional[int] = None,
                 use_parallel_envs="auto",
                 metric: str = "evaluation/episode_reward_mean",
                 metric_goal: str = "maximise",
                 evaluation_interval: Optional[int] = 1,
                 evaluation_duration: int = 3,
                 evaluation_config: Optional[dict] = None,
                 seed: Optional[int] = 0,
                 test_seed: Optional[int] = None,
                 loop_mode: str = "pipelined",
                 metrics_sync_interval: int = 10,
                 pipeline_depth: int = 0,
                 vec_env_backend: str = "auto",
                 device: str = "cuda",
                 init_params: Optional[Mapping[str, Any]] = None,
                 **kwargs):
        for key, value in kwargs.items():
            if key not in _UNPORTED_OPTIONS:
                raise ValueError(f"unknown epoch-loop option {key!r}")
            if value not in _UNPORTED_OPTIONS[key]:
                raise ValueError(f"{key}={value!r} is not ported; the "
                                 f"port's loop needs it off")
        if loop_mode not in LOOP_MODES:
            raise ValueError(f"loop_mode must be one of {LOOP_MODES} in "
                             f"the port, got {loop_mode!r}")
        self.pipeline_depth = int(pipeline_depth or 0)
        if self.pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be >= 0, got {pipeline_depth}")
        if self.pipeline_depth and not self.SUPPORTS_STALE_COLLECTION:
            raise ValueError(
                f"{type(self).__name__} does not support pipeline_depth > "
                "0: collecting against stale params needs an explicit "
                "off-policy correction (IMPALA's V-trace); ppo/pg/dqn/es "
                "must collect with the current params (pipeline_depth=0)")
        if self.pipeline_depth and loop_mode != "pipelined":
            raise ValueError(
                "pipeline_depth > 0 requires loop_mode='pipelined'")
        if vec_env_backend not in ("auto", "pipe", "shm"):
            raise ValueError(
                f"vec_env_backend must be 'auto', 'pipe' or 'shm', got "
                f"{vec_env_backend!r}")
        if (algo_config or {}).get("device_collector"):
            raise ValueError("the port has no device collector yet")
        self.loop_mode = loop_mode
        self.metrics_sync_interval = max(int(metrics_sync_interval or 1), 1)
        self.vec_env_backend = vec_env_backend
        self.device = resolve_device(device)
        self.env_cls = get_class_from_path(path_to_env_cls)
        self.env_config = dict(env_config)
        self.metric = metric
        self.metric_goal = metric_goal
        self.evaluation_interval = evaluation_interval
        self.evaluation_duration = int(evaluation_duration)
        self.evaluation_config = evaluation_config or {}
        self.seed = 0 if seed is None else int(seed)
        self.test_seed = test_seed
        # pipelining state: the queue of (future, updates dispatched at
        # submission) of in-flight collections, the unsynced metrics, the
        # collection thread and the stale collections' parameter snapshots
        self._collect_futures: List[Any] = []
        self._collect_executor = None
        self._metrics_ring: List[LazyMetrics] = []
        self._updates_dispatched = 0
        self._snapshots: List[GNNPolicy] = []

        self._configure_algo(dict(algo_config or {}), num_envs,
                             rollout_length)

        seed_everything(self.seed)
        if use_parallel_envs == "auto":
            # subprocess env workers pay off only with cores to run on
            use_parallel_envs = available_cores() > 1
        seeds = [self.seed + i for i in range(self.num_envs)]
        if use_parallel_envs:
            self.vec_env = ParallelVectorEnv(
                self.env_cls, self.env_config, self.num_envs, seeds=seeds,
                backend=self.vec_env_backend)
        else:
            self.vec_env = VectorEnv(
                [lambda: self.env_cls(**self.env_config)
                 for _ in range(self.num_envs)], seeds=seeds)
        self.vec_env.reset()  # the observation shapes exist after a reset
        first = self.vec_env.stacked_obs()
        self.n_actions = int(first["action_mask"].shape[1])
        graph_dim = int(first["graph_features"].shape[1])
        self.model = self._build_model(self.n_actions, graph_dim, model)
        if init_params is None:
            init_like_flax(self.model,
                           torch.Generator().manual_seed(self.seed))
        self._build_learner(init_params)

        # the update and the collect streams, distinct as the reference's
        # PRNGKey(seed + 1) and PRNGKey(seed + 7919) are
        self._update_gen = torch.Generator(self.device).manual_seed(
            self.seed + 1)
        self._collect_gen = torch.Generator(self.device).manual_seed(
            self.seed + 7919)
        self.epoch_counter = 0
        self.total_env_steps = 0
        self.run_time = 0.0

    # ----------------------------------------------------------- algo hooks
    def _size_rollouts(self, algo_config, num_envs, rollout_length,
                       train_batch_size: int) -> None:
        """num_envs from config (reference: num_workers), rollout length
        sized so one epoch collects about one train batch."""
        self.num_envs = int(num_envs or algo_config.get("num_workers") or 8)
        self.rollout_length = int(
            rollout_length or max(train_batch_size // self.num_envs, 1))

    def _configure_algo(self, algo_config, num_envs, rollout_length) -> None:
        """Translate the RLlib-style algo_config; PPO by default."""
        self.algo_cfg = ppo_config_from_rllib(algo_config)
        self._size_rollouts(algo_config, num_envs, rollout_length,
                            self.algo_cfg.train_batch_size)

    def _make_learner(self):
        return PPOLearner(self.model, self.algo_cfg, device=str(self.device))

    def _build_model(self, n_actions: int, graph_dim: int,
                     model_config) -> GNNPolicy:
        return build_policy_from_model_config(n_actions, graph_dim,
                                              model_config)

    def _build_learner(self, init_params) -> None:
        """The learner, its state and the collector (the reference's
        ``_build_learner``; the DQN and ES loops build their own)."""
        self.learner = self._make_learner()
        self.state = self.learner.init_state(init_params)
        pipelined = self.loop_mode == "pipelined"
        self.collector = RolloutCollector(
            self.vec_env, self.learner, self.rollout_length,
            deferred_fetch=pipelined,
            ring_segments=self.pipeline_depth + 2 if pipelined else None)

    # ------------------------------------------------ pipelining plumbing
    def _update_token(self) -> Any:
        """The marker that the update just dispatched has run: an event on
        the card, ``READY`` on the CPU (where it ran when it returned)."""
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            return event
        return READY

    def _collect_and_stage(self, model: Optional[GNNPolicy] = None):
        """Collect one batch and stage it on the learner's device; for a
        trajectory-ring segment, phase 1 of the ring's token protocol
        (``TrajRing.note_staged``: the alias verdict, and the staging's
        token where the staging copied the segment's rows)."""
        out = self.collector.collect(generator=self._collect_gen,
                                     model=model)
        staged = self.learner.stage_traj(out["traj"], out["last_values"])
        segment = out.get("ring_segment")
        if segment is not None:
            out["ring"].note_staged(segment, staged,
                                    generation=out["ring_generation"])
        return out, staged

    def _snapshot(self) -> GNNPolicy:
        """A copy of the current params for a stale collection, in one of
        ``pipeline_depth + 1`` models used in turn (no more collections
        than that hold one at a time); the copy is queued on the stream
        before the update that follows it."""
        if len(self._snapshots) <= self.pipeline_depth:
            self._snapshots.append(copy.deepcopy(self.model)
                                   .requires_grad_(False))
        model = self._snapshots.pop(0)
        self._snapshots.append(model)
        with torch.no_grad():
            for dst, src in zip(model.parameters(),
                                self.model.parameters()):
                dst.copy_(src)
        return model

    def _next_batch(self):
        """The epoch's staged batch; under ``pipeline_depth >= 1`` also
        tops the background collections back up to ``depth``, each against
        a snapshot of the CURRENT (pre-update) params, so a batch is as
        many updates stale as landed before it is consumed (its
        ``params_age``). Collections run one at a time on one thread, in
        submission order, so the collect stream is drawn in the same
        order at every depth."""
        if self._collect_futures:
            future, version = self._collect_futures.pop(0)
            out, staged = future.result()
            out["params_age"] = self._updates_dispatched - version
        else:
            out, staged = self._collect_and_stage()
            out["params_age"] = 0
        if self.pipeline_depth:
            if self._collect_executor is None:
                from concurrent.futures import ThreadPoolExecutor

                self._collect_executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="collect-pipeline")
            while len(self._collect_futures) < self.pipeline_depth:
                self._collect_futures.append((
                    self._collect_executor.submit(
                        self._collect_and_stage, self._snapshot()),
                    self._updates_dispatched))
        return out, staged

    def _harvest_metrics(self, metrics: Mapping[str, Any],
                         extras: Optional[dict] = None) -> Any:
        """Sequential mode: the metrics read back now, as floats.
        Pipelined mode: a ``LazyMetrics`` future on the unsynced ring,
        read back at the next sync boundary. ``extras`` are host values
        (the depth-K loop's ``params_age_updates``)."""
        if self.loop_mode == "sequential":
            fetched = dict(zip(metrics, read_back(list(metrics.values()))))
            fetched.update(extras or {})
            return fetched
        lazy = LazyMetrics(dict(metrics), extras=extras)
        self._metrics_ring.append(lazy)
        return lazy

    def _maybe_sync_metrics(self, force: bool = False) -> None:
        """Read back the unsynced metrics in ONE copy at a sync boundary:
        every ``metrics_sync_interval`` epochs, an evaluation epoch, or
        ``force``."""
        if not self._metrics_ring:
            return
        if not (force
                or self.epoch_counter % self.metrics_sync_interval == 0):
            return
        ring, self._metrics_ring = self._metrics_ring, []
        LazyMetrics.materialize_group(ring)

    def sync_metrics(self) -> None:
        """Read back any unsynced metrics now (checkpoint, shutdown)."""
        self._maybe_sync_metrics(force=True)

    def ring_stats(self) -> Optional[Dict[str, Any]]:
        """The trajectory ring's ledger counters, or None without a
        ring."""
        ring = getattr(self.vec_env, "traj_ring", None)
        return ring.stats() if ring is not None else None

    # ---------------------------------------------------------------- epoch
    def run(self) -> Dict[str, Any]:
        """Collect one trajectory batch and apply one update."""
        start = time.time()
        t0 = time.perf_counter()
        out, staged = self._next_batch()
        t1 = time.perf_counter()
        self.state, metrics = self.learner.train_step(
            self.state, staged, generator=self._update_gen)
        self._updates_dispatched += 1
        segment = out.get("ring_segment")
        if segment is not None:
            # phase 2 of the ring's token protocol: the update's token
            out["ring"].note_update(segment, self._update_token(),
                                    generation=out["ring_generation"])
        extras = None
        if self.pipeline_depth:
            age = int(out["params_age"])
            extras = {"params_age_updates": age}
            ring = out.get("ring")
            if ring is not None:
                ring.observe_params_age(age)
        self.epoch_counter += 1
        self.total_env_steps += out["env_steps"]
        learner_metrics = self._harvest_metrics(metrics, extras=extras)
        self._maybe_sync_metrics()
        t2 = time.perf_counter()
        results: Dict[str, Any] = {
            "epoch_counter": self.epoch_counter,
            "env_steps_this_iter": out["env_steps"],
            "total_env_steps": self.total_env_steps,
            "learner": learner_metrics,
            "timing": {"collect_s": t1 - t0, "update_s": t2 - t1,
                       **out["timing"]},
        }
        return self._finalize_results(results, out["episodes"], start)

    def _finalize_results(self, results: Dict[str, Any],
                          episodes: List[dict], start: float
                          ) -> Dict[str, Any]:
        """Shared epoch epilogue: episode summary, periodic evaluation,
        timing bookkeeping."""
        results.update(_episode_summary(episodes))
        results["episodes"] = episodes
        if (self.evaluation_interval
                and self.epoch_counter % self.evaluation_interval == 0):
            # an evaluation is a logging boundary: read back the unsynced
            # metrics first, and let in-flight background collections
            # settle, since evaluate() snapshots and reseeds the global
            # numpy/random state that their env stepping draws from
            self._maybe_sync_metrics(force=True)
            for future, _ in self._collect_futures:
                future.result()
            results["evaluation"] = self.evaluate(self.evaluation_duration)
        self.run_time += time.time() - start
        results["epoch_time"] = time.time() - start
        results["run_time"] = self.run_time
        return results

    # ----------------------------------------------------------- evaluation
    def make_eval_env(self):
        """The evaluation env: the training env_config with the
        evaluation_config env overrides applied."""
        env_config = copy.deepcopy(self.env_config)
        overrides = (self.evaluation_config or {}).get("env_config") or {}
        return self.env_cls(**recursive_update(env_config, overrides))

    def evaluate(self, num_episodes: int,
                 seed: Optional[int] = None) -> Dict[str, Any]:
        """Greedy-policy evaluation episodes on fresh envs.

        The process-global RNG state is snapshotted around evaluation:
        env.reset(seed) seeds numpy/random globally, and letting the fixed
        test seed leak into the training envs' workload sampling would both
        corrupt training stochasticity and contaminate the held-out test
        stream."""
        np_state = np.random.get_state()
        py_state = random.getstate()
        try:
            base_seed = (seed if seed is not None
                         else (self.test_seed
                               if self.test_seed is not None
                               else self.seed + 10_000))
            episodes = self._run_greedy_episodes_batched(num_episodes,
                                                         base_seed)
            return _episode_summary(episodes)
        finally:
            np.random.set_state(np_state)
            random.setstate(py_state)

    def _run_greedy_episodes_batched(self, num_episodes: int,
                                     base_seed: int) -> List[dict]:
        """One episode per eval env, all driven by one batched greedy
        forward per step. Finished envs keep contributing their last obs to
        the batch but are no longer stepped. Each env's global-RNG state is
        swapped in around its reset and every step, so episode i consumes
        exactly the stream seeded by ``base_seed + i`` (the same as running
        the episodes one by one)."""
        def rng_state():
            return (np.random.get_state(), random.getstate())

        def set_rng_state(state) -> None:
            np.random.set_state(state[0])
            random.setstate(state[1])

        # env construction is expensive; env.reset(seed) makes reuse
        # bit-identical to fresh envs
        cache = getattr(self, "_eval_envs", [])
        while len(cache) < num_episodes:
            cache.append(self.make_eval_env())
        self._eval_envs = cache
        envs = cache[:num_episodes]
        obs, rng_states = [], []
        for i, env in enumerate(envs):
            obs.append(env.reset(seed=base_seed + i))
            rng_states.append(rng_state())
        done = np.zeros(num_episodes, dtype=bool)
        totals = np.zeros(num_episodes)
        lengths = np.zeros(num_episodes, dtype=np.int64)
        records: List[Optional[dict]] = [None] * num_episodes
        while not done.all():
            actions = self._greedy_actions(stack_obs(obs))
            for i in np.flatnonzero(~done):
                set_rng_state(rng_states[i])
                obs[i], reward, d, _ = envs[i].step(int(actions[i]))
                rng_states[i] = rng_state()
                totals[i] += reward
                lengths[i] += 1
                if d:
                    done[i] = True
                    records[i] = harvest_episode_record(
                        envs[i], i, totals[i], lengths[i])
        return [r for r in records if r is not None]

    def _run_greedy_episode(self, env, seed: int) -> Dict[str, Any]:
        """Single-episode evaluation on a caller-provided env (RLEvalLoop
        surface); same greedy policy as the batched path."""
        obs = env.reset(seed=seed)
        done = False
        total, steps = 0.0, 0
        while not done:
            action = int(self._greedy_actions(stack_obs([obs]))[0])
            obs, reward, done, _ = env.step(action)
            total += reward
            steps += 1
        return harvest_episode_record(env, 0, total, steps)

    def _greedy_actions(self, batched_obs) -> np.ndarray:
        """Greedy actions for a [B, ...] obs batch: the forward and K4."""
        return self.learner.greedy_actions(batched_obs)

    # ---------------------------------------------------------- checkpoints
    def save_agent_checkpoint(self, path: str) -> str:
        save_train_state(self.state, path)
        return path

    def load_agent_checkpoint(self, path: str) -> None:
        self.state = restore_train_state(path, target=self.state)

    def close(self) -> None:
        """Settle the background collections, read back unsynced metrics,
        and close the envs (their workers and shared memory)."""
        for future, _ in self._collect_futures:
            try:  # leave the env workers in a consistent state
                future.result(timeout=60)
            except Exception:
                pass
        self._collect_futures = []
        if self._collect_executor is not None:
            self._collect_executor.shutdown(wait=True)
            self._collect_executor = None
        self.sync_metrics()
        self.vec_env.close()


# RLlib IMPALA keys (algo/impala.yaml) -> ImpalaConfig fields
_RLLIB_TO_IMPALA = {
    "lr": "lr",
    "gamma": "gamma",
    "vtrace_clip_rho_threshold": "vtrace_clip_rho_threshold",
    "vtrace_clip_pg_rho_threshold": "vtrace_clip_pg_rho_threshold",
    "vtrace_drop_last_ts": "vtrace_drop_last_ts",
    "vf_loss_coeff": "vf_loss_coeff",
    "entropy_coeff": "entropy_coeff",
    "grad_clip": "grad_clip",
    "opt_type": "opt_type",
    "decay": "decay",
    "momentum": "momentum",
    "epsilon": "epsilon",
    "train_batch_size": "train_batch_size",
}


def impala_config_from_rllib(algo_config: Optional[dict]) -> ImpalaConfig:
    reject_unknown_algo_keys("impala", (algo_config or {}),
                             _RLLIB_TO_IMPALA)
    kwargs = {}
    for src, dst in _RLLIB_TO_IMPALA.items():
        if algo_config and algo_config.get(src) is not None:
            kwargs[dst] = algo_config[src]
    return ImpalaConfig(**kwargs)


def pg_config_from_rllib(algo_config: Optional[dict]) -> PGConfig:
    known = (("lr", "lr"), ("gamma", "gamma"), ("grad_clip", "grad_clip"),
             ("train_batch_size", "train_batch_size"))
    reject_unknown_algo_keys("pg", (algo_config or {}),
                             [src for src, _ in known])
    kwargs = {}
    for src, dst in known:
        if algo_config and algo_config.get(src) is not None:
            kwargs[dst] = algo_config[src]
    return PGConfig(**kwargs)


class ImpalaEpochLoop(RLEpochLoop):
    """IMPALA epoch loop: the same collector as PPO, then one V-trace
    update per batch (reference: algo/impala.yaml). The one loop where
    ``pipeline_depth >= 1`` is sound: up to ``depth`` collections run ahead
    on the background thread against snapshots of pre-update params while
    the card applies updates, and V-trace's importance weights correct
    that lag (``params_age_updates`` per batch). On the shm transport the
    in-flight batches live in a ``depth + 2``-segment trajectory ring."""

    SUPPORTS_STALE_COLLECTION = True

    def _configure_algo(self, algo_config, num_envs, rollout_length) -> None:
        self.algo_cfg = impala_config_from_rllib(algo_config)
        self._size_rollouts(algo_config, num_envs, rollout_length,
                            self.algo_cfg.train_batch_size)

    def _make_learner(self):
        return ImpalaLearner(self.model, self.algo_cfg,
                             device=str(self.device))


class PGEpochLoop(RLEpochLoop):
    """Vanilla policy-gradient epoch loop (reference: algo/pg.yaml)."""

    def _configure_algo(self, algo_config, num_envs, rollout_length) -> None:
        self.algo_cfg = pg_config_from_rllib(algo_config)
        self._size_rollouts(algo_config, num_envs, rollout_length,
                            self.algo_cfg.train_batch_size)

    def _make_learner(self):
        return PGLearner(self.model, self.algo_cfg, device=str(self.device))


# RLlib Ape-X DQN keys (algo/apex_dqn.yaml) -> DQNConfig fields; nested
# replay_buffer_config / exploration_config keys are flattened first
_RLLIB_TO_DQN = {
    "lr": "lr",
    "gamma": "gamma",
    "n_step": "n_step",
    "train_batch_size": "train_batch_size",
    "target_network_update_freq": "target_network_update_freq",
    "double_q": "double_q",
    "dueling": "dueling",
    "num_atoms": "num_atoms",
    "grad_clip": "grad_clip",
    "training_intensity": "training_intensity",
    "capacity": "buffer_capacity",
    "prioritized_replay_alpha": "prioritized_replay_alpha",
    "prioritized_replay_beta": "prioritized_replay_beta",
    "prioritized_replay_eps": "prioritized_replay_eps",
    "learning_starts": "learning_starts",
    "initial_epsilon": "initial_epsilon",
    "final_epsilon": "final_epsilon",
    "epsilon_timesteps": "epsilon_timesteps",
}


def dqn_config_from_rllib(algo_config: Optional[dict]) -> DQNConfig:
    """Translate an RLlib-style Ape-X DQN config dict into a ``DQNConfig``
    (``replay_buffer_config`` and ``exploration_config`` flattened
    first)."""
    flat = dict(algo_config or {})
    for nested in ("replay_buffer_config", "exploration_config"):
        flat.update(flat.pop(nested, None) or {})
    reject_unknown_algo_keys("apex_dqn", flat, _RLLIB_TO_DQN)
    kwargs = {}
    for src, dst in _RLLIB_TO_DQN.items():
        if flat.get(src) is not None:
            kwargs[dst] = flat[src]
    return DQNConfig(**kwargs)


def es_config_from_rllib(algo_config: Optional[dict]) -> ESConfig:
    known = ("stepsize", "noise_stdev", "l2_coeff", "episodes_per_batch",
             "report_length", "eval_prob", "action_noise_std",
             "train_batch_size")
    reject_unknown_algo_keys("es", (algo_config or {}), known)
    kwargs = {}
    for key in known:
        if algo_config and algo_config.get(key) is not None:
            kwargs[key] = algo_config[key]
    return ESConfig(**kwargs)


def _slim(obs: Mapping[str, Any]) -> Dict[str, Any]:
    """The network-consumed keys of an observation (replay stores these)."""
    return {k: obs[k] for k in OBS_KEYS}


class ApexDQNEpochLoop(RLEpochLoop):
    """Ape-X DQN epoch loop: epsilon-greedy collection (the forward and K13
    a step) into a prioritised replay buffer through per-env n-step queues,
    then ``training_intensity``-matched DQN updates (three forwards and
    K14 each) once ``learning_starts`` transitions were sampled (reference:
    algo/apex_dqn.yaml, ``ddls_tpu/train/loops.py:1630``). The Q-network
    runs unmasked; invalid actions are masked at selection."""

    def _configure_algo(self, algo_config, num_envs, rollout_length) -> None:
        self.algo_cfg = dqn_config_from_rllib(algo_config)
        self._size_rollouts(algo_config, num_envs, rollout_length,
                            self.algo_cfg.train_batch_size)

    def _build_model(self, n_actions: int, graph_dim: int,
                     model_config) -> GNNPolicy:
        # the Q-net's logits stay finite for the dueling mean; invalid
        # actions are masked at selection instead
        model_config = copy.deepcopy(model_config or {})
        model_config.setdefault("custom_model_config", {})[
            "apply_action_mask"] = False
        return build_policy_from_model_config(n_actions, graph_dim,
                                              model_config)

    def _build_learner(self, init_params) -> None:
        cfg = self.algo_cfg
        self.learner = ApexDQNLearner(self.model, cfg,
                                      device=str(self.device))
        self.state = self.learner.init_state(init_params)
        self.replay = PrioritizedReplayBuffer(
            cfg.buffer_capacity, cfg.prioritized_replay_alpha,
            cfg.prioritized_replay_beta, cfg.prioritized_replay_eps,
            seed=self.seed)
        self._nstep_queues: List[List[dict]] = [
            [] for _ in range(self.num_envs)]
        self.collector = None
        if (self.loop_mode == "pipelined"
                and getattr(self.vec_env, "prefetch_stacked", None)
                is False):
            self.vec_env.prefetch_stacked = True

    def run(self) -> Dict[str, Any]:
        """Collect ``rollout_length`` epsilon-greedy steps per env into
        replay, then apply ``round(env_steps * training_intensity /
        train_batch_size)`` updates once the learning-starts gate opens.
        ``timing``: the collect's env stepping (``env_s``) and acting
        (``sample_s``), and the updates (``update_s``). Only the metrics'
        schedule differs between the loop modes: each update reads its
        ``|td|`` back for the priorities, with the metrics in the same
        copy; the pipelined loop logs their mean as one ``LazyMetrics``."""
        cfg = self.algo_cfg
        start = time.time()
        t_len, lanes = self.rollout_length, self.num_envs
        env_s = sample_s = 0.0
        t0 = time.perf_counter()
        for _ in range(t_len):
            ts = time.perf_counter()
            batched = self.vec_env.stacked_obs()
            eps = per_worker_epsilons(lanes, self.total_env_steps, cfg)
            u_explore = torch.rand(lanes, generator=self._collect_gen,
                                   device=self.device)
            u_pick = gumbel_uniforms((lanes, self.n_actions),
                                     self._collect_gen, self.device)
            actions = self.learner.eps_greedy_actions(batched, eps,
                                                      u_explore, u_pick)
            te = time.perf_counter()
            prev_obs = list(self.vec_env.obs)
            _, rewards, dones = self.vec_env.step(actions)
            for i in range(lanes):
                queue = self._nstep_queues[i]
                queue.append({
                    "obs": _slim(prev_obs[i]), "action": int(actions[i]),
                    "reward": float(rewards[i]), "done": bool(dones[i]),
                    # at an episode end this is the auto-reset obs, but
                    # then discount == 0 and the target never reads it
                    "next_obs": _slim(self.vec_env.obs[i])})
                for tr in nstep_transitions(queue, cfg.n_step, cfg.gamma,
                                            flush=bool(dones[i])):
                    self.replay.add(tr)
            self.total_env_steps += lanes
            sample_s += te - ts
            env_s += time.perf_counter() - te
        t1 = time.perf_counter()

        env_steps = t_len * lanes
        metrics_acc: List[Dict[str, float]] = []
        # learning_starts counts sampled transitions (as RLlib does), and
        # the buffer-warm gate is a deterministic lower bound on replay
        # size (sampled steps minus the worst n-step queue residue)
        replay_lower_bound = self.total_env_steps - lanes * (cfg.n_step - 1)
        if (self.total_env_steps >= cfg.learning_starts
                and replay_lower_bound >= cfg.train_batch_size
                and self.replay.size >= cfg.train_batch_size):
            num_updates = max(1, int(round(
                env_steps * cfg.training_intensity / cfg.train_batch_size)))
            for _ in range(num_updates):
                batch, idx, weights = self.replay.sample(
                    cfg.train_batch_size)
                self.state, metrics, td = self.learner.train_step(
                    self.state, train_batch(batch, weights))
                self.replay.update_priorities(idx, td)
                metrics_acc.append(metrics)
        t2 = time.perf_counter()

        self.epoch_counter += 1
        extras = {"num_updates": len(metrics_acc),
                  "replay_size": self.replay.size}
        if self.loop_mode == "sequential":
            learner_metrics: Any = (
                {k: float(np.mean([m[k] for m in metrics_acc]))
                 for k in metrics_acc[0]} if metrics_acc else {})
            learner_metrics.update(extras)
        else:
            learner_metrics = LazyMetrics(metrics_acc, reduce="mean",
                                          extras=extras)
            self._metrics_ring.append(learner_metrics)
            self._maybe_sync_metrics()
        results: Dict[str, Any] = {
            "epoch_counter": self.epoch_counter,
            "env_steps_this_iter": env_steps,
            "total_env_steps": self.total_env_steps,
            "learner": learner_metrics,
            "timing": {"collect_s": t1 - t0, "update_s": t2 - t1,
                       "env_s": env_s, "sample_s": sample_s},
        }
        return self._finalize_results(
            results, self.vec_env.drain_completed_episodes(), start)


class ESEpochLoop(RLEpochLoop):
    """Evolution-strategies epoch loop (reference: algo/es.yaml,
    ``ddls_tpu/train/loops.py:1923``): each epoch draws an antithetic
    population (one member per env), evaluates every member's fitness over
    a ``rollout_length`` window (P forwards and K16 a step), then applies
    the rank-shaped update (K15 and adam). ``num_envs`` is the population,
    rounded up to even. With probability ``eval_prob`` the epoch also runs
    the unperturbed params for a window, drops that window's episodes and
    restarts every env's episode."""

    def _configure_algo(self, algo_config, num_envs, rollout_length) -> None:
        self.algo_cfg = es_config_from_rllib(algo_config)
        self.num_envs = int(num_envs or algo_config.get("num_workers") or 10)
        if self.num_envs % 2:
            self.num_envs += 1  # antithetic pairs
        self.rollout_length = int(
            rollout_length
            or max(self.algo_cfg.train_batch_size // self.num_envs, 1))

    def _build_learner(self, init_params) -> None:
        self.learner = ESLearner(self.model, self.algo_cfg, self.num_envs,
                                 device=str(self.device))
        self.state = self.learner.init_state(init_params)
        self.collector = None

    def run(self) -> Dict[str, Any]:
        cfg = self.algo_cfg
        start = time.time()
        t0 = time.perf_counter()
        # the population and the eval gate from the update stream, the
        # action noise from the collect stream
        stacked, eps = self.learner.perturb(self.state.params,
                                            self._update_gen)
        gate = float(torch.rand((), generator=self._update_gen,
                                device=self.device))
        fitness = self.learner.evaluate_population(
            stacked, self.vec_env, self.rollout_length,
            generator=self._collect_gen)
        t1 = time.perf_counter()
        self.state, metrics = self.learner.update(self.state, eps, fitness,
                                                  fetch=False)
        metrics = self._harvest_metrics(metrics)
        t2 = time.perf_counter()
        # training episodes are drained before any eval window, so the
        # mean policy's episodes never reach the training stats
        completed_episodes = self.vec_env.drain_completed_episodes()
        eval_env_steps = 0
        if cfg.eval_prob > 0 and gate < cfg.eval_prob:
            metrics["eval_fitness_mean"] = self.learner.evaluate_mean_params(
                self.state.params, self.vec_env, self.rollout_length)
            eval_env_steps = self.rollout_length * self.num_envs
            self.vec_env.drain_completed_episodes()
            self.vec_env.restart_episodes()
        self.epoch_counter += 1
        # the sync gate after the increment, as the other loops'
        self._maybe_sync_metrics()
        env_steps = self.rollout_length * self.num_envs
        self.total_env_steps += env_steps
        results: Dict[str, Any] = {
            "epoch_counter": self.epoch_counter,
            "env_steps_this_iter": env_steps,
            "total_env_steps": self.total_env_steps,
            "learner": metrics,
            "timing": {"collect_s": t1 - t0, "update_s": t2 - t1},
        }
        if eval_env_steps:
            results["eval_env_steps_this_iter"] = eval_env_steps
        return self._finalize_results(results, completed_episodes, start)


class RLEvalLoop:
    """Checkpoint-restoring policy evaluation (reference:
    ddls/loops/rllib_eval_loop.py:11)."""

    def __init__(self, epoch_loop: RLEpochLoop, **kwargs):
        self.epoch_loop = epoch_loop

    def run(self, checkpoint_path: Optional[str] = None,
            seed: Optional[int] = None) -> Dict[str, Any]:
        if checkpoint_path:
            self.epoch_loop.load_agent_checkpoint(checkpoint_path)
        env = self.epoch_loop.make_eval_env()
        record = self.epoch_loop._run_greedy_episode(
            env, seed if seed is not None
            else (self.epoch_loop.test_seed or 0))
        return {
            "episode": record,
            "episode_stats": dict(env.cluster.episode_stats),
            "steps_log": {k: list(v)
                          for k, v in env.cluster.steps_log.items()},
        }


# algo_name -> epoch-loop class; an unknown name raises, so a mistyped algo
# never trains PPO with defaults
EPOCH_LOOPS = {"ppo": RLEpochLoop, "apex_dqn": ApexDQNEpochLoop,
               "impala": ImpalaEpochLoop, "pg": PGEpochLoop,
               "es": ESEpochLoop}


def make_epoch_loop(algo_name: Optional[str], **kwargs) -> RLEpochLoop:
    name = (algo_name or "ppo").lower()
    if name not in EPOCH_LOOPS:
        raise ValueError(f"the port has no epoch loop for {algo_name!r}; "
                         f"available: {sorted(EPOCH_LOOPS)}")
    return EPOCH_LOOPS[name](**kwargs)


def build_epoch_loop_kwargs(cfg: Mapping[str, Any]) -> Dict[str, Any]:
    """Merge a composed config's groups into epoch-loop kwargs, as
    ``scripts/train_from_config.py:build_epoch_loop_kwargs`` does
    (``eval_config``'s ``evaluation_interval``, ``evaluation_duration``
    and ``evaluation_config`` included)."""
    kwargs = {k: v for k, v in cfg.get("epoch_loop", {}).items()
              if k != "_target_"}
    if "env_config" in cfg:
        kwargs["env_config"] = cfg["env_config"]
    if "model" in cfg:
        model = copy.deepcopy(cfg["model"])
        algo_model = (cfg.get("algo") or {}).get("model")
        if algo_model:
            model = recursive_update(model, copy.deepcopy(algo_model))
        kwargs["model"] = model
    if "algo" in cfg:
        kwargs["algo_config"] = cfg["algo"].get("algo_config", {})
    eval_config = cfg.get("eval_config") or {}
    for key in ("evaluation_interval", "evaluation_duration",
                "evaluation_config"):
        if key in eval_config:
            kwargs[key] = eval_config[key]
    experiment = cfg.get("experiment", {})
    if "train_seed" in experiment:
        kwargs["seed"] = experiment["train_seed"]
    if "test_seed" in experiment:
        kwargs["test_seed"] = experiment["test_seed"]
    return kwargs
