"""The PAC-ML job-partitioning environment.

MDP framing (reference: ddls/environments/ramp_job_partitioning/
ramp_job_partitioning_environment.py:42): each decision point is a job at the
head of the queue; the discrete action a in {0..max_partitions_per_op} is the
*maximum partition degree* for that job (0 = do not place). The env converts
the action to per-op partition counts with the SiP-ML quantum formula, runs
the heuristic control plane (first-fit op placer -> SRPT op scheduler ->
first-fit dep placer -> SRPT dep scheduler), steps the cluster, computes the
reward, then auto-steps the cluster with empty actions until another job is
queued (so every agent step sees exactly one job to decide on).

Port: a copy of ``ddls_tpu/envs/partitioning_env.py``; the
flight-recorder emits are left out (off by default; they change no
output); a ``scenario_runtime`` reaches the cluster (``sim/cluster.py``).
The options ``use_jax_lookahead`` and ``candidate_pricing="jax"`` keep the
reference's names (configs travel from it as JSON) and run the array
lookahead engine on the env's ``device``: K21 on the CUDA card (the
default; without a card they raise), its plain version with
``device="cpu"``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Optional, Union

from ddls_tpu_torch.agents.partitioners import build_partition_action
from ddls_tpu_torch.agents.placers import (FirstFitDepPlacer, RampFirstFitOpPlacer,
                                     RandomOpPlacer)
from ddls_tpu_torch.agents.schedulers import SRPTDepScheduler, SRPTOpScheduler
from ddls_tpu_torch.envs import spaces
from ddls_tpu_torch.envs.obs import RampJobPartitioningObservation
from ddls_tpu_torch.envs.rewards import make_reward_function
from ddls_tpu_torch.sim.actions import Action, OpPartition
from ddls_tpu_torch.sim.cluster import RampClusterEnvironment

OP_PLACERS = {
    "ramp_first_fit_op_placer": RampFirstFitOpPlacer,
    "random_op_placer": RandomOpPlacer,
}
OP_SCHEDULERS = {"srpt_op_scheduler": SRPTOpScheduler}
DEP_PLACERS = {"first_fit_dep_placer": FirstFitDepPlacer}
DEP_SCHEDULERS = {"srpt_dep_scheduler": SRPTDepScheduler}


class RampJobPartitioningEnvironment:
    def __init__(self,
                 topology_config: dict,
                 node_config: dict,
                 jobs_config: dict,
                 max_partitions_per_op: Optional[int] = None,
                 min_op_run_time_quantum: float = 0.01,
                 op_placer: str = "ramp_first_fit_op_placer",
                 op_placer_kwargs: Optional[dict] = None,
                 op_scheduler: str = "srpt_op_scheduler",
                 op_scheduler_kwargs: Optional[dict] = None,
                 dep_placer: str = "first_fit_dep_placer",
                 dep_placer_kwargs: Optional[dict] = None,
                 dep_scheduler: str = "srpt_dep_scheduler",
                 dep_scheduler_kwargs: Optional[dict] = None,
                 observation_function: str = "ramp_job_partitioning_observation",
                 pad_obs_kwargs: Optional[dict] = None,
                 information_function: str = "default",
                 reward_function: str = "lookahead_job_completion_time",
                 reward_function_kwargs: Optional[dict] = None,
                 max_simulation_run_time: Optional[float] = None,
                 job_queue_capacity: int = 10,
                 suppress_warnings: bool = True,
                 name: str = "ramp_job_partitioning",
                 path_to_save: Optional[str] = None,
                 save_cluster_data: bool = False,
                 save_freq: int = 1,
                 use_sqlite_database: bool = False,
                 use_jax_lookahead: bool = False,
                 use_native_lookahead: str | bool = "auto",
                 apply_action_mask: bool = True,
                 candidate_pricing: Optional[str] = None,
                 obs_include_candidate_prices: bool = False,
                 scenario_runtime=None,
                 device: str = "cuda",
                 **kwargs):
        self.topology_config = topology_config
        self.node_config = node_config
        self.jobs_config = jobs_config
        self.max_simulation_run_time = (
            float("inf") if max_simulation_run_time is None
            else float(max_simulation_run_time))
        self.job_queue_capacity = job_queue_capacity
        self.apply_action_mask = apply_action_mask
        # opt-in all-candidate lookahead pricing at each decision point
        # (None | "native" | "jax" | "auto"): prices every valid partition
        # degree of the queued job, exposes them as env.candidate_prices /
        # info["candidate_prices"], and prefetches the lookahead memo so
        # the chosen action's cluster.step lookahead is a cache hit. The
        # jax backend batches all candidates into ONE vmapped dispatch
        # (f32 — results carry f32 rounding into the memo cache, same
        # trade as use_jax_lookahead); "auto" is the bit-exact C++ engine.
        # In the port "jax" runs K21 on ``device`` (see the module
        # docstring) and raises here on "cuda" without a card.
        if candidate_pricing == "jax":
            from ddls_tpu_torch.sim.lookahead import engine_device
            engine_device(device)
        self.candidate_pricing = candidate_pricing
        self.candidate_prices: dict = {}
        self.name = name

        self.cluster = RampClusterEnvironment(
            topology_config=topology_config,
            node_config=node_config,
            name=name,
            path_to_save=path_to_save if save_cluster_data else None,
            save_freq=save_freq,
            use_sqlite_database=use_sqlite_database,
            use_jax_lookahead=use_jax_lookahead,
            use_native_lookahead=use_native_lookahead,
            suppress_warnings=suppress_warnings,
            scenario_runtime=scenario_runtime,
            device=device)

        self.max_partitions_per_op = (
            max_partitions_per_op if max_partitions_per_op is not None
            else self.cluster.topology.num_workers)
        self.min_op_run_time_quantum = min_op_run_time_quantum

        if observation_function != "ramp_job_partitioning_observation":
            raise ValueError(
                f"unrecognised observation_function {observation_function!r}")
        if obs_include_candidate_prices and not candidate_pricing:
            raise ValueError(
                "obs_include_candidate_prices requires candidate_pricing")
        self.observation_function = RampJobPartitioningObservation(
            self.max_partitions_per_op, pad_obs_kwargs=pad_obs_kwargs,
            include_candidate_prices=obs_include_candidate_prices)

        self.action_set = list(range(self.max_partitions_per_op + 1))
        self.action_space = spaces.Discrete(len(self.action_set))
        self.observation_space: Optional[spaces.Dict] = None

        self.reward_function = make_reward_function(
            reward_function, reward_function_kwargs)

        from ddls_tpu_torch.envs.interfaces import make_information_function
        self.information_function = make_information_function(
            information_function)

        self.op_placer = OP_PLACERS[op_placer](**(op_placer_kwargs or {}))
        self.op_scheduler = OP_SCHEDULERS[op_scheduler](
            **(op_scheduler_kwargs or {}))
        self.dep_placer = DEP_PLACERS[dep_placer](**(dep_placer_kwargs or {}))
        self.dep_scheduler = DEP_SCHEDULERS[dep_scheduler](
            **(dep_scheduler_kwargs or {}))

    # ------------------------------------------------------------------- api
    def reset(self, seed: Optional[int] = None, verbose: bool = False):
        self.step_counter = 1
        self.cluster.reset(jobs_config=self.jobs_config,
                           max_simulation_run_time=self.max_simulation_run_time,
                           job_queue_capacity=self.job_queue_capacity,
                           seed=seed)
        self.observation_function.reset(self)
        self.observation_space = self.observation_function.observation_space
        self.reward_function.reset(env=self)
        self.information_function.reset(self)
        # prices BEFORE the observation: price features (opt-in) describe
        # the job the observation is about, not the previous decision's
        self._price_candidates()
        self.obs = self._get_observation()
        return self.obs

    def _is_done(self) -> bool:
        return self.cluster.is_done()

    def _get_observation(self):
        return self.observation_function.extract(env=self, done=self._is_done())

    def _step_cluster(self, action: Action) -> None:
        self.cluster.step(action)
        self.cluster_step_stats[self.cluster.step_counter] = (
            self.cluster.step_stats)

    def _partition_action_for(self, job, max_partitions: int):
        """Action int -> per-op partition counts via the SiP-ML quantum
        formula (reference: :331-343)."""
        return build_partition_action(job.graph, self.min_op_run_time_quantum,
                                      max_partitions)

    def _price_candidates(self) -> None:
        self.candidate_prices = {}
        if self.candidate_pricing:
            from ddls_tpu_torch.sim.candidate_pricing import price_candidate_degrees

            self.candidate_prices = price_candidate_degrees(
                self, backend=self.candidate_pricing)

    def price_candidate_degrees(self, degrees=None, backend="auto"):
        """Lookahead prices for candidate partition degrees of the queued
        job (see ddls_tpu_torch.sim.candidate_pricing)."""
        from ddls_tpu_torch.sim.candidate_pricing import price_candidate_degrees

        return price_candidate_degrees(self, degrees=degrees,
                                       backend=backend)

    def step(self, action: int, verbose: bool = False):
        self.cluster_step_stats = {}

        action = int(action)
        if action not in self.action_set:
            raise ValueError(
                f"action {action} not in action set {self.action_set}")
        if not self.obs["action_mask"][action]:
            if self.apply_action_mask:
                raise ValueError(
                    f"action {action} is invalid under the current action "
                    f"mask {self.obs['action_mask']}; set "
                    "apply_action_mask=False to silently fall back to 0")
            action = 0

        if action != 0:
            job_id, job = next(iter(self.cluster.job_queue.jobs.items()))
            partition_map = {job_id: self._partition_action_for(job, action)}
            self.op_partition = OpPartition(partition_map,
                                            cluster=self.cluster)
        else:
            self.op_partition = OpPartition({}, cluster=self.cluster)

        self.op_placement = self.op_placer.get(
            op_partition=self.op_partition, cluster=self.cluster)
        self.op_schedule = self.op_scheduler.get(
            op_partition=self.op_partition, op_placement=self.op_placement,
            cluster=self.cluster)
        self.dep_placement = self.dep_placer.get(
            op_partition=self.op_partition, op_placement=self.op_placement,
            cluster=self.cluster)
        self.dep_schedule = self.dep_scheduler.get(
            op_partition=self.op_partition, dep_placement=self.dep_placement,
            cluster=self.cluster)
        self.action = Action(op_partition=self.op_partition,
                             op_placement=self.op_placement,
                             op_schedule=self.op_schedule,
                             dep_placement=self.dep_placement,
                             dep_schedule=self.dep_schedule)

        self.last_job_arrived_job_idx = self.cluster.last_job_arrived_job_idx
        self._step_cluster(self.action)

        # jobs the action handled that also survived SLA lookahead
        self.placed_job_idxs = set(self.action.job_idxs)
        for job_idx in list(self.placed_job_idxs):
            if job_idx in self.cluster.jobs_blocked:
                self.placed_job_idxs.discard(job_idx)
        # stash the placed partitioned job BEFORE auto-stepping: if the
        # episode ends during the auto-steps, episode finalisation sweeps
        # still-running jobs into jobs_blocked (cluster.py:1009-1014) and
        # JCT rewards could no longer find the placed job's lookahead
        # details in any lifecycle dict
        self.last_placed_job = (
            self.cluster.jobs_running.get(self.last_job_arrived_job_idx)
            if self.last_job_arrived_job_idx in self.placed_job_idxs
            else None)

        # auto-step until another job queues or the episode ends, THEN
        # extract the reward so throughput rewards see the cluster steps in
        # which the placed job actually ran. (Deliberate fix vs the
        # reference, which resets cluster_step_stats at the start of step()
        # and extracts before auto-stepping — :311,391 — so its throughput
        # rewards only ever see the single placement step. Acceptance/JCT
        # rewards are unaffected: they read lookahead values fixed at
        # placement, and no job can be placed or blocked during auto-steps.)
        while len(self.cluster.job_queue) == 0 and not self.cluster.is_done():
            self._step_cluster(Action())

        self.reward = self.reward_function.extract(env=self,
                                                   done=self._is_done())

        self.done = self._is_done()
        if not self.done:
            self._price_candidates()
            self.obs = self._get_observation()
        else:
            # no next decision: stale prices must not leak into terminal info
            self.candidate_prices = {}
        self.info = self.information_function.extract(env=self,
                                                      done=self.done)
        if self.candidate_prices:
            self.info["candidate_prices"] = self.candidate_prices
        self.step_counter += 1
        return self.obs, self.reward, self.done, self.info
