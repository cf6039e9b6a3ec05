"""The port's pipelined epoch loop, subprocess envs, shared-memory slabs and
trajectory ring, on the CPU at a tiny size (env_small, 1-4 envs, a few
steps, a tiny policy), held to the reference's identities
(``tests/test_train_pipeline.py``, ``tests/test_shm.py``):

* pipelined and sequential loops give the same params, metrics and episode
  records bit for bit, for all five learners (PPO and IMPALA over
  subprocess envs on the shm transport and its trajectory ring, PG, DQN
  and ES over in-process envs);
* the pipe and shm transports give the same training bit for bit; the
  two-half collect schedule matches the plain one; with one env,
  in-process and subprocess collection give the same trajectory (with
  more, in-process envs share the process's global numpy stream that the
  simulator draws from, and subprocess ones do not, in the port as in
  the reference);
* the ring's ledger (stall, bounded timeout, generation fencing),
  ownership until release (the alias verdict of a staging that aliases
  the slab and of one that copies it), and the kill and crash paths
  leaving no ``/dev/shm`` litter;
* the IMPALA pipelines at depth 1 and 2 train, and ``LazyMetrics``'
  mapping and group behaviour;
* the repairs: the config's evaluation cadence reaches the loop and its
  records equal ``evaluate`` by hand; ``use_parallel_envs="auto"``
  resolves as the reference's; the CLI runs the config's loop mode.
"""
import gc
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from ddls_tpu.config import load_config
from ddls_tpu.train.compat import apply_reference_compat
from ddls_tpu_torch.envs import RampJobPartitioningEnvironment
from ddls_tpu_torch.rl import ppo as tppo
from ddls_tpu_torch.rl.ring import READY, TrajRing, staged_aliases
from ddls_tpu_torch.rl.rollout import (OBS_KEYS, ParallelVectorEnv,
                                       RolloutCollector, VectorEnv)
from ddls_tpu_torch.train import loops as tloops
from ddls_tpu_torch.train.metrics import LazyMetrics, materialize_results

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_PATH = os.path.join(REPO, "scripts", "ramp_job_partitioning_configs")
DATA = os.path.join(REPO, "ddls_tpu_torch", "data")
TINY_MODEL = {"fcnet_hiddens": [16],
              "custom_model_config": {"out_features_msg": 4,
                                      "out_features_hidden": 8,
                                      "out_features_node": 4,
                                      "out_features_graph": 4}}


def _config(algo="ppo"):
    return apply_reference_compat(load_config(
        CONFIG_PATH, "rllib_config",
        [f"algo={algo}", "env_config=env_small",
         "epoch_loop=epoch_loop_default",
         "env_config.max_simulation_run_time=2000"]))


def _loop(algo, algo_config=None, **kw):
    kwargs = tloops.build_epoch_loop_kwargs(_config(algo))
    kwargs["algo_config"] = {**kwargs["algo_config"], **(algo_config or {})}
    kwargs.update(model=TINY_MODEL, device="cpu", evaluation_interval=None)
    kwargs.update(kw)
    return tloops.make_epoch_loop(algo, **kwargs)


def _run(loop, n):
    records = []
    for _ in range(n):
        r = loop.run()
        records.append((dict(r["learner"]), r["episodes"],
                        r["env_steps_this_iter"]))
    loop.sync_metrics()
    params = {k: v.clone() for k, v in loop.state.state_dict().items()}
    loop.close()
    return records, params


def _learner(vec):
    """A PPO learner for the tiny policy over ``vec``'s observations."""
    obs = vec.stacked_obs()
    model = tloops.build_policy_from_model_config(
        obs["action_mask"].shape[1], obs["graph_features"].shape[1],
        TINY_MODEL)
    return tppo.PPOLearner(model, tppo.PPOConfig(), device="cpu")


def _same_training(a, b):
    return a[0] == b[0] and all(torch.equal(a[1][k], b[1][k]) for k in a[1])


def _leaked(names):
    return [n for n in names
            if os.path.exists(os.path.join("/dev/shm", n.lstrip("/")))]


# ----------------------------------------------------------- mode parity
PARITY_CASES = [
    ("ppo", {"train_batch_size": 16, "sgd_minibatch_size": 8,
             "num_sgd_iter": 2}, {"num_envs": 4, "rollout_length": 4,
                                  "use_parallel_envs": True,
                                  "vec_env_backend": "shm"}, 3),
    ("impala", {"lr": 1e-3, "train_batch_size": 16},
     {"num_envs": 4, "rollout_length": 4, "use_parallel_envs": True,
      "vec_env_backend": "shm"}, 3),
    ("pg", {"lr": 1e-3, "train_batch_size": 8},
     {"num_envs": 2, "rollout_length": 4, "use_parallel_envs": False}, 3),
    ("apex_dqn", {"lr": 1e-3, "train_batch_size": 4, "n_step": 1,
                  "replay_buffer_config": {"learning_starts": 4,
                                           "capacity": 256}},
     {"num_envs": 2, "rollout_length": 4, "use_parallel_envs": False}, 3),
    ("es", {"stepsize": 0.01, "noise_stdev": 0.02, "eval_prob": 0.5},
     {"num_envs": 2, "rollout_length": 4, "use_parallel_envs": False}, 3),
]


@pytest.mark.shm
@pytest.mark.parametrize("algo,algo_config,loop_kw,n_epochs", PARITY_CASES,
                         ids=[c[0] for c in PARITY_CASES])
def test_loop_mode_parity_bit_exact(algo, algo_config, loop_kw, n_epochs):
    """Pipelined against sequential: identical params, metrics and episode
    records; the schedule changes when the host reads the card, never the
    arithmetic. The pipelined PPO and IMPALA loops collect into a
    2-segment trajectory ring that the staging copies out of."""
    outcomes = {}
    for mode in ("sequential", "pipelined"):
        loop = _loop(algo, algo_config, loop_mode=mode, **loop_kw)
        if mode == "pipelined" and loop_kw["use_parallel_envs"]:
            assert isinstance(loop.vec_env, ParallelVectorEnv)
            assert loop.vec_env.backend == "shm"
        outcomes[mode] = _run(loop, n_epochs)
    seq, pipe = outcomes["sequential"], outcomes["pipelined"]
    assert seq[0] == pipe[0]
    assert all(torch.equal(seq[1][k], pipe[1][k]) for k in seq[1])
    assert any(r[1] for r in seq[0]) or algo == "es", "no episode ended"


@pytest.mark.shm
def test_pipe_and_shm_train_alike_and_one_env_collects_alike():
    """The pipelined PPO loop over the pipe transport and over shm: the same
    params, metrics and episodes. And with one env, the deferred collect
    over a subprocess (shm) equals the plain collect in process."""
    outcomes = [_run(_loop("ppo", {"train_batch_size": 8,
                                   "sgd_minibatch_size": 4,
                                   "num_sgd_iter": 1},
                           loop_mode="pipelined", num_envs=2,
                           rollout_length=4, use_parallel_envs=True,
                           vec_env_backend=backend), 2)
                for backend in ("pipe", "shm")]
    assert _same_training(*outcomes)

    env_config = _config()["env_config"]
    trajs = []
    for parallel in (False, True):
        if parallel:
            vec = ParallelVectorEnv(RampJobPartitioningEnvironment,
                                    env_config, 1, seeds=[3], backend="shm")
        else:
            vec = VectorEnv([lambda: RampJobPartitioningEnvironment(
                **env_config)], seeds=[3])
        vec.reset()
        torch.manual_seed(0)  # the same tiny policy both times
        learner = _learner(vec)
        out = RolloutCollector(vec, learner, 12,
                               deferred_fetch=parallel).collect(
            generator=torch.Generator().manual_seed(0))
        # a ring segment's views live as long as the env: copy them out
        out["traj"]["obs"] = {k: np.array(v)
                              for k, v in out["traj"]["obs"].items()}
        trajs.append(out)
        vec.close()
    a, b = trajs
    for key in OBS_KEYS:
        np.testing.assert_array_equal(a["traj"]["obs"][key],
                                      b["traj"]["obs"][key], err_msg=key)
    for key in ("actions", "logp", "values", "rewards", "dones"):
        np.testing.assert_array_equal(a["traj"][key], b["traj"][key])
    np.testing.assert_array_equal(a["last_values"], b["last_values"])
    assert a["episodes"] == b["episodes"]


def test_two_half_collect_matches_the_plain_schedule():
    """The opt-in two-half schedule (``pipeline=True``) over 4 in-process
    envs, two collects in a row: observations, actions, rewards, dones
    and episodes equal to the plain schedule's (the same uniforms reach
    each env, the envs step in the same order); logp and values within
    1e-6 (each half pads to its own bucket, and the CPU's float32 products
    sum in other orders at other batch sizes)."""
    env_config = _config()["env_config"]
    outs = []
    for pipeline in (False, True):
        vec = VectorEnv([lambda: RampJobPartitioningEnvironment(
            **env_config) for _ in range(4)], seeds=[5, 6, 7, 8])
        vec.reset()
        torch.manual_seed(0)  # the same tiny policy both times
        collector = RolloutCollector(vec, _learner(vec), 10,
                                     pipeline=pipeline)
        gen = torch.Generator().manual_seed(3)
        outs.append([collector.collect(generator=gen) for _ in range(2)])
    for a, b in zip(*outs):
        for key in OBS_KEYS:
            np.testing.assert_array_equal(a["traj"]["obs"][key],
                                          b["traj"]["obs"][key])
        for key in ("actions", "rewards", "dones"):
            np.testing.assert_array_equal(a["traj"][key], b["traj"][key])
        for key in ("logp", "values"):
            np.testing.assert_allclose(b["traj"][key], a["traj"][key],
                                       rtol=0, atol=1e-6)
        np.testing.assert_allclose(b["last_values"], a["last_values"],
                                   rtol=0, atol=1e-6)
        assert a["episodes"] == b["episodes"]
    assert any(out["episodes"] for out in outs[0])


# ------------------------------------------------------- trajectory ring
def test_traj_ring_ledger_stall_and_timeout():
    """The ledger alone: round-robin leases, publish only from leased, a
    stall counted and a bounded timeout when nothing is released, release
    by a ready token (an event's ``query``, ``READY``), and generation
    fencing of a late token."""

    class Event:
        ready = False

        def query(self):
            return self.ready

    ring = TrajRing({"x": ((3,), np.dtype(np.float32))}, rows=2,
                    num_envs=2, segments=2)
    try:
        a = ring.lease()
        with pytest.raises(RuntimeError, match="leased"):
            ring.publish(ring.segments[1])
        ring.publish(a)
        b = ring.lease()
        ring.publish(b)
        with pytest.raises(RuntimeError, match="ring lease timed out"):
            ring.lease(timeout_s=0.2)
        assert ring.stalls == 1
        event = Event()
        ring.set_release_token(a, event)
        with pytest.raises(RuntimeError, match="ring lease timed out"):
            ring.lease(timeout_s=0.2)  # the event has not fired
        event.ready = True
        c = ring.lease(timeout_s=5.0)
        assert c is a and c.state == "leased" and ring.releases == 1
        stats = ring.stats()
        assert stats["segments"] == 2 and stats["leases"] == 3
        assert stats["stalls"] == 2
        assert sum(stats["occupancy_counts"]) == 5
        ring.publish(c)
        ring.set_release_token(c, READY, generation=c.generation - 1)
        assert c.release_token is None  # a stale consumer's token
        ring.set_release_token(c, READY, generation=c.generation)
        assert c.release_token is READY
    finally:
        ring.close()


@pytest.mark.shm
def test_ring_traj_views_owned_until_release():
    """The deferred collect's trajectory IS the leased segment's rows; a
    staging that aliases them (``torch.from_numpy`` of the views) keeps
    the segment until the update's token, so the next collect takes the
    other segment and leaves these bytes alone; the learner's own
    staging copies (verdict: no alias) and releases at once. The
    one-slab path (``ring_segments=0``) hands out a copy instead."""
    env_config = _config()["env_config"]
    vec = ParallelVectorEnv(RampJobPartitioningEnvironment, env_config, 2,
                            seeds=[0, 1], backend="shm")
    try:
        vec.reset()
        learner = _learner(vec)
        gen = torch.Generator().manual_seed(1)
        single = RolloutCollector(vec, learner, 4, deferred_fetch=True,
                                  ring_segments=0)
        out = single.collect(generator=gen)
        assert vec.traj_ring is None and vec._slabs.rows == 5
        snapshot = {k: np.copy(v) for k, v in out["traj"]["obs"].items()}
        for k in OBS_KEYS:
            assert not np.shares_memory(out["traj"]["obs"][k],
                                        vec._slabs.views[k]), k
        single.collect(generator=gen)  # rewrites every slab row
        for k in OBS_KEYS:
            np.testing.assert_array_equal(out["traj"]["obs"][k],
                                          snapshot[k], err_msg=k)

        collector = RolloutCollector(vec, learner, 4, deferred_fetch=True)
        out = collector.collect(generator=gen)
        ring, seg = out["ring"], out["ring_segment"]
        assert ring is vec.traj_ring and seg.state == "published"
        for k in OBS_KEYS:
            assert np.shares_memory(out["traj"]["obs"][k], seg.views[k]), k
        aliased = {k: torch.from_numpy(v) for k, v in
                   out["traj"]["obs"].items()}
        ring.note_staged(seg, aliased, generation=out["ring_generation"])
        assert seg.aliased is True and seg.release_token is None
        snapshot = {k: np.copy(v) for k, v in out["traj"]["obs"].items()}
        out2 = collector.collect(generator=gen)
        assert out2["ring_segment"] is not seg
        for k in OBS_KEYS:
            np.testing.assert_array_equal(out["traj"]["obs"][k],
                                          snapshot[k], err_msg=k)
        # the copying staging of the second batch: released at the next
        # lease; the first waits for its update's token
        staged = learner.stage_traj(out2["traj"], out2["last_values"])
        assert staged_aliases(staged, out2["ring_segment"].views) is False
        ring.note_staged(out2["ring_segment"], staged,
                         generation=out2["ring_generation"])
        assert out2["ring_segment"].release_token is READY
        ring.note_update(seg, READY, generation=out["ring_generation"])
        out3 = collector.collect(generator=gen)
        assert out3["ring_segment"] is seg
        assert ring.stats()["releases"] == 2
    finally:
        vec.close()


@pytest.mark.shm
def test_ring_kill_and_crash_paths_leave_no_litter():
    """A direct step onto a PUBLISHED segment is refused; a killed worker
    raises a clear error naming it, ``close()`` (idempotent) unlinks every
    ring segment; a ring that is garbage-collected without ``close()``
    unlinks through its finalizers."""
    env_config = _config()["env_config"]
    vec = ParallelVectorEnv(RampJobPartitioningEnvironment, env_config, 2,
                            seeds=[0, 1], backend="shm")
    vec.reset()
    learner = _learner(vec)
    collector = RolloutCollector(vec, learner, 3, deferred_fetch=True,
                                 ring_segments=3)
    out = collector.collect(generator=torch.Generator().manual_seed(0))
    names = list(vec.traj_ring.segment_names())
    assert len(names) == 3 * len(OBS_KEYS)
    with pytest.raises(RuntimeError, match="PUBLISHED"):
        vec.step(np.zeros(2, np.int32))
    out["ring"].release(out["ring_segment"])
    vec._procs[1].kill()
    vec._procs[1].join(timeout=10)
    with pytest.raises(RuntimeError, match="died"):
        for _ in range(3):
            vec.step(np.zeros(2, np.int32))
    vec.close()
    vec.close()
    assert not _leaked(names)

    ring = TrajRing({"x": ((3,), np.dtype(np.float32))}, rows=2,
                    num_envs=2, segments=3)
    names = ring.segment_names()
    assert _leaked(names) == names
    del ring
    gc.collect()
    assert not _leaked(names)


# ------------------------------------------------------ IMPALA's depth
@pytest.mark.shm
@pytest.mark.parametrize("depth,parallel", [(1, False), (2, False),
                                            (2, True)])
def test_impala_stale_pipelines_train(depth, parallel):
    """IMPALA at ``pipeline_depth`` 1 and 2: every batch's params age rises
    to the depth and stays there, metrics stay finite, params move; over
    shm the batches ride a ``depth + 2``-segment ring, every segment
    released in turn."""
    loop = _loop("impala", {"lr": 1e-3, "train_batch_size": 16},
                 loop_mode="pipelined", num_envs=4, rollout_length=4,
                 pipeline_depth=depth, use_parallel_envs=parallel,
                 vec_env_backend="shm")
    before = {k: v.clone() for k, v in loop.state.state_dict().items()}
    ages = []
    try:
        for _ in range(4):
            r = loop.run()
            ages.append(r["learner"]["params_age_updates"])
            assert all(np.isfinite(v) for v in r["learner"].values())
        stats = loop.ring_stats()
        after = loop.state.state_dict()
    finally:
        loop.close()
    assert ages == [0] + [min(k, depth) for k in range(1, 4)]
    assert any(not torch.equal(before[k], after[k]) for k in before)
    if parallel:
        assert stats["segments"] == depth + 2 and stats["stalls"] == 0
        assert stats["releases"] >= 3
    else:
        assert stats is None


@pytest.mark.parametrize("algo", ["ppo", "pg", "apex_dqn", "es"])
def test_stale_collection_rejected_outside_impala(algo):
    with pytest.raises(ValueError, match="does not support pipeline_depth"):
        _loop(algo, loop_mode="pipelined", pipeline_depth=1)


# ---------------------------------------------------------- LazyMetrics
def test_lazy_metrics_mapping_and_group_read_back():
    """Keys, ``in`` and ``len`` never read the card; the first value read
    materialises; a group reads back together (one copy); the mean of a
    list of dicts equals the float mean; extras are host values;
    ``materialize_results`` walks a results tree."""
    a = LazyMetrics({"x": torch.tensor(1.5), "y": torch.tensor(2.0)},
                    extras={"age": 1})
    b = LazyMetrics([{"x": 1.0}, {"x": torch.tensor(2.0)}], reduce="mean",
                    extras={"n": 2})
    assert a.pending and list(a) == ["x", "y", "age"] and "y" in a
    assert len(b) == 2 and b["n"] == 2 and b.pending
    LazyMetrics.materialize_group([a, b])
    assert not a.pending and not b.pending
    assert dict(a) == {"x": 1.5, "y": 2.0, "age": 1.0}
    assert b == {"x": 1.5, "n": 2.0}
    b["eval"] = 3.0
    assert b["eval"] == 3.0 and b.materialize()["eval"] == 3.0
    with pytest.raises(ValueError, match="reduce"):
        LazyMetrics([{"x": 1.0}])
    assert LazyMetrics(None) == {}
    tree = {"learner": LazyMetrics({"z": torch.tensor(0.25,
                                                      dtype=torch.float32)}),
            "episodes": [{"r": 1}], "t": (1, 2)}
    out = materialize_results(tree)
    assert out == {"learner": {"z": 0.25}, "episodes": [{"r": 1}],
                   "t": (1, 2)}
    json.dumps(out)


def test_pipelined_metrics_sync_at_the_interval():
    """The pipelined loop reads its metrics back every
    ``metrics_sync_interval`` epochs, not every update; ``sync_metrics``
    reads the rest."""
    loop = _loop("pg", {"lr": 1e-3, "train_batch_size": 8},
                 loop_mode="pipelined", num_envs=2, rollout_length=4,
                 use_parallel_envs=False, metrics_sync_interval=2)
    try:
        r1 = loop.run()["learner"]
        assert r1.pending
        r2 = loop.run()["learner"]
        assert not r1.pending and not r2.pending
        r3 = loop.run()["learner"]
        assert r3.pending
        loop.sync_metrics()
        assert not r3.pending
    finally:
        loop.close()


# -------------------------------------------------------------- repairs
def _reference_kwargs(cfg):
    spec = importlib.util.spec_from_file_location(
        "train_from_config", os.path.join(REPO, "scripts",
                                          "train_from_config.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.build_epoch_loop_kwargs(cfg)


@pytest.mark.parametrize("name", ["price_mixed", "impala_price_mixed",
                                  "pg_price_mixed", "apex_dqn_price_mixed",
                                  "es_price_mixed"])
def test_epoch_loop_kwargs_equal_the_reference(name):
    """``build_epoch_loop_kwargs`` of each exported config equals the
    reference launcher's (``evaluation_interval`` and
    ``evaluation_duration`` included)."""
    with open(os.path.join(DATA, f"train_config_{name}.json")) as fh:
        cfg = json.load(fh)
    got = tloops.build_epoch_loop_kwargs(cfg)
    assert got == _reference_kwargs(cfg)
    assert got["evaluation_interval"] == 1
    assert got["evaluation_duration"] == 3


def test_periodic_evaluation_equals_evaluate_by_hand():
    """A 2-epoch loop at interval 1 records an evaluation each epoch whose
    summary equals ``evaluate(3)`` called by hand right after it; and the
    evaluations leave training alone (the same params and metrics as a
    loop that never evaluates)."""
    cfg = _config("pg")
    runs = {}
    for interval in (1, None):
        loop = _loop("pg", {"lr": 1e-3, "train_batch_size": 8},
                     loop_mode="pipelined", num_envs=2, rollout_length=4,
                     use_parallel_envs=False, evaluation_interval=interval,
                     evaluation_duration=3,
                     evaluation_config=cfg["eval_config"][
                         "evaluation_config"])
        records = []
        try:
            for _ in range(2):
                r = loop.run()
                records.append(dict(r["learner"]))
                if interval:
                    assert r["evaluation"]["episodes_this_iter"] == 3
                    assert r["evaluation"] == loop.evaluate(3)
                else:
                    assert "evaluation" not in r
            params = {k: v.clone()
                      for k, v in loop.state.state_dict().items()}
        finally:
            loop.close()
        runs[interval] = (records, params)
    assert _same_training(runs[1], runs[None])


def test_use_parallel_envs_auto_resolves_as_the_reference(monkeypatch):
    """``auto`` takes subprocess envs where more than one core is usable
    (``ddls_tpu/train/loops.py:551-559``) and in-process envs otherwise;
    True and False are taken as given."""
    from ddls_tpu.utils import common as jcommon

    kinds = {}
    for cores in (1, 2):
        monkeypatch.setattr(tloops, "available_cores", lambda c=cores: c)
        loop = _loop("pg", num_envs=1, rollout_length=2,
                     use_parallel_envs="auto")
        kinds[cores] = type(loop.vec_env)
        loop.close()
    assert kinds == {1: VectorEnv, 2: ParallelVectorEnv}
    monkeypatch.undo()
    assert tloops.available_cores() == jcommon.available_cores()


def test_cli_runs_the_config_loop_mode(tmp_path, capsys):
    """``python -m ddls_tpu_torch.train`` runs the config's
    ``loop_mode`` (pipelined) and names it in each epoch line, with the
    epoch's evaluation at the config's interval."""
    from ddls_tpu_torch.train.__main__ import main

    cfg = _config("pg")
    cfg["epoch_loop"].update(num_envs=2, rollout_length=4,
                             use_parallel_envs=False)
    cfg["eval_config"]["evaluation_duration"] = 1
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    assert main(["--config", str(path), "--device", "cpu", "--epochs",
                 "2"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln]
    assert cfg["epoch_loop"]["loop_mode"] == "pipelined"
    assert [ln["loop_mode"] for ln in lines[:2]] == ["pipelined"] * 2
    assert all(ln["evaluation"]["episodes_this_iter"] == 1
               for ln in lines[:2])
    assert all(np.isfinite(v) for v in lines[0]["learner"].values())


@pytest.mark.shm
def test_subprocess_collect_reproduces_the_recorded_jax_collect():
    """The port's deferred collect over 8 subprocess envs on the shm
    transport (env_load32_price_mixed, seeds 0-7, the shipped policy, the
    recorded uniforms), its first 16 steps against the JAX collect over
    JAX worker processes (``ppo_pipeline_price_mixed.npz``): observations,
    rewards and dones bit-equal, actions equal, logp within 1e-5 and
    values within 5e-5 (float32 forwards that sum in other orders)."""
    from ddls_tpu_torch.rl.fixture import (load_pipeline_fixture,
                                           load_rollout_fixture,
                                           load_train_config,
                                           load_train_fixture)
    from ddls_tpu_torch.serve import load_export
    from ddls_tpu_torch.serve.fixture import EXPORT_PATH

    steps = 16
    ref = load_pipeline_fixture()["traj"]
    uniforms = load_rollout_fixture()["uniforms"][:steps]
    model, params, _ = load_export(EXPORT_PATH)
    learner = tppo.PPOLearner(model, load_train_fixture()["cfg"],
                              device="cpu")
    learner.init_state(params)
    vec = ParallelVectorEnv(RampJobPartitioningEnvironment,
                            load_train_config()["env_config"], 8,
                            seeds=list(range(8)), backend="shm")
    try:
        vec.reset()
        out = RolloutCollector(vec, learner, steps,
                               deferred_fetch=True).collect(noise=uniforms)
        traj = out["traj"]
        for key in OBS_KEYS:
            np.testing.assert_array_equal(traj["obs"][key],
                                          ref["obs"][key][:steps],
                                          err_msg=key)
    finally:
        vec.close()
    for key in ("actions", "rewards", "dones"):
        np.testing.assert_array_equal(traj[key], ref[key][:steps])
    assert np.abs(traj["logp"] - ref["logp"][:steps]).max() <= 1e-5
    assert np.abs(traj["values"] - ref["values"][:steps]).max() <= 5e-5
