"""The port's device collection (``ddls_tpu_torch/sim/device_env.py``: the
in-kernel observation K26 and the segment and policy episodes with K25's
reset, the plain versions; ``rl/ppo_device.py``, ``rl/fused.py``, the loop
hook) against the JAX package:

(a) K26's plain version bit-equal to the reference's jitted
    ``_kernel_obs`` (float32 and x64, with bounds that make every rebuilt
    entry vary) and, at x64, to the port's host encoder on a host episode;
    the step forward's batch array for array equal to
    ``prepare_flat_batch`` of the rebuilt observations;
(b) the recorded small-surface collects (3 x 24 steps, 2 lanes,
    ``device_collect_recorded.npz``) reproduced by ``DevicePPOCollector``
    from the recorded uniforms, memo off and memo on: actions, rewards,
    dones, the compact fields and the episode counters equal, the rebuilt
    graph features and masks bit-equal, logp within 1e-5, values and the
    bootstrap values within 5e-5 (``sim/fixture.py`` ``hold_collect``,
    which ``chip_smoke.py`` applies too), the episode records equal to the
    reference's harvest, and the same records built from the steps alone;
    the full-width recording's first 8 steps (``env_load32``,
    ``ppo_device_trained``);
(c) the in-kernel reset restarts an ended lane on its bank's job 0 while
    the memo persists (with deterministic actions the misses stop growing
    after the first episode), and the lane then takes a fresh collector's
    steps; the greedy policy episode;
(d) the collector feeding ``PPOLearner.train_step``, one IMPALA epoch
    through the loop's hook, and the loud refusals (a mesh, the memo knob
    without device collection, DQN and ES).

Every tensor here lies on the CPU (``device="cpu"``)."""
import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddls_tpu.envs import RampJobPartitioningEnvironment as JaxEnv
from ddls_tpu.sim import jax_env
from ddls_tpu_torch.envs import RampJobPartitioningEnvironment as PortEnv
from ddls_tpu_torch.graphs.synthetic import generate_pipedream_txt_files
from ddls_tpu_torch.models.convert import params_from_flax
from ddls_tpu_torch.models.policy import GNNPolicy, prepare_flat_batch
from ddls_tpu_torch.rl.ppo_device import DevicePPOCollector
from ddls_tpu_torch.serve.fixture import load_checkpoint_fixture
from ddls_tpu_torch.sim import device_env
from ddls_tpu_torch.sim.device_memo import MemoConfig
from ddls_tpu_torch.sim.fixture import (MEMO_TINY_ARCH,
                                        ended_episode_records, hold_collect,
                                        load_device_collect_fixture,
                                        memo_surface_kwargs, restart_faults,
                                        restart_uniforms)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import export_torch_device_collect_fixture as collect_export  # noqa: E402

torch.set_num_threads(1)

ENV_CLS = "ddls_tpu.envs.partitioning_env.RampJobPartitioningEnvironment"
FIELDS = [name for name, _ in device_env.OBS_FIELDS]


@pytest.fixture(scope="module")
def fx():
    return load_device_collect_fixture()


@pytest.fixture(scope="module")
def small(fx, tmp_path_factory):
    """The small surface in both packages: (dir, JAX env, port env, port
    tables, obs tables, the tiny policy)."""
    d = str(tmp_path_factory.mktemp("collect_profiles"))
    generate_pipedream_txt_files(d, n_cnn=1, n_translation=1, seed=9,
                                 min_ops=4, max_ops=6)
    jenv = JaxEnv(**memo_surface_kwargs(d))
    jenv.reset(seed=0)
    penv = PortEnv(**memo_surface_kwargs(d))
    penv.reset(seed=0)
    et = device_env.build_episode_tables(penv)
    ot = device_env.build_obs_tables(penv, et)
    model = GNNPolicy(n_actions=5, graph_feature_dim=22, **MEMO_TINY_ARCH)
    model.load_state_dict(params_from_flax(fx["small"]["params"], model))
    return {"dir": d, "jenv": jenv, "penv": penv, "et": et, "ot": ot,
            "model": model.eval()}


def _rows(et, n, seed):
    r = np.random.RandomState(seed)
    return (r.randint(0, len(et.types), n).astype(np.int32),
            np.round(r.uniform(0.0, 1.3, n), 2),
            r.randint(1, 80, n).astype(np.float64),
            r.randint(0, et.n_srv + 1, n).astype(np.int32),
            r.randint(0, et.n_srv + 1, n).astype(np.int32))


@pytest.mark.parametrize("x64", [False, True])
def test_kernel_obs_equals_reference(small, x64):
    """K26's plain version against ``jax.jit(vmap(_kernel_obs))``, with
    the bounds of the SLA fraction, the JCTs and the steps made to vary
    (the surface fixes the steps, so their bound would be degenerate)."""
    jet = jax_env.build_episode_tables(small["jenv"])
    jot = dict(jax_env.build_obs_tables(small["jenv"], jet),
               steps_bounds=(5.0, 70.0))
    pot = dict(small["ot"], steps_bounds=(5.0, 70.0))
    rows = _rows(small["et"], 4000, 1 + x64)
    dt = torch.float64 if x64 else torch.float32
    dev = device_env.device_tables(small["et"], "cpu", dt)
    dobs = device_env.DeviceObs(pot, dev)
    fdt = np.float64 if x64 else np.float32
    got_gf, got_mask = device_env.kernel_obs(
        dobs, torch.from_numpy(rows[0]), torch.from_numpy(rows[1].astype(fdt)),
        torch.from_numpy(rows[2].astype(fdt)), torch.from_numpy(rows[3]),
        torch.from_numpy(rows[4]))
    with jax.enable_x64(x64):
        jdt = jnp.float64 if x64 else jnp.float32
        fn = jax.jit(jax.vmap(lambda *a: jax_env._kernel_obs(jot, jet, *a)))
        want = fn(jnp.asarray(rows[0]), jnp.asarray(rows[1], jdt),
                  jnp.asarray(rows[2], jdt), jnp.asarray(rows[3]),
                  jnp.asarray(rows[4]))
        np.testing.assert_array_equal(got_gf.numpy(),
                                      np.asarray(want["graph_features"]))
        np.testing.assert_array_equal(got_mask.numpy(),
                                      np.asarray(want["action_mask"]))


def test_kernel_obs_equals_host_encoder(small):
    """At x64 the rebuilt observation of every decision of host episodes
    of the port equals the host encoder's, bit for bit (the tables built
    after each episode's reset: the normalisation bounds are the reset
    workload's)."""
    env = PortEnv(**memo_surface_kwargs(small["dir"]))
    r = np.random.RandomState(0)
    n = 0
    for seed in (3, 4, 5):
        obs = env.reset(seed=seed)
        et = device_env.build_episode_tables(env)
        dobs = device_env.DeviceObs(
            device_env.build_obs_tables(env, et),
            device_env.device_tables(et, "cpu", torch.float64))
        rows, host = [], []
        done = False
        while not done:
            job = next(iter(env.cluster.job_queue.jobs.values()))
            rows.append((et.types.index(job.details["model"]),
                         job.max_acceptable_jct_frac, job.num_training_steps,
                         len(env.cluster.mounted_workers),
                         len(env.cluster.jobs_running)))
            host.append(obs)
            valid = np.nonzero(obs["action_mask"])[0]
            obs, _, done, _ = env.step(int(r.choice(valid)))
        fields = {name: torch.tensor(c, dtype=want or torch.float64)
                  for (name, want), c in zip(device_env.OBS_FIELDS,
                                             zip(*rows))}
        rebuilt = device_env.rebuild_obs_batch(dobs, fields)
        for key in ("graph_features", "action_mask", "node_features",
                    "edge_features", "edges_src", "edges_dst", "node_split",
                    "edge_split", "action_set"):
            want = np.stack([o[key] for o in host])
            got = rebuilt[key].numpy()
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)
        n += len(host)
    assert n >= 30


def test_forward_batch_equals_prepare_flat_batch(small):
    """The step forward's batch (K20 over per-type rows, K26's features)
    array for array equal to ``prepare_flat_batch`` of the same rebuilt
    observations."""
    dobs = device_env.device_obs(
        small["ot"], device_env.device_tables(small["et"], "cpu",
                                              torch.float32))
    rows = _rows(small["et"], 6, 5)
    fields = {name: torch.from_numpy(np.asarray(x, np.float32)
                                     if x.dtype.kind == "f" else x)
              for name, x in zip(FIELDS, rows)}
    obs = device_env.rebuild_obs_batch(dobs, fields)
    gf, mask = device_env.kernel_obs(dobs, *(fields[k] for k in FIELDS))
    got = dobs.forward_batch(fields["jtype"], gf, mask)
    want = prepare_flat_batch({k: v.numpy() for k, v in obs.items()})
    assert set(got) == set(want)
    for key, value in want.items():
        g = got[key].numpy()
        assert g.dtype == value.dtype, key
        np.testing.assert_array_equal(g, value, err_msg=key)


@pytest.mark.parametrize("memo", [False, True])
def test_small_collects_equal_recording(fx, small, memo):
    """The recorded small-surface collects, where the lanes end episodes:
    each held against its recording; its episode records equal those
    built from its steps alone (the counters agree with the steps); after
    each lane's first end in the last collect, its steps equal a fresh
    collector's first steps under the same uniforms (the reset restores
    the fresh state; a memo that outlives it changes nothing). The same
    checks run on the card at full width (``chip_smoke.py``)."""
    rec = fx["small"]

    def collector():
        return DevicePPOCollector(
            small["et"], small["ot"], small["model"], rec["banks"], 24,
            memo_cfg=MemoConfig(16, 2) if memo else None, device="cpu")

    col, traces = collector(), []
    for c, r in enumerate(rec["collects"]):
        out = col.collect(uniforms=r["uniforms"])
        assert hold_collect(out, r)[0] == [], c
        traces.append(out["trace"])
        records, faults = ended_episode_records(traces)
        assert faults == [] and records == out["episodes"], c
    ends, u = restart_uniforms(r["uniforms"], out["trace"]["done"])
    assert (ends >= 0).all()
    steps, faults = restart_faults(
        out["trace"], collector().collect(uniforms=u)["trace"], ends)
    assert faults == [] and steps >= 24
    assert out["env_steps"] == 48
    counters = col.memo_counters()
    if memo:
        assert counters["hits"] > 0 and 0 < counters["hit_rate"] <= 1
    else:
        assert counters is None


def test_full_width_prefix_equals_recording(fx):
    """The first 8 steps of the full-width recording: ``env_load32`` with
    ``ppo_device_trained``, float32, the memo on (the card holds all
    384)."""
    cfg = json.load(open(os.path.join(
        REPO, "ddls_tpu_torch", "data", collect_export.CONFIG_NAME)))
    env = PortEnv(**copy.deepcopy(cfg["env_config"]), device="cpu")
    env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    ot = device_env.build_obs_tables(env, et)
    rec = fx["full"]
    assert et.types == rec["types"]
    model = load_checkpoint_fixture("ppo_device_trained")["model"].eval()
    steps = 8
    col = DevicePPOCollector(et, ot, model, rec["banks"], steps,
                             device="cpu")
    r = rec["collects"][0]
    out = col.collect(uniforms=r["uniforms"][:, :steps])
    assert hold_collect(out, r, steps=steps)[0] == []


def test_reset_restarts_the_bank_and_the_memo_persists(fx, small):
    """Greedy-equivalent uniforms (one constant: the Gumbel noise does not
    move the argmax) make every episode of a lane the same decisions: the
    step after ``done`` queues the bank's job 0 on an empty cluster, the
    episode counters restart, and the memo's misses stop growing once each
    lane's first episode ended."""
    banks = fx["small"]["banks"]
    seg = device_env.make_segment_fn(small["et"], small["ot"],
                                     small["model"], 24, MemoConfig(16, 2),
                                     device="cpu")
    state = device_env.segment_init(small["et"], banks, MemoConfig(16, 2),
                                    device="cpu")
    u = np.full((2, 24, 5), 0.5, np.float32)
    traces = [seg(banks, state, uniforms=u)[0] for _ in range(3)]
    tr = {k: torch.cat([t[k] for t in traces], 1).numpy()
          for k in traces[0]}
    for b in range(2):
        ends = np.nonzero(tr["done"][b])[0]
        assert len(ends) >= 2, "both lanes must end two episodes"
        first, second = ends[0], ends[1]
        start = first + 1
        assert tr["jtype"][b, start] == banks["type"][b, 0]
        assert tr["n_occupied"][b, start] == 0
        assert tr["n_running"][b, start] == 0
        # the counters restart: one decision in the new episode
        assert tr["ep_accepted"][b, start] + tr["ep_blocked"][b, start] \
            == 1 or tr["done"][b, start]
        np.testing.assert_array_equal(tr["action"][b, :first + 1],
                                      tr["action"][b, start:second + 1])
        assert tr["memo_misses"][b, first] == tr["memo_misses"][b, -1]
        assert tr["memo_hits"][b, -1] > tr["memo_hits"][b, first]


def greedy_host_episode(model, env, seed):
    """The port's host env episode under the greedy policy (one
    observation a forward, ``prepare_flat_batch`` at the env's pad), with
    its arrivals; then the episode tables of that reset's workload."""
    from ddls_tpu_torch.models.policy import batch_to_device
    from ddls_tpu_torch.rl.rollout import stack_obs
    from ddls_tpu_torch.sim.fixture import mixed_action_episode

    def greedy(obs):
        with torch.no_grad():
            return int(model.flat_batched(batch_to_device(
                prepare_flat_batch(stack_obs([obs])), "cpu"))[2][0])

    arrivals, decisions, stats = mixed_action_episode(env, seed=seed,
                                                      policy=greedy)
    et = device_env.build_episode_tables(env)
    return (arrivals, decisions, stats, et,
            device_env.build_obs_tables(env, et))


def test_greedy_policy_episode_equals_host_episode(small):
    """The policy episode greedy (K4) in float64 on the bank of a host
    greedy episode makes the host's decisions (actions, rewards, accepts
    and causes equal, t and jct within rel 1e-9), with and without the
    memo; a lane past its bank's end decides nothing."""
    env = PortEnv(**memo_surface_kwargs(small["dir"]))
    arrivals, decisions, stats, et, ot = greedy_host_episode(
        small["model"], env, 7)
    bank = device_env.build_job_bank(et, arrivals)
    host = np.array([dec[:5] for dec in decisions], np.float64)
    n = len(decisions)
    outs = [device_env.make_policy_episode_fn(
        et, ot, small["model"], greedy=True, memo_cfg=m, device="cpu",
        dtype=torch.float64)(bank) for m in (None, MemoConfig(16, 2))]
    for a, b in zip(outs[0]["trace"], outs[1]["trace"]):
        assert torch.equal(a, b)
    action, reward, accept, cause, t = (
        x.numpy() for x in (outs[0]["trace"][0], outs[0]["trace"][3],
                            outs[0]["trace"][4], outs[0]["trace"][5],
                            outs[0]["trace"][7]))
    has_job = outs[0]["trace"][8].numpy()
    assert has_job[:n].all() and len(set(host[:, 0])) > 1
    np.testing.assert_array_equal(action[:n], host[:, 0])
    np.testing.assert_array_equal(reward[:n], host[:, 1])
    np.testing.assert_array_equal(accept[:n], host[:, 2] > 0)
    np.testing.assert_array_equal(cause[:n],
                                  [dec[3] for dec in decisions])
    np.testing.assert_allclose(t[:n], [dec[4] for dec in decisions],
                               rtol=1e-9, atol=0)
    assert not action[~has_job].any()
    assert int(outs[0]["arrived"]) == stats["arrived"]
    assert int(outs[0]["blocked_total"]) == stats["blocked_total"]
    assert int(outs[1]["memo_hits"]) + int(outs[1]["memo_misses"]) > 0


def test_replay_with_the_memo_equals_without(fx, small):
    """``make_episode_fn`` with the memo replays the recorded banks' lanes
    as without it, bit for bit, and reports its counters."""
    banks = fx["small"]["banks"]
    actions = np.random.RandomState(3).choice([0, 1, 2, 4], (2, 12)).astype(
        np.int32)
    outs = [device_env.make_episode_fn(small["et"], m, device="cpu")(
        banks, actions) for m in (None, MemoConfig(4, 2))]
    for a, b in zip(outs[0]["trace"], outs[1]["trace"]):
        assert torch.equal(a, b)
    for key in ("accepted", "blocked", "ret", "t", "blocked_total"):
        assert torch.equal(outs[0][key], outs[1][key]), key
    assert int(outs[1]["memo_hits"].sum()) > 0
    assert "memo_hits" not in outs[0]


def test_collector_feeds_the_ppo_update(fx, small):
    from ddls_tpu_torch.rl.ppo import PPOConfig, PPOLearner

    model = copy.deepcopy(small["model"])
    learner = PPOLearner(model, PPOConfig(sgd_minibatch_size=16,
                                          num_sgd_iter=2,
                                          train_batch_size=48),
                         device="cpu")
    state = learner.init_state()
    col = DevicePPOCollector(small["et"], small["ot"], learner.model,
                             fx["small"]["banks"], 24, device="cpu")
    out = col.collect(generator=torch.Generator().manual_seed(0))
    staged = learner.stage_traj(out["traj"], out["last_values"])
    state, metrics = learner.train_step(
        state, staged, generator=torch.Generator().manual_seed(1))
    assert all(np.isfinite(float(v)) for v in metrics.values())


def _loop_kwargs(small, algo_config):
    return dict(path_to_env_cls=ENV_CLS,
                env_config=memo_surface_kwargs(small["dir"]),
                model={"fcnet_hiddens": [16], "custom_model_config": {
                    "out_features_msg": 4, "out_features_hidden": 8,
                    "out_features_node": 4, "out_features_graph": 4}},
                algo_config=algo_config, num_envs=2, rollout_length=12,
                evaluation_interval=None, seed=0, loop_mode="sequential",
                device="cpu")


def test_impala_epoch_through_the_hook(small):
    from ddls_tpu_torch.train.loops import make_epoch_loop

    loop = make_epoch_loop("impala", **_loop_kwargs(small, {
        "device_collector": True, "train_batch_size": 24}))
    try:
        assert isinstance(loop.collector, DevicePPOCollector)
        assert loop.collector.memo_cfg is not None
        res = loop.run()
        assert res["env_steps_this_iter"] == 24
        assert np.isfinite(res["learner"]["total_loss"])
    finally:
        loop.close()


def test_refusals(small, fx):
    from ddls_tpu_torch.train.loops import make_epoch_loop

    with pytest.raises(ValueError, match="A9"):
        DevicePPOCollector(small["et"], small["ot"], small["model"],
                           fx["small"]["banks"], 4, mesh=object(),
                           device="cpu")
    with pytest.raises(ValueError, match="use_jax_lookahead_memo"):
        make_epoch_loop("ppo", **_loop_kwargs(
            small, {"use_jax_lookahead_memo": True}))
    for algo in ("apex_dqn", "es"):
        with pytest.raises(ValueError, match="device_collector"):
            make_epoch_loop(algo, **_loop_kwargs(
                small, {"device_collector": True}))
    with pytest.raises(ValueError, match="ROADMAP"):
        make_epoch_loop("ppo", **dict(_loop_kwargs(small, {}),
                                      loop_mode="fused"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            device_env.make_segment_fn(small["et"], small["ot"],
                                       small["model"], 4)
