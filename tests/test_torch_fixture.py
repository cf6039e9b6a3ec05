"""The shipped fixtures (ddls_tpu_torch/data) against the JAX package: the
exported ppo_price_mixed policy is the restored checkpoint, the port's
forward of it makes the JAX policy's decisions on the 64 recorded
requests, both serving archives regenerate bit for bit from
scripts/export_torch_serve_fixture.py, the training archive (a real
trajectory and the JAX learner's update of it) from
scripts/export_torch_train_fixture.py, the rollout archive (the sampler's
uniforms and a recorded greedy episode) from
scripts/export_torch_rollout_fixture.py, the JAX IMPALA and PG updates of
the training trajectory from scripts/export_torch_ac_fixture.py, the JAX
Ape-X DQN and ES recordings from scripts/export_torch_dqn_es_fixture.py,
the JAX collect over subprocess envs from
scripts/export_torch_pipeline_fixture.py, the JSON training configs (PPO, IMPALA, PG, Ape-X DQN, ES) from
scripts/export_torch_train_config.py, the six shipped checkpoints with
their JAX greedy decisions from scripts/export_torch_checkpoints_fixture.py
and the recorded lookahead lanes from
scripts/export_torch_lookahead_lanes.py; the recorded uniforms reproduce
the recorded actions."""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import export_torch_ac_fixture as ac_export  # noqa: E402
import export_torch_checkpoints_fixture as ckpt_export  # noqa: E402
import export_torch_dqn_es_fixture as dqn_es_export  # noqa: E402
import export_torch_lookahead_lanes as lanes_export  # noqa: E402
import export_torch_pipeline_fixture as pipeline_export  # noqa: E402
import export_torch_rollout_fixture as rollout_export  # noqa: E402
import export_torch_serve_fixture as export  # noqa: E402
import export_torch_train_config as config_export  # noqa: E402
import export_torch_train_fixture as train_export  # noqa: E402
from ddls_tpu.models.policy import batched_policy_apply  # noqa: E402
from ddls_tpu.serve import ObsBucketer, default_buckets  # noqa: E402
from ddls_tpu_torch.models.convert import (flatten_tree,  # noqa: E402
                                           params_from_flax)
from ddls_tpu_torch.models.policy import (batch_to_device,  # noqa: E402
                                          prepare_flat_batch)
from ddls_tpu_torch.serve import PolicyServer, load_export  # noqa: E402
from ddls_tpu_torch.rl.fixture import (AC_TRAIN_PATH,  # noqa: E402
                                       DQN_CONFIG_PATH, DQN_ES_TRAIN_PATH,
                                       ES_CONFIG_PATH,
                                       IMPALA_CONFIG_PATH, PG_CONFIG_PATH,
                                       PIPELINE_PATH, ROLLOUT_PATH, TRAIN_CONFIG_PATH,
                                       TRAIN_PATH,
                                       load_rollout_fixture,
                                       load_train_fixture)
from ddls_tpu_torch.serve.fixture import (EXPORT_PATH,  # noqa: E402
                                          REQUESTS_PATH, checkpoint_path,
                                          load_requests)
from ddls_tpu_torch.sim.fixture import LANES_PATH  # noqa: E402

F32_MIN = np.finfo(np.float32).min


@pytest.fixture(scope="module")
def jax_policy():
    """(config, flax model, restored params, graph width) of the shipped
    checkpoint under its training config."""
    return export.load_policy()


def test_export_is_the_restored_checkpoint(jax_policy):
    cfg, jmodel, jparams, graph_dim = jax_policy
    model, params, export_dim = load_export(EXPORT_PATH)
    assert export_dim == graph_dim == 51
    assert model.n_actions == jmodel.n_actions == 17
    restored = params_from_flax(
        flatten_tree({"params": jparams["params"]}), model)
    assert set(restored) == set(params)
    for key, value in restored.items():
        assert torch.equal(value, params[key]), key
    for key, value in model.state_dict().items():
        assert torch.equal(value, params[key]), key


def _bucketed_batches(requests):
    """The requests re-padded onto the default ladder of the env's pad
    bounds and grouped per bucket in batches of 8, as the server runs
    them: [(request indices, stacked obs)]."""
    bucketer = ObsBucketer(default_buckets(150, 512))
    groups = {}
    for i, obs in enumerate(requests):
        idx, padded = bucketer.bucket_obs(obs)
        groups.setdefault(idx, []).append((i, padded))
    out = []
    for members in groups.values():
        for start in range(0, len(members), 8):
            chunk = members[start:start + 8]
            stacked = {k: np.stack([p[k] for _, p in chunk])
                       for k in chunk[0][1]}
            out.append(([i for i, _ in chunk], stacked))
    return out


def test_shipped_policy_matches_jax_on_fixture_requests(jax_policy):
    """The converted shipped checkpoint on the 64 recorded requests: the
    same greedy actions as the JAX batched_policy_apply, logits within
    1e-5 (masked ones exactly equal), values within 1e-6 relative — and
    the JAX side reproduces the recorded answers."""
    import jax

    _, jmodel, jparams, _ = jax_policy
    model, _, _ = load_export(EXPORT_PATH)
    requests, recorded = load_requests()
    assert len(requests) == 64
    apply = jax.jit(lambda p, o: batched_policy_apply(jmodel, p, o))
    for members, stacked in _bucketed_batches(requests):
        lo_ref, va_ref = map(np.asarray, apply(jparams, stacked))
        # the recording came from the JAX server's own program, which XLA
        # may fuse differently from this one: equal to f32 rounding
        np.testing.assert_allclose(lo_ref, recorded["jax_logits"][members],
                                   atol=1e-6, rtol=0)
        with torch.no_grad():
            lo, va, actions = model.flat_batched(batch_to_device(
                prepare_flat_batch(stacked), torch.device("cpu")))
        lo, va = lo.numpy(), va.numpy()
        masked = lo_ref == F32_MIN
        np.testing.assert_array_equal(lo == F32_MIN, masked)
        np.testing.assert_allclose(lo[~masked], lo_ref[~masked], atol=1e-5)
        # the values sit near 50, where one f32 ulp is ~4e-6: held
        # relative to their size
        np.testing.assert_allclose(va, va_ref, rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(actions.numpy(),
                                      np.argmax(lo_ref, axis=1))
        np.testing.assert_array_equal(actions.numpy(),
                                      recorded["jax_actions"][members])


def test_port_server_serves_the_recorded_actions():
    model, params, _ = load_export(EXPORT_PATH)
    requests, recorded = load_requests()
    server = PolicyServer(model, params, buckets=default_buckets(150, 512),
                          max_batch=8, max_queue=64, device="cpu")
    ids = [server.submit(o, now=0.0) for o in requests]
    by_id = {r.request_id: r for r in server.drain(now=0.0)}
    assert all(by_id[i].source == "policy" for i in ids)
    np.testing.assert_array_equal([by_id[i].action for i in ids],
                                  recorded["jax_actions"])


def test_fixtures_regenerate_bit_for_bit(jax_policy):
    """Every array of both committed archives, rebuilt by the export
    script's own functions, equal in dtype, shape and bits (the zip
    containers differ only in their timestamps)."""
    fresh = {EXPORT_PATH: export.export_params(*jax_policy),
             REQUESTS_PATH: export.export_requests(*jax_policy)}
    for path, arrays in fresh.items():
        with np.load(path, allow_pickle=False) as committed:
            assert sorted(committed.files) == sorted(arrays), path
            for key, value in arrays.items():
                got = committed[key]
                assert got.dtype == value.dtype, (path, key)
                np.testing.assert_array_equal(got, value, err_msg=key)
    total = sum(os.path.getsize(p) for p in fresh)
    assert total < 1_000_000


def test_train_fixture_regenerates_bit_for_bit(jax_policy):
    """The training archive rebuilt by the export script: the collected
    trajectory, the JAX GAE, the permutations and the JAX learner's
    params, metrics and kl_coeff after 1 and 50 SGD iterations, equal in
    dtype, shape and bits."""
    fresh = train_export.export_train(*jax_policy)
    with np.load(TRAIN_PATH, allow_pickle=False) as committed:
        assert sorted(committed.files) == sorted(fresh)
        for key, value in fresh.items():
            got = committed[key]
            assert got.dtype == value.dtype, key
            np.testing.assert_array_equal(got, value, err_msg=key)
    assert fresh["rewards"].shape == (train_export.ROLLOUT_LENGTH,
                                      train_export.N_ENVS)
    assert os.path.getsize(TRAIN_PATH) < 400_000


def test_rollout_fixture_regenerates_bit_for_bit(jax_policy):
    """The rollout archive rebuilt by its export script (which itself
    checks that the uniforms reproduce all 512 recorded actions): the
    uniforms and the recorded evaluation episode, equal in dtype, shape
    and bits."""
    _, model, params, _ = jax_policy
    fresh = rollout_export.export_rollout(model, params)
    with np.load(ROLLOUT_PATH, allow_pickle=False) as committed:
        assert sorted(committed.files) == sorted(fresh)
        for key, value in fresh.items():
            got = committed[key]
            assert got.dtype == value.dtype, key
            np.testing.assert_array_equal(got, value, err_msg=key)
    assert fresh["uniforms"].shape == (train_export.ROLLOUT_LENGTH,
                                       train_export.N_ENVS, 17)
    assert os.path.getsize(ROLLOUT_PATH) < 200_000


def test_pipeline_fixture_regenerates_bit_for_bit(jax_policy):
    """The subprocess-env collect rebuilt by its export script (8 JAX
    worker processes on the shm transport): every array equal in dtype,
    shape and bits."""
    cfg, model, params, _ = jax_policy
    fresh = pipeline_export.collect_subprocess(cfg, model, params)
    with np.load(PIPELINE_PATH, allow_pickle=False) as committed:
        assert sorted(committed.files) == sorted(fresh)
        for key, value in fresh.items():
            got = committed[key]
            assert got.dtype == value.dtype, key
            np.testing.assert_array_equal(got, value, err_msg=key)
    assert fresh["rewards"].shape == (train_export.ROLLOUT_LENGTH,
                                      train_export.N_ENVS)
    assert os.path.getsize(PIPELINE_PATH) < 200_000


def test_recorded_uniforms_reproduce_the_recorded_actions():
    """Gumbel-max over the recorded trajectory's masked logits (the
    shipped policy's, through the JAX forward) with the recorded uniforms
    gives every recorded action."""
    import jax.numpy as jnp

    _, model, params, _ = export.load_policy()
    fx = load_train_fixture()
    uniforms = load_rollout_fixture()["uniforms"]
    rollout_export.check_actions(model, params, uniforms)
    # and the check is not vacuous: other uniforms give other actions
    shifted = np.roll(uniforms, 1, axis=0)
    obs = {k: jnp.asarray(v[0]) for k, v in fx["traj"]["obs"].items()}
    logits = np.asarray(batched_policy_apply(model, params, obs)[0])
    picks = np.argmax(logits - np.log(-np.log(shifted[0])), axis=1)
    assert not np.array_equal(picks, fx["traj"]["actions"][0])


def test_train_config_regenerates_byte_for_byte():
    with open(TRAIN_CONFIG_PATH) as fh:
        committed = fh.read()
    cfg = config_export.composed_config()
    assert config_export.config_text(cfg) == committed
    assert cfg["env_config"]["pad_obs_kwargs"] == {"max_nodes": 150,
                                                   "max_edges": 512}
    assert cfg["algo"]["algo_config"]["sgd_minibatch_size"] == 128


@pytest.mark.parametrize("algo,path,sizes", [
    ("impala", IMPALA_CONFIG_PATH, (32, 500)),
    ("pg", PG_CONFIG_PATH, (8, 200)),
    ("apex_dqn", DQN_CONFIG_PATH, (32, 512)),
    ("es", ES_CONFIG_PATH, (10, 2000))])
def test_ac_train_configs_regenerate_byte_for_byte(algo, path, sizes):
    """The IMPALA, PG, Ape-X DQN and ES configs: the shipped algo yaml on
    env_load32_price_mixed, with the epoch loop's sizes left to the yaml
    (num_workers envs, train_batch_size // num_workers steps)."""
    with open(path) as fh:
        committed = fh.read()
    cfg = config_export.composed_config(algo)
    assert config_export.config_text(cfg) == committed
    assert cfg["algo"]["algo_name"] == algo
    assert cfg["env_config"]["pad_obs_kwargs"] == {"max_nodes": 150,
                                                   "max_edges": 512}
    assert cfg["epoch_loop"]["num_envs"] is None
    assert cfg["epoch_loop"]["rollout_length"] is None
    algo_cfg = cfg["algo"]["algo_config"]
    assert (algo_cfg["num_workers"], algo_cfg["train_batch_size"]) == sizes


def test_ac_fixture_regenerates_bit_for_bit(jax_policy):
    """The IMPALA and PG archive rebuilt by its export script: three JAX
    updates of each learner from the shipped params (params, metrics,
    V-trace's inputs and outputs, the returns), equal in dtype, shape and
    bits."""
    fresh = ac_export.export_ac(*jax_policy)
    with np.load(AC_TRAIN_PATH, allow_pickle=False) as committed:
        assert sorted(committed.files) == sorted(fresh)
        for key, value in fresh.items():
            got = committed[key]
            assert got.dtype == value.dtype, key
            np.testing.assert_array_equal(got, value, err_msg=key)
    assert fresh["impala/step1/vs"].shape == (train_export.ROLLOUT_LENGTH,
                                              train_export.N_ENVS)
    assert sum(k.endswith("/metrics/total_loss") for k in fresh) == \
        2 * ac_export.STEPS
    assert os.path.getsize(AC_TRAIN_PATH) < 300_000


def test_dqn_es_fixture_regenerates_bit_for_bit(jax_policy):
    """The Ape-X DQN and ES archive rebuilt by its export script (which
    itself checks that the recorded uniforms reproduce every DQN action,
    that the recorded noise reproduces every ES action, and that the
    target network holds the params it names): every array equal in dtype,
    shape and bits."""
    fresh = dqn_es_export.export_dqn_es(*jax_policy)
    with np.load(DQN_ES_TRAIN_PATH, allow_pickle=False) as committed:
        assert sorted(committed.files) == sorted(fresh)
        for key, value in fresh.items():
            got = committed[key]
            assert got.dtype == value.dtype, key
            np.testing.assert_array_equal(got, value, err_msg=key)
    assert fresh["dqn/act/u_pick"].shape == (
        3, train_export.ROLLOUT_LENGTH, train_export.N_ENVS, 17)
    assert fresh["es/window/noise"].shape == (dqn_es_export.WINDOW,
                                              dqn_es_export.POPULATION, 17)
    assert [int(fresh[f"dqn/update{k}/target_from"]) for k in (1, 2, 3)] \
        == [0, 2, 2]
    assert os.path.getsize(DQN_ES_TRAIN_PATH) < 1_800_000


def _assert_regenerates(path, fresh, max_bytes):
    with np.load(path, allow_pickle=False) as committed:
        assert sorted(committed.files) == sorted(fresh), path
        for key, value in fresh.items():
            got = committed[key]
            assert got.dtype == value.dtype, (path, key)
            np.testing.assert_array_equal(got, value, err_msg=key)
    assert os.path.getsize(path) < max_bytes


@pytest.mark.parametrize("name", ckpt_export.NAMES)
def test_checkpoint_fixture_regenerates_bit_for_bit(name):
    """Each shipped checkpoint's archive rebuilt by the export script: the
    params, arch, env surface, seed and the JAX greedy decisions."""
    _assert_regenerates(checkpoint_path(name),
                        ckpt_export.export_checkpoint(name), 100_000)


def test_lookahead_lanes_regenerate_bit_for_bit():
    """The recorded lanes (32/72/128-server pricing, the cluster hook's,
    the edge cases) and the JAX engine's answers to them."""
    _assert_regenerates(LANES_PATH, lanes_export.export_lanes(), 1_000_000)
