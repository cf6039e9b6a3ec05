"""The port's PPO learner (ddls_tpu_torch/rl/ppo.py) against the JAX one
(ddls_tpu/rl/ppo.py), on the CPU.

Inputs come from numpy seeds or from the committed training fixture (a
real trajectory of the shipped policy, ddls_tpu_torch/data). The kernel
wrappers take their plain versions here (the tensors lie on the CPU).

Tolerances, each with its reason:
* float64 (the x64 ``train_step`` run against a JAX subprocess under
  JAX_ENABLE_X64): 1e-9 on params and metrics — the same arithmetic, sums
  reordered;
* float32 against JAX in this process: 1e-5 relative (and the absolute
  floors stated at each assert) — XLA fuses and orders its sums
  differently, one float32 rounding apart per operation;
* float32 ``train_step`` at one SGD iteration against the recorded JAX
  update: 1e-6 absolute on params (observed 1.2e-7: four adam steps of
  size ~lr from rounding-level gradient differences).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddls_tpu.rl import ppo as jppo
from ddls_tpu.train.loops import ppo_config_from_rllib as j_config_from_rllib
from ddls_tpu_torch.models import policy as tpolicy
from ddls_tpu_torch.models.convert import params_to_flax
from ddls_tpu_torch.rl import ppo as tppo
from ddls_tpu_torch.rl.fixture import TRAIN_PATH, load_train_fixture
from ddls_tpu_torch.serve import load_export
from ddls_tpu_torch.serve.fixture import EXPORT_PATH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_MIN = np.finfo(np.float32).min


@pytest.fixture(scope="module")
def fixture():
    return load_train_fixture()


def _learner(cfg, dtype=torch.float32):
    model, params, _ = load_export(EXPORT_PATH)
    learner = tppo.PPOLearner(model.to(dtype), cfg, device="cpu")
    return learner, {k: v.to(dtype) for k, v in params.items()}


def _slice(fx, t_len, lanes):
    traj = {"obs": {k: v[:t_len, :lanes]
                    for k, v in fx["traj"]["obs"].items()}}
    for key in ("actions", "logp", "values", "rewards", "dones"):
        traj[key] = fx["traj"][key][:t_len, :lanes]
    return traj, fx["last_values"][:lanes]


# ------------------------------------------------------------------- GAE
def test_gae_and_normalisation_match_jax():
    """K7's plain version: the reverse recurrence with episode ends, targets
    from the raw advantages, the population-std normalisation."""
    rng = np.random.default_rng(0)
    t_len, lanes = 37, 6
    rewards = rng.normal(0, 1, (t_len, lanes)).astype(np.float32)
    values = rng.normal(0, 3, (t_len, lanes)).astype(np.float32)
    dones = rng.uniform(0, 1, (t_len, lanes)) < 0.1
    last = rng.normal(0, 3, lanes).astype(np.float32)
    gamma, lam = 0.997, 0.95
    j_adv, j_tgt = jppo.compute_gae(*map(jnp.asarray, (rewards, values,
                                                       dones, last)),
                                    gamma, lam)
    j_norm = (j_adv - j_adv.mean()) / (j_adv.std() + 1e-8)
    t = torch.from_numpy
    adv, tgt = tppo.compute_gae(t(rewards), t(values), t(dones), t(last),
                                gamma, lam)
    np.testing.assert_allclose(adv.numpy(), np.asarray(j_adv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(j_tgt), rtol=1e-5,
                               atol=1e-5)
    norm, tgt2 = tppo.gae_normalize(t(rewards), t(values),
                                    t(dones.astype(np.float32)), t(last),
                                    gamma, lam, normalize=True)
    np.testing.assert_allclose(norm.numpy(), np.asarray(j_norm), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tgt2.numpy(), tgt.numpy())
    raw, _ = tppo.gae_normalize(t(rewards), t(values),
                                t(dones.astype(np.float32)), t(last),
                                gamma, lam, normalize=False)
    np.testing.assert_array_equal(raw.numpy(), adv.numpy())


def test_gae_on_the_fixture_matches_the_recorded_jax_gae(fixture):
    cfg, traj = fixture["cfg"], fixture["traj"]
    t = torch.from_numpy
    adv, tgt = tppo.gae_normalize(
        t(traj["rewards"]), t(traj["values"]),
        t(traj["dones"].astype(np.float32)), t(fixture["last_values"]),
        cfg.gamma, cfg.gae_lambda, cfg.normalize_advantages)
    np.testing.assert_allclose(adv.numpy(), fixture["advantages"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgt.numpy(), fixture["value_targets"],
                               rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------------- loss
def _exact_log(ratio: float) -> np.float32:
    """A float32 d with exp(d) == ratio exactly in both torch and JAX,
    searched among the neighbours of log(ratio)."""
    target = np.float32(ratio)
    up = down = np.float32(np.log(ratio))
    for _ in range(32):
        for d in (up, down):
            if (float(torch.exp(torch.tensor(d))) == target
                    and float(jnp.exp(jnp.float32(d))) == target):
                return d
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
    raise AssertionError(f"no float32 log of {ratio} found")


def _loss_inputs(rng, m=24, a=7, clip=0.25, vf_clip=0.5):
    """Random minibatch with masked actions, plus rows built to sit exactly
    on every tie: ratio = 1 + clip and 1 - clip (rows whose only valid
    action is taken, so logp = 0 exactly, and old_logp = -d with exp(d)
    exactly the bound in every framework), and
    values - old_values = +vf_clip and -vf_clip (so the clipped and
    unclipped errors are also equal)."""
    logits = rng.normal(0, 2, (m, a)).astype(np.float32)
    mask = rng.uniform(0, 1, (m, a)) < 0.7
    actions = np.array([rng.choice(np.flatnonzero(row)) if row.any() else 0
                        for row in mask], np.int32)
    mask[np.arange(m), actions] = True
    for r in (0, 1):
        mask[r] = False
        mask[r, actions[r]] = True
    masked = np.where(mask, logits, logits + F32_MIN).astype(np.float32)
    old_logp = rng.normal(-1.5, 0.3, m).astype(np.float32)
    old_logp[0] = -_exact_log(1.0 + clip)
    old_logp[1] = -_exact_log(1.0 - clip)
    advs = rng.normal(0, 1, m).astype(np.float32)
    values = rng.normal(0, 2, m).astype(np.float32)
    old_values = (values + rng.normal(0, 0.6, m)).astype(np.float32)
    targets = rng.normal(0, 2, m).astype(np.float32)
    old_values[2], values[2] = 2.0, 2.0 + vf_clip
    old_values[3], values[3] = 2.0, 2.0 - vf_clip
    cfg = tppo.PPOConfig(clip_param=clip, vf_clip_param=vf_clip,
                         vf_loss_coeff=0.5, entropy_coeff=0.01)
    return cfg, masked, actions, old_logp, values, old_values, advs, targets


def test_ppo_loss_value_and_grad_match_jax_at_the_ties():
    """Loss, metrics and d loss / d (logits, values) against
    jax.value_and_grad, with rows on every jnp.minimum/maximum/clip tie
    (where JAX passes half the gradient and torch.clamp would pass it
    all) and masked logits (zero gradient)."""
    cfg, logits, actions, old_logp, values, old_values, advs, targets = \
        _loss_inputs(np.random.default_rng(1))
    kl_coeff = np.float32(0.2)
    jcfg = jppo.PPOConfig(**dataclasses.asdict(cfg))

    def jax_loss(lo, va):
        batch = {"obs": None, "actions": jnp.asarray(actions),
                 "old_logp": jnp.asarray(old_logp),
                 "old_values": jnp.asarray(old_values),
                 "advantages": jnp.asarray(advs),
                 "value_targets": jnp.asarray(targets)}
        return jppo.ppo_loss(None, lambda p, o: (lo, va), batch,
                             jnp.asarray(kl_coeff), jcfg)

    (j_total, j_metrics), (j_dlo, j_dva) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(logits),
                                               jnp.asarray(values))
    ratio = torch.exp(torch.from_numpy(-old_logp[:2])).numpy()
    assert ratio[0] == np.float32(1.0 + cfg.clip_param)
    assert ratio[1] == np.float32(1.0 - cfg.clip_param)

    t = torch.from_numpy
    total, metrics, dlo, dva = tppo.ppo_loss_grad_plain(
        t(logits), t(values), t(actions), t(old_logp), t(old_values),
        t(advs), t(targets), torch.tensor(kl_coeff), cfg)
    np.testing.assert_allclose(float(total), float(j_total), rtol=1e-5)
    for i, key in enumerate(tppo.METRIC_KEYS):
        np.testing.assert_allclose(float(metrics[i]), float(j_metrics[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(dlo.numpy(), np.asarray(j_dlo), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(dva.numpy(), np.asarray(j_dva), rtol=1e-5,
                               atol=1e-7)
    assert np.all(dlo.numpy()[logits < F32_MIN / 2] == 0.0)
    # the ties: half the gradient where torch.clamp would give all of it
    m = logits.shape[0]
    assert float(dva[2]) == pytest.approx(
        cfg.vf_loss_coeff * 0.5 / m * 2 * (values[2] - targets[2])
        * (0.5 + 0.5 * 0.5), rel=1e-5)
    # through autograd of the loss as the learner calls it
    lo = t(logits).requires_grad_(True)
    total2, _ = tppo.ppo_loss(lo, t(values), t(actions), t(old_logp),
                              t(old_values), t(advs), t(targets),
                              torch.tensor(kl_coeff), cfg)
    (g,) = torch.autograd.grad(total2, lo)
    np.testing.assert_array_equal(g.numpy(), dlo.numpy())


def test_categorical_entropy_matches_jax_with_masked_logits():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 1, (9, 5)).astype(np.float32)
    logits[3, 1:] += F32_MIN
    ref = np.asarray(jppo.categorical_entropy(jnp.asarray(logits)))
    got = tppo.categorical_entropy(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    assert got[3] == 0.0


# ---------------------------------------------------------------- config
def test_ppo_config_and_rllib_translation_match_the_reference():
    assert dataclasses.asdict(tppo.PPOConfig()) == dataclasses.asdict(
        jppo.PPOConfig())
    algo = {"gamma": 0.997, "lr": 2.785e-4, "num_workers": 8,
            "train_batch_size": 4000, "sgd_minibatch_size": 128,
            "num_sgd_iter": 50, "lambda": 1.0, "kl_coeff": 0.01,
            "kl_target": 0.01, "clip_param": 0.18, "vf_clip_param": 128.8,
            "vf_loss_coeff": 0.5, "entropy_coeff": 0.003, "grad_clip": 1.5}
    assert dataclasses.asdict(tppo.ppo_config_from_rllib(algo)) == \
        dataclasses.asdict(j_config_from_rllib(algo))
    with pytest.raises(ValueError, match="not consumed"):
        tppo.ppo_config_from_rllib(dict(algo, lr_schedule=[0, 1]))


def test_fixture_config_is_the_shipped_algo_yaml(fixture):
    cfg = fixture["cfg"]
    assert (cfg.lr, cfg.gamma, cfg.gae_lambda, cfg.clip_param,
            cfg.vf_clip_param, cfg.vf_loss_coeff, cfg.entropy_coeff,
            cfg.kl_coeff, cfg.kl_target, cfg.grad_clip,
            cfg.sgd_minibatch_size, cfg.num_sgd_iter) == (
        2.785e-4, 0.997, 1.0, 0.18, 128.8, 0.5, 0.003, 0.01, 0.01, 1.5,
        128, 50)
    assert fixture["traj"]["rewards"].shape == (64, 8)
    assert fixture["runs"][50]["perms"].shape == (50, 512)


# --------------------------------------------------------------- staging
def test_minibatch_assembly_equals_prepare_flat_batch(fixture):
    """The device-side assembly (gather, offset and concatenate each
    sample's CSRs) gives, array for array, the host's prepare_flat_batch
    of the same samples in the reference's B-major row order."""
    learner, _ = _learner(fixture["cfg"])
    traj, last = _slice(fixture, 16, 8)
    staged = learner.stage_traj(traj, last)
    assert (staged.n_nodes, staged.n_edges) == (38, 128)
    idx = torch.from_numpy(np.random.default_rng(3).permutation(128)[:40])
    got = learner.minibatch(staged, idx)
    rows = {k: np.swapaxes(v, 0, 1).reshape((128,) + v.shape[2:])
            for k, v in traj["obs"].items()}
    picked = {k: v[idx.numpy()] for k, v in rows.items()}
    picked["node_features"] = picked["node_features"][:, :38]
    for key in ("edge_features", "edges_src", "edges_dst"):
        picked[key] = picked[key][:, :128]
    ref = tpolicy.prepare_flat_batch(picked)
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        assert got[key].dtype == torch.from_numpy(value).dtype, key
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_trimmed_bucket_gives_the_full_pad_loss_and_gradients(fixture):
    """Padded rows get zero gradient and never reach a real row: a
    minibatch at the trimmed bucket and the same samples at the env's pad
    give the same loss and parameter gradients (float64, 1e-12)."""
    learner, params = _learner(fixture["cfg"], torch.float64)
    state = learner.init_state(params)
    traj, last = _slice(fixture, 4, 8)
    rows = {k: np.swapaxes(v, 0, 1).reshape((32,) + v.shape[2:])
            for k, v in traj["obs"].items()}
    out = []
    for n, e in ((38, 128), (150, 512)):
        obs = dict(rows, node_features=rows["node_features"][:, :n].astype(
            np.float64))
        for key in ("edge_features", "edges_src", "edges_dst"):
            obs[key] = rows[key][:, :e]
        batch = tpolicy.batch_to_device(tpolicy.prepare_flat_batch(obs),
                                        torch.device("cpu"))
        logits, values, _ = learner.model.flat_batched(batch)
        total, _ = tppo.ppo_loss(
            logits, values, torch.from_numpy(np.swapaxes(
                traj["actions"], 0, 1).reshape(-1)),
            *(torch.from_numpy(np.swapaxes(traj[k], 0, 1).reshape(-1)
                               .astype(np.float64))
              for k in ("logp", "values", "values", "rewards")),
            state.kl_coeff, learner.cfg)
        out.append((total, torch.autograd.grad(total, state.params)))
    assert abs(float(out[0][0].detach()) - float(out[1][0].detach())) < 1e-12
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)


# ----------------------------------------------------------------- update
X64_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import jax
import jax.numpy as jnp

assert jax.config.read("jax_enable_x64")
args = json.loads(sys.argv[1])
sys.path.insert(0, args["scripts"])
import export_torch_train_fixture as ex
from ddls_tpu.models.policy import GNNPolicy, batched_policy_apply
from ddls_tpu.parallel.mesh import make_mesh
from ddls_tpu.rl.ppo import PPOConfig, PPOLearner

T, B = args["t"], args["b"]
with np.load(args["export"]) as z:
    arch = json.loads(str(z["arch"]))
    flat = {k: z[k] for k in z.files if k.startswith("params/")}
params = {}
for path, value in flat.items():
    node = params
    parts = path.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = jnp.asarray(value, jnp.float64)
meta = ("graph_feature_dim", "checkpoint", "env_config", "pad_max_nodes",
        "pad_max_edges")
model = GNNPolicy(**{k: (tuple(v) if isinstance(v, list) else v)
                     for k, v in arch.items() if k not in meta})
with np.load(args["fixture"]) as z:
    obs = {k[4:]: z[k][:T, :B] for k in z.files if k.startswith("obs/")}
    traj = {k: z[k][:T, :B] for k in ("actions", "logp", "values",
                                      "rewards", "dones")}
    last_values = z["last_values"][:B].astype(np.float64)
    cfg = PPOConfig(**json.loads(str(z["ppo_config"])))
for k in ("node_features", "edge_features", "graph_features"):
    obs[k] = obs[k].astype(np.float64)
for k in ("logp", "values", "rewards"):
    traj[k] = traj[k].astype(np.float64)
traj["obs"] = obs
cfg = dataclasses.replace(cfg, num_sgd_iter=args["iters"],
                          sgd_minibatch_size=args["minibatch"])
learner = PPOLearner(lambda p, o: batched_policy_apply(model, p, o), cfg,
                     make_mesh(1))
state = learner.init_state(params)
straj, slv = learner.shard_traj(traj, last_values)
rng = jax.random.PRNGKey(args["seed"])
state, metrics = learner.train_step(state, straj, slv, rng)
out = {"perms": ex.epoch_permutations(rng, args["iters"], T * B),
       "kl_coeff": np.asarray(state.kl_coeff)}
out.update({k: np.asarray(v) for k, v in ex.serve_export.flatten(
    {"params": state.params["params"]}).items()})
out.update({"metrics/" + k: np.asarray(v) for k, v in metrics.items()})
np.savez(args["out"], **out)
print("X64_TRAIN_OK")
"""


def test_train_step_x64_matches_jax_train_step(tmp_path, fixture):
    """One whole update at the shipped widths on an [8, 4] slice of the
    real trajectory, 2 SGD iterations of 2 minibatches each, the JAX
    permutations handed over: the port in float64 (trimmed to the (38,
    128) bucket) against the JAX learner under x64 (at the env's pad) in
    a subprocess, 1e-9 on every param and metric."""
    out = tmp_path / "jax_x64.npz"
    args = {"scripts": os.path.join(REPO, "scripts"), "export": EXPORT_PATH,
            "fixture": TRAIN_PATH, "t": 8, "b": 4, "iters": 2,
            "minibatch": 16, "seed": 7, "out": str(out)}
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", X64_SCRIPT,
                          json.dumps(args)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    assert "X64_TRAIN_OK" in res.stdout
    ref = dict(np.load(out))

    cfg = dataclasses.replace(fixture["cfg"], num_sgd_iter=2,
                              sgd_minibatch_size=16)
    learner, params = _learner(cfg, torch.float64)
    traj, last = _slice(fixture, 8, 4)
    state = learner.init_state(params)
    state, metrics = learner.train_step(state, learner.stage_traj(traj,
                                                                  last),
                                        perms=ref["perms"])
    tree = params_to_flax(state.state_dict())
    assert sorted(tree) == sorted(k for k in ref if k.startswith("params/"))
    moved = 0.0
    for key, value in tree.items():
        assert value.dtype == np.float64
        np.testing.assert_allclose(value, ref[key], rtol=0, atol=1e-9,
                                   err_msg=key)
        moved = max(moved, float(np.abs(
            ref[key] - params_to_flax(params)[key]).max()))
    assert moved > 1e-4  # the update did move the params
    for key, value in metrics.items():
        np.testing.assert_allclose(float(value), float(ref[f"metrics/{key}"]),
                                   rtol=0, atol=1e-9, err_msg=key)
    assert float(state.kl_coeff) == float(ref["kl_coeff"])
    assert state.kl_coeff.dtype == torch.float32


def test_train_step_f32_one_iteration_matches_recorded_jax(fixture):
    """The fixture's own update (512 samples, 4 minibatches of 128, the
    recorded permutation) in float32 against the recorded JAX params,
    metrics and kl_coeff."""
    cfg = dataclasses.replace(fixture["cfg"], num_sgd_iter=1)
    run = fixture["runs"][1]
    learner, params = _learner(cfg)
    state = learner.init_state(params)
    state, metrics = learner.train_step(
        state, learner.stage_traj(fixture["traj"], fixture["last_values"]),
        perms=run["perms"])
    tree = params_to_flax(state.state_dict())
    for key, value in tree.items():
        np.testing.assert_allclose(value, run["params"][key], rtol=0,
                                   atol=1e-6, err_msg=key)
    for key, value in metrics.items():
        np.testing.assert_allclose(float(value), run["metrics"][key],
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    assert float(state.kl_coeff) == run["kl_coeff"]
    assert state.step == 4


def test_first_minibatch_gradients_match_recorded_jax(fixture):
    """The loss gradient at the shipped params on the first minibatch of
    the fixture's update, before any optimiser arithmetic (adam and the
    global-norm clip hide a gradient off by a constant factor), in float32
    against the recorded ``jax.value_and_grad``: each leaf within 1e-5 of
    its largest JAX gradient (observed 1.5e-6: sums in another order), each
    metric within 1e-5 of max(1, |JAX value|) (kl is ~0 here, its rounding
    is that of log-probabilities of size ~1)."""
    cfg = fixture["cfg"]
    learner, params = _learner(cfg)
    state = learner.init_state(params)
    staged = learner.stage_traj(fixture["traj"], fixture["last_values"])
    advs, targets = learner.flat_advantages(staged)
    idx = torch.as_tensor(
        fixture["runs"][1]["perms"][0][:cfg.sgd_minibatch_size])
    metrics, grads = learner.loss_and_grads(state, staged, idx, advs,
                                            targets)
    got = params_to_flax(dict(zip(state.names, grads)))
    ref = fixture["mb0"]["grads"]
    assert sorted(got) == sorted(ref)
    for key, value in got.items():
        scale = float(np.abs(ref[key]).max())
        assert scale > 0, key
        np.testing.assert_allclose(value, ref[key], rtol=0,
                                   atol=1e-5 * scale, err_msg=key)
    for i, key in enumerate(tppo.METRIC_KEYS):
        want = fixture["mb0"]["metrics"][key]
        assert abs(float(metrics[i]) - want) <= 1e-5 * max(1.0, abs(want)), \
            key
    assert state.step == 0


def test_train_step_repeats_bit_for_bit_and_draws_from_a_generator(fixture):
    """Two updates from the same params and generator seed give the same
    bits; randomness comes only from the explicit generator or perms."""
    cfg = dataclasses.replace(fixture["cfg"], num_sgd_iter=2,
                              sgd_minibatch_size=8)
    learner, params = _learner(cfg)
    traj, last = _slice(fixture, 4, 4)
    staged = learner.stage_traj(traj, last)
    results = []
    for _ in range(2):
        state = learner.init_state(params)
        gen = torch.Generator().manual_seed(5)
        state, metrics = learner.train_step(state, staged, generator=gen)
        results.append(({k: v.clone() for k, v in
                         state.state_dict().items()},
                        torch.stack([metrics[k] for k in metrics])))
    for key, value in results[0][0].items():
        assert torch.equal(value, results[1][0][key]), key
    assert torch.equal(results[0][1], results[1][1])
    with pytest.raises(ValueError, match="perms or a torch.Generator"):
        learner.train_step(learner.init_state(params), staged)
    with pytest.raises(ValueError, match="perms must be"):
        learner.train_step(learner.init_state(params), staged,
                           perms=np.zeros((1, 16), np.int64))


def test_learner_runs_on_the_card_unless_asked_for_the_cpu(fixture):
    model, _, _ = load_export(EXPORT_PATH)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tppo.PPOLearner(model, fixture["cfg"])


def test_stage_traj_rejects_out_of_range_actions(fixture):
    learner, _ = _learner(fixture["cfg"])
    traj, last = _slice(fixture, 2, 2)
    bad = dict(traj, actions=np.full_like(traj["actions"], 17))
    with pytest.raises(ValueError, match="actions must lie"):
        learner.stage_traj(bad, last)
