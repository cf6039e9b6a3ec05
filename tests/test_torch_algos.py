"""The port's IMPALA and PG learners (ddls_tpu_torch/rl/{impala,pg}.py,
their shared loss rl/actor_critic.py and the optimiser of rl/learner.py)
against the JAX ones (ddls_tpu/rl/{impala,pg}.py), on the CPU, where
every kernel wrapper takes its plain version.

Inputs come from numpy seeds or from the committed fixtures (a real
trajectory of the shipped policy and the JAX learners' updates of it,
ddls_tpu_torch/data). Tolerances, each with its reason:
* float64 against JAX under x64 (in this process through
  ``jax.enable_x64``, or in a JAX subprocess for whole updates): 1e-12
  on the scans, 1e-10 on the loss and its gradient, 1e-9 on params and
  metrics after three updates — the same arithmetic, sums reordered;
* float32 against JAX: 1e-6 relative on the scans (one rounding apart per
  operation); the recorded updates' params within 1e-5 of each leaf's
  largest magnitude (observed 3.1e-7) and their metrics within 1e-5 of
  max(1, |JAX value|) (observed 2.4e-6), with clip_rho_fraction per the
  rule at ``test_recorded_updates_f32_match_jax``.
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
import optax

from ddls_tpu.config import load_config
from ddls_tpu.parallel.mesh import make_mesh
from ddls_tpu.rl import impala as jimpala
from ddls_tpu.rl import pg as jpg
from ddls_tpu.train import loops as jloops
from ddls_tpu.train.compat import apply_reference_compat
from ddls_tpu_torch.models.convert import params_to_flax
from ddls_tpu_torch.rl import actor_critic as tac
from ddls_tpu_torch.rl import impala as timpala
from ddls_tpu_torch.rl import pg as tpg
from ddls_tpu_torch.rl.fixture import (AC_TRAIN_PATH, TRAIN_PATH,
                                       load_ac_fixture, load_train_fixture)
from ddls_tpu_torch.serve import load_export
from ddls_tpu_torch.serve.fixture import EXPORT_PATH
from ddls_tpu_torch.train import loops as tloops
from ddls_tpu_torch.train.__main__ import build_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_PATH = os.path.join(REPO, "scripts", "ramp_job_partitioning_configs")
F32_MIN = np.finfo(np.float32).min


def _scan_inputs(seed, t_len=23, lanes=5):
    """[T, B] V-trace inputs with episode ends at t = 0, mid-way and T - 1
    (lane 0) and on every step (lane 1), and importance weights far above
    and below both clips."""
    rng = np.random.default_rng(seed)
    behavior = rng.normal(-1.5, 0.5, (t_len, lanes))
    target = behavior + rng.normal(0, 1.5, (t_len, lanes))
    rewards = rng.normal(0, 1, (t_len, lanes))
    values = rng.normal(0, 3, (t_len, lanes))
    dones = rng.uniform(0, 1, (t_len, lanes)) < 0.1
    dones[[0, t_len // 2, t_len - 1], 0] = True
    dones[:, 1] = True
    last = rng.normal(0, 3, lanes)
    return behavior, target, rewards, values, dones, last


# ----------------------------------------------------------- the scans
@pytest.mark.parametrize("t_len", [23, 1])
def test_vtrace_and_reward_to_go_match_jax_x64(t_len):
    args = _scan_inputs(0, t_len)
    behavior, target, rewards, values, dones, last = args
    with jax.enable_x64(True):
        j_vs, j_adv = jimpala.vtrace(*map(jnp.asarray, args), gamma=0.99,
                                     clip_rho=1.0, clip_pg_rho=0.8)
        j_ret = jpg.reward_to_go(jnp.asarray(rewards), jnp.asarray(dones),
                                 0.99)
        j_vs, j_adv, j_ret = map(np.asarray, (j_vs, j_adv, j_ret))
    assert j_vs.dtype == np.float64
    t = torch.from_numpy
    vs, adv = timpala.vtrace(t(behavior), t(target), t(rewards), t(values),
                             t(dones), t(last), 0.99, 1.0, 0.8)
    ret = tpg.reward_to_go(t(rewards), t(dones), 0.99)
    for got, want in ((vs, j_vs), (adv, j_adv), (ret, j_ret)):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_vtrace_and_reward_to_go_match_jax_f32():
    args = [np.asarray(x, np.float32) if x.dtype == np.float64 else x
            for x in _scan_inputs(1)]
    behavior, target, rewards, values, dones, last = args
    j_vs, j_adv = map(np.asarray, jimpala.vtrace(*map(jnp.asarray, args),
                                                 gamma=0.99))
    j_ret = np.asarray(jpg.reward_to_go(jnp.asarray(rewards),
                                        jnp.asarray(dones), 0.99))
    t = torch.from_numpy
    fdones = t(dones.astype(np.float32))
    vs, adv = timpala.vtrace(t(behavior), t(target), t(rewards), t(values),
                             fdones, t(last), 0.99)
    ret = tpg.reward_to_go(t(rewards), fdones, 0.99)
    for got, want in ((vs, j_vs), (adv, j_adv), (ret, j_ret)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))


def test_hand_computed_pins_of_the_reference():
    """tests/test_algos.py's hand-computed V-trace and reward-to-go cases,
    replayed on the port."""
    t = lambda x: torch.tensor(x, dtype=torch.float64)
    zeros = t([[0.0], [0.0]])
    values, rewards, last = t([[1.0], [2.0]]), t([[1.0], [1.0]]), t([3.0])
    vs, adv = timpala.vtrace(zeros, zeros, rewards, values, zeros, last,
                             gamma=0.5)
    assert vs[:, 0].tolist() == pytest.approx([2.25, 2.5])
    assert adv[:, 0].tolist() == pytest.approx([1.25, 0.5])
    # rho = 4 clipped to 1: the on-policy answer
    vs_c, adv_c = timpala.vtrace(zeros, torch.full_like(zeros, np.log(4.0)),
                                 rewards, values, zeros, last, gamma=0.5)
    assert vs_c[:, 0].tolist() == pytest.approx(vs[:, 0].tolist())
    assert adv_c[:, 0].tolist() == pytest.approx(adv[:, 0].tolist())
    # an episode end at t = 0 cuts the bootstrap
    vs_d, _ = timpala.vtrace(zeros, zeros, rewards, values,
                             t([[1.0], [0.0]]), last, gamma=0.5)
    assert float(vs_d[0, 0]) == pytest.approx(1.0)
    rewards3 = t([[1.0], [2.0], [4.0]])
    g = tpg.reward_to_go(rewards3, torch.zeros_like(rewards3), 0.5)
    assert g[:, 0].tolist() == pytest.approx([3.0, 4.0, 4.0])
    g2 = tpg.reward_to_go(rewards3, t([[0.0], [1.0], [0.0]]), 0.5)
    assert g2[:, 0].tolist() == pytest.approx([2.0, 2.0, 4.0])


# ------------------------------------------------------------ the loss
def _loss_case(seed, t_len=6, lanes=4, a=7):
    """T-major [T, B] logits with masked actions, a fully masked row and a
    row with one valid action; actions, behaviour logp, values."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (t_len, lanes, a))
    mask = rng.uniform(0, 1, (t_len, lanes, a)) < 0.6
    mask[..., 0] = True
    mask[1, 2] = False
    mask[3, 1] = False
    mask[3, 1, 4] = True
    actions = np.array([[rng.choice(np.flatnonzero(m)) if m.any() else 0
                         for m in row] for row in mask], np.int32)
    masked = np.where(mask, logits, logits + F32_MIN)
    behavior = rng.normal(-1.2, 0.6, (t_len, lanes))
    values = rng.normal(0, 3, (t_len, lanes))
    rewards = rng.normal(0, 1, (t_len, lanes))
    dones = rng.uniform(0, 1, (t_len, lanes)) < 0.2
    last = rng.normal(0, 3, lanes)
    return masked, actions, behavior, values, rewards, dones, last


def _rows(x):
    """[T, B, ...] -> B-major rows [B*T, ...] (the staged order)."""
    x = np.swapaxes(np.asarray(x), 0, 1)
    return x.reshape((-1,) + x.shape[2:])


def _jax_loss(learner, logits, values, actions, behavior, rewards, dones,
              last, extra=None):
    """``jax.value_and_grad`` of the reference learner's own ``_loss`` with
    an apply_fn that hands back ``logits`` and ``values`` (T-major rows)
    as its params: (total, metrics, d total / d logits, d / d values)."""
    t_len, lanes = rewards.shape
    params = {"logits": jnp.asarray(logits.reshape(t_len * lanes, -1)),
              "values": jnp.asarray(values.reshape(-1))}
    learner.apply_fn = lambda p, obs: (p["logits"], p["values"])
    traj = {"obs": {"x": jnp.zeros((t_len, lanes, 1))},
            "actions": jnp.asarray(actions), "logp": jnp.asarray(behavior),
            "rewards": jnp.asarray(rewards), "dones": jnp.asarray(dones)}
    third = jnp.asarray(last) if extra is None else extra
    (total, metrics), grads = jax.value_and_grad(
        learner._loss, has_aux=True)(params, traj, third)
    return (float(total), {k: float(v) for k, v in metrics.items()},
            np.asarray(grads["logits"]).reshape(t_len, lanes, -1),
            np.asarray(grads["values"]).reshape(t_len, lanes))


@pytest.mark.parametrize("drop_last", [True, False])
def test_impala_loss_value_and_grad_match_the_reference_x64(drop_last):
    """ac_logp -> vtrace -> ac_loss (plain versions, float64, B-major rows)
    against the reference ``ImpalaLearner._loss`` under x64: loss, the six
    metrics, and the gradient with respect to logits and values."""
    masked, actions, behavior, values, rewards, dones, last = _loss_case(3)
    cfg = jimpala.ImpalaConfig(vtrace_drop_last_ts=drop_last,
                               vtrace_clip_pg_rho_threshold=0.9)
    with jax.enable_x64(True):
        learner = jimpala.ImpalaLearner(None, cfg, make_mesh(1))
        j_total, j_metrics, j_dlogits, j_dvalues = _jax_loss(
            learner, masked, values, actions, behavior, rewards, dones,
            last)
    t_len, lanes = rewards.shape
    t = torch.from_numpy
    logits = t(_rows(masked)).requires_grad_(True)
    vals = t(_rows(values)).requires_grad_(True)
    acts = t(_rows(actions))
    target = tac.ac_logp(logits.detach(), acts)
    tb = lambda x: x.reshape(lanes, t_len).t()
    vs, pg_adv = timpala.vtrace(tb(t(_rows(behavior))), tb(target),
                                t(rewards), tb(vals.detach()),
                                t(dones.astype(np.float64)), t(last),
                                cfg.gamma, cfg.vtrace_clip_rho_threshold,
                                cfg.vtrace_clip_pg_rho_threshold)
    total, metrics = tac.ac_loss(
        logits, vals, acts, pg_adv.t().reshape(-1), vs.t().reshape(-1),
        t(_rows(behavior)), t_len, drop_last, cfg.vf_loss_coeff,
        cfg.entropy_coeff, cfg.vtrace_clip_rho_threshold)
    dlogits, dvalues = torch.autograd.grad(total, (logits, vals))
    assert float(total.detach()) == pytest.approx(j_total, abs=1e-10)
    for i, key in enumerate(timpala.METRIC_KEYS):
        assert float(metrics[tac.AC_METRIC_KEYS.index(key)]) == \
            pytest.approx(j_metrics[key], abs=1e-10), key
    np.testing.assert_allclose(dlogits.numpy(), _rows(j_dlogits), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(dvalues.numpy(), _rows(j_dvalues), rtol=0,
                               atol=1e-10)
    dropped = dlogits.reshape(lanes, t_len, -1)[:, -1]
    assert bool((dropped == 0).all()) == drop_last


def test_pg_loss_value_and_grad_match_the_reference_x64():
    """ac_loss with vf_coeff = ent_coeff = 0 and no dropped step against
    the reference ``PGLearner._loss``: loss, metrics, the logits' gradient,
    and no gradient into the values."""
    masked, actions, behavior, values, rewards, dones, _ = _loss_case(4)
    cfg = jpg.PGConfig()
    with jax.enable_x64(True):
        returns = jpg.reward_to_go(jnp.asarray(rewards), jnp.asarray(dones),
                                   cfg.gamma)
        learner = jpg.PGLearner(None, cfg, make_mesh(1))
        j_total, j_metrics, j_dlogits, j_dvalues = _jax_loss(
            learner, masked, values, actions, behavior, rewards, dones,
            None, extra=returns)
        returns = np.asarray(returns)
    assert not j_dvalues.any()
    t_len = rewards.shape[0]
    t = torch.from_numpy
    logits = t(_rows(masked)).requires_grad_(True)
    vals = t(_rows(values))
    total, metrics = tac.ac_loss(logits, vals, t(_rows(actions)),
                                 t(_rows(returns)), vals,
                                 t(_rows(behavior)), t_len, False, 0.0, 0.0,
                                 1.0)
    (dlogits,) = torch.autograd.grad(total, (logits,))
    assert float(total.detach()) == pytest.approx(j_total, abs=1e-10)
    got = dict(zip(tac.AC_METRIC_KEYS, metrics.tolist()))
    got["mean_return_to_go"] = got["mean_weight"]
    for key in tpg.METRIC_KEYS:
        assert got[key] == pytest.approx(j_metrics[key], abs=1e-10), key
    np.testing.assert_allclose(dlogits.numpy(), _rows(j_dlogits), rtol=0,
                               atol=1e-10)


def test_ac_loss_grad_plain_is_autograd_of_the_plain_loss():
    masked, actions, behavior, values, _, _, _ = _loss_case(5)
    t = torch.from_numpy
    args = (t(_rows(masked)).float(), t(_rows(values)).float(),
            t(_rows(actions)), t(_rows(values)).float() * 0.5,
            t(_rows(values)).float() + 1.0, t(_rows(behavior)).float(), 6,
            True, 0.5, 0.01, 1.0)
    total, metrics, dlogits, dvalues = tac.ac_loss_grad_plain(*args)
    ref_total, ref_metrics = tac.ac_loss(*args)
    assert torch.equal(total, ref_total) and torch.equal(metrics,
                                                         ref_metrics)
    assert dlogits.shape == args[0].shape and dvalues.shape == args[1].shape
    assert bool((dlogits.reshape(4, 6, -1)[:, -1] == 0).all())


# -------------------------------------------------------- the optimiser
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_rmsprop_matches_optax_x64(momentum):
    """The rmsprop branch (clip_by_global_norm, then optax.rmsprop with eps
    inside the root) against optax under x64 over three steps, the second
    clipped; momentum 0 keeps no trace in the state."""
    rng = np.random.default_rng(6)
    shapes = [(4, 3), (3,), (2, 5)]
    params = [rng.normal(0, 1, s) for s in shapes]
    grads = [[rng.normal(0, scale, s) for s in shapes]
             for scale in (1.0, 30.0, 0.5)]
    cfg = timpala.ImpalaConfig(opt_type="rmsprop", momentum=momentum,
                               grad_clip=40.0)
    with jax.enable_x64(True):
        tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                         optax.rmsprop(cfg.lr, decay=cfg.decay,
                                       momentum=cfg.momentum,
                                       eps=cfg.epsilon))
        j_params = [jnp.asarray(p) for p in params]
        opt_state = tx.init(j_params)
        for g in grads:
            updates, opt_state = tx.update([jnp.asarray(x) for x in g],
                                           opt_state, j_params)
            j_params = optax.apply_updates(j_params, updates)
        j_params = [np.asarray(p) for p in j_params]
    model = torch.nn.Module()
    for i, p in enumerate(params):
        model.register_parameter(f"p{i}", torch.nn.Parameter(
            torch.from_numpy(p.copy())))
    learner = timpala.ImpalaLearner(model, cfg, device="cpu")
    state = learner.init_state()
    assert (state.mu is None) == (momentum == 0.0)
    assert state.kl_coeff is None
    order = [int(n[1:]) for n in state.names]
    with torch.no_grad():
        for g in grads:
            learner._apply_optimizer(state, [torch.from_numpy(g[i])
                                             for i in order])
            state.step += 1
    for name, p in zip(state.names, state.params):
        np.testing.assert_allclose(p.detach().numpy(),
                                   j_params[int(name[1:])], rtol=0,
                                   atol=1e-12)


# --------------------------------------------------- whole updates, x64
X64_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import jax
import jax.numpy as jnp

assert jax.config.read("jax_enable_x64")
args = json.loads(sys.argv[1])
sys.path.insert(0, args["scripts"])
import export_torch_serve_fixture as serve_export
from ddls_tpu.models.policy import GNNPolicy, batched_policy_apply
from ddls_tpu.parallel.mesh import make_mesh
from ddls_tpu.rl.impala import ImpalaConfig, ImpalaLearner
from ddls_tpu.rl.pg import PGConfig, PGLearner

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
for k in ("node_features", "edge_features", "graph_features"):
    obs[k] = obs[k].astype(np.float64)
for k in ("logp", "values", "rewards"):
    traj[k] = traj[k].astype(np.float64)
traj["obs"] = obs
out = {}
for name, (cls, cfg_cls, cfg) in args["runs"].items():
    cfg = {"impala": ImpalaConfig, "pg": PGConfig}[cfg_cls](**cfg)
    learner = {"impala": ImpalaLearner, "pg": PGLearner}[cls](
        lambda p, o: batched_policy_apply(model, p, o), cfg, make_mesh(1))
    state = learner.init_state(params)
    for step in range(args["steps"]):
        straj, slv = learner.shard_traj(traj, last_values)
        state, metrics = learner.train_step(state, straj, slv)
        prefix = f"{name}/{step}/"
        out.update({prefix + k: np.asarray(v) for k, v in
                    serve_export.flatten(
                        {"params": state.params["params"]}).items()})
        out.update({prefix + "metrics/" + k: np.asarray(v)
                    for k, v in metrics.items()})
np.savez(args["out"], **out)
print("X64_TRAIN_OK")
"""

X64_RUNS = {
    "impala_adam": ("impala", "impala", {"vtrace_clip_pg_rho_threshold": 0.9}),
    "impala_rmsprop": ("impala", "impala", {"opt_type": "rmsprop"}),
    "pg": ("pg", "pg", {"grad_clip": 1.0}),
}


@pytest.fixture(scope="module")
def x64_reference(tmp_path_factory):
    """The JAX learners under x64 in a subprocess: 3 successive updates of
    an [8, 4] slice of the recorded trajectory for each run of
    ``X64_RUNS``."""
    out = tmp_path_factory.mktemp("x64") / "jax_x64.npz"
    args = {"scripts": os.path.join(REPO, "scripts"), "export": EXPORT_PATH,
            "fixture": TRAIN_PATH, "t": 8, "b": 4, "steps": 3,
            "runs": X64_RUNS, "out": str(out)}
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", X64_SCRIPT,
                          json.dumps(args)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    assert "X64_TRAIN_OK" in res.stdout
    return dict(np.load(out))


def _slice(fx, t_len, lanes):
    traj = {"obs": {k: v[:t_len, :lanes]
                    for k, v in fx["traj"]["obs"].items()}}
    for key in ("actions", "logp", "values", "rewards", "dones"):
        traj[key] = fx["traj"][key][:t_len, :lanes]
    return traj, fx["last_values"][:lanes]


@pytest.mark.parametrize("run", sorted(X64_RUNS))
def test_train_step_x64_matches_jax_over_three_updates(x64_reference, run):
    """Three whole updates at the shipped widths, the port in float64
    (trimmed to the (38, 128) bucket) against the JAX learner under x64 (at
    the env's pad): 1e-9 on every param and metric after each update
    (adam, rmsprop, PG with its value head left in place)."""
    cls, _, overrides = X64_RUNS[run]
    learner_cls, cfg_cls = ((timpala.ImpalaLearner, timpala.ImpalaConfig)
                            if cls == "impala" else
                            (tpg.PGLearner, tpg.PGConfig))
    model, params, _ = load_export(EXPORT_PATH)
    learner = learner_cls(model.double(), cfg_cls(**overrides),
                          device="cpu")
    params = {k: v.double() for k, v in params.items()}
    traj, last = _slice(load_train_fixture(), 8, 4)
    staged = learner.stage_traj(traj, last)
    state = learner.init_state(params)
    start = params_to_flax(params)
    for step in range(3):
        state, metrics = learner.train_step(state, staged)
        tree = params_to_flax(state.state_dict())
        prefix = f"{run}/{step}/"
        for key, value in tree.items():
            assert value.dtype == np.float64
            np.testing.assert_allclose(value, x64_reference[prefix + key],
                                       rtol=0, atol=1e-9, err_msg=key)
        assert set(metrics) == {k[len(prefix) + len("metrics/"):]
                                for k in x64_reference
                                if k.startswith(prefix + "metrics/")}
        for key, value in metrics.items():
            np.testing.assert_allclose(
                float(value), float(x64_reference[prefix + "metrics/" + key]),
                rtol=0, atol=1e-9, err_msg=key)
    assert state.step == 3
    moved = {k: float(np.abs(tree[k] - start[k]).max()) for k in tree}
    assert max(moved.values()) > 1e-4
    if cls == "pg":  # the value head is not in PG's loss
        assert all(v == 0.0 for k, v in moved.items() if "value_head" in k)


# ----------------------------------------- the recorded f32 updates
@pytest.mark.parametrize("algo", ["impala", "pg"])
def test_recorded_updates_f32_match_jax(algo):
    """The fixture's three recorded JAX updates of the real 8 x 64
    trajectory, in float32: params within 1e-5 of each leaf's largest
    magnitude, metrics within 1e-5 of max(1, |JAX value|), IMPALA's
    V-trace inputs and outputs within 1e-5 of their largest magnitude.

    clip_rho_fraction counts rho > 1 strictly. At update 1 the params are
    the behaviour policy's, every rho is 1 to within float32 rounding and
    each row is a coin flip between two correct forwards: the rows with
    |rho - 1| <= 1e-5 (all 504 here) are excluded and the rest must agree
    row by row. At updates 2-3 the clip engages and the metric must be
    exactly JAX's."""
    fx = load_ac_fixture()[algo]
    train = load_train_fixture()
    cls = timpala.ImpalaLearner if algo == "impala" else tpg.PGLearner
    model, params, _ = load_export(EXPORT_PATH)
    learner = cls(model, fx["cfg"], device="cpu")
    staged = learner.stage_traj(train["traj"], train["last_values"])
    state = learner.init_state(params)
    behavior = train["traj"]["logp"][:-1]
    excluded = []
    for step, ref in enumerate(fx["steps"], start=1):
        if algo == "impala":
            _, _, (target_logp, vs, pg_adv) = learner.loss_and_grads(state,
                                                                     staged)
            for got, key in ((target_logp, "target_logp"), (vs, "vs"),
                             (pg_adv, "pg_adv")):
                scale = float(np.abs(ref[key]).max())
                np.testing.assert_allclose(got.numpy(), ref[key], rtol=0,
                                           atol=1e-5 * scale, err_msg=key)
            rho_jax = np.exp(ref["target_logp"][:-1] - behavior)
            rho = np.exp(target_logp.numpy()[:-1] - behavior)
            decided = np.abs(rho_jax - 1.0) > 1e-5
            np.testing.assert_array_equal((rho > 1.0)[decided],
                                          (rho_jax > 1.0)[decided])
            excluded.append(int((~decided).sum()))
        else:
            _, _, returns = learner.loss_and_grads(state, staged)
            np.testing.assert_allclose(returns.numpy(), fx["returns"],
                                       rtol=1e-6, atol=1e-6)
        state, metrics = learner.train_step(state, staged)
        tree = params_to_flax(state.state_dict())
        for key, value in tree.items():
            scale = float(np.abs(ref["params"][key]).max())
            np.testing.assert_allclose(value, ref["params"][key], rtol=0,
                                       atol=1e-5 * scale, err_msg=key)
        assert set(metrics) == set(ref["metrics"])
        for key, value in metrics.items():
            want = ref["metrics"][key]
            if key == "clip_rho_fraction":
                bound = excluded[0] / behavior.size if step == 1 else 0.0
                assert abs(float(value) - want) <= bound
                continue
            assert abs(float(value) - want) <= 1e-5 * max(1.0, abs(want)), \
                key
    if algo == "impala":
        assert excluded[0] == 504  # update 1: every row is a coin flip


# ------------------------------------------------------------ configs
def _algo_yaml(algo):
    return apply_reference_compat(load_config(
        CONFIG_PATH, "rllib_config", [f"algo={algo}"]))["algo"]["algo_config"]


def test_config_translators_match_the_reference():
    for algo, port, ref, cls, jcls in (
            ("impala", tloops.impala_config_from_rllib,
             jloops.impala_config_from_rllib, timpala.ImpalaConfig,
             jimpala.ImpalaConfig),
            ("pg", tloops.pg_config_from_rllib, jloops.pg_config_from_rllib,
             tpg.PGConfig, jpg.PGConfig)):
        assert dataclasses.asdict(cls()) == dataclasses.asdict(jcls())
        algo_cfg = _algo_yaml(algo)
        assert dataclasses.asdict(port(algo_cfg)) == \
            dataclasses.asdict(ref(algo_cfg))
        for bad in ("learner_queue_size", "lambda"):
            with pytest.raises(ValueError, match="not consumed"):
                ref(dict(algo_cfg, **{bad: 1}))
            with pytest.raises(ValueError, match="not consumed"):
                port(dict(algo_cfg, **{bad: 1}))
    assert tloops.EPOCH_LOOPS["impala"] is tloops.ImpalaEpochLoop
    assert tloops.EPOCH_LOOPS["pg"] is tloops.PGEpochLoop


# ------------------------------------------------- loops and the CLI
TINY = ["env_config=env_small", "epoch_loop=epoch_loop_default",
        "epoch_loop.num_envs=2", "epoch_loop.rollout_length=8",
        "env_config.max_simulation_run_time=2000"]


def _tiny(algo):
    return apply_reference_compat(load_config(
        CONFIG_PATH, "rllib_config", [f"algo={algo}"] + TINY))


@pytest.mark.parametrize("algo", ["impala", "pg"])
def test_one_cpu_epoch_trains_repeats_and_round_trips(algo, tmp_path):
    """One epoch of each loop on the tiny config: the reference's metric
    keys, finite, params moved; a second loop from the same seed gives the
    same bits; a checkpoint round-trips bit for bit."""
    runs = []
    for _ in range(2):
        loop = build_loop(_tiny(algo), "cpu")
        before = {k: v.clone() for k, v in loop.state.state_dict().items()}
        results = loop.run()
        runs.append((results["learner"], {
            k: v.clone() for k, v in loop.state.state_dict().items()}))
        if len(runs) == 1:
            path = loop.save_agent_checkpoint(str(tmp_path / "ckpt"))
            saved = loop.state
            snapshot = ([p.detach().clone() for p in saved.params],
                        [n.clone() for n in saved.nu],
                        [m.clone() for m in saved.mu], saved.step)
            loop.run()
            loop.load_agent_checkpoint(path)
            assert all(torch.equal(a, b) for a, b in
                       zip(snapshot[0], loop.state.params))
            assert all(torch.equal(a, b) for a, b in
                       zip(snapshot[1], loop.state.nu))
            assert all(torch.equal(a, b) for a, b in
                       zip(snapshot[2], loop.state.mu))
            assert loop.state.step == snapshot[3] == 1
            assert loop.state.kl_coeff is None
        loop.close()
    learner, after = runs[0]
    keys = timpala.METRIC_KEYS if algo == "impala" else tpg.METRIC_KEYS
    assert list(learner) == list(keys)
    assert all(np.isfinite(v) for v in learner.values())
    assert any(not torch.equal(before[k], after[k]) for k in before)
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(v, runs[1][1][k]) for k, v in after.items())
    assert results["env_steps_this_iter"] == 16


def test_loops_size_rollouts_from_the_algo_yaml():
    """With the epoch loop's sizes unset, each algo yaml sizes the rollout:
    IMPALA 32 envs x (500 // 32) steps, PG 8 x (200 // 8)."""
    for algo, want in (("impala", (32, 15)), ("pg", (8, 25))):
        kwargs = tloops.build_epoch_loop_kwargs(_tiny(algo))
        kwargs.update(num_envs=None, rollout_length=None, device="cpu",
                      loop_mode="sequential")
        loop = tloops.EPOCH_LOOPS[algo].__new__(tloops.EPOCH_LOOPS[algo])
        loop._configure_algo(kwargs["algo_config"], None, None)
        assert (loop.num_envs, loop.rollout_length) == want
    # stale collection is IMPALA's, and only in the pipelined loop
    with pytest.raises(ValueError, match="requires loop_mode='pipelined'"):
        kwargs = tloops.build_epoch_loop_kwargs(_tiny("impala"))
        tloops.make_epoch_loop("impala", **dict(
            kwargs, device="cpu", loop_mode="sequential", pipeline_depth=1))


def test_entry_point_trains_impala_on_the_cpu(tmp_path):
    cfg_path = tmp_path / "tiny_impala.json"
    cfg_path.write_text(json.dumps(_tiny("impala")))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "ddls_tpu_torch.train", "--config",
         str(cfg_path), "--device", "cpu", "--epochs", "1",
         "--checkpoint-dir", str(tmp_path / "run")],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln]
    assert list(lines[0]["learner"]) == list(timpala.METRIC_KEYS)
    assert all(np.isfinite(v) for v in lines[0]["learner"].values())
    assert lines[-1]["epochs"] == 1
    saved = torch.load(os.path.join(lines[-1]["checkpoint"],
                                    "train_state.pt"), weights_only=True)
    assert "kl_coeff" not in saved and "mu" in saved
    assert os.path.getsize(AC_TRAIN_PATH) > 0
