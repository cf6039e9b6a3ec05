"""The in-kernel OracleJCT episode (``make_oracle_episode_fn``) and the
price-feature policy episode (``make_policy_episode_fn``) under a
scenario, on the CPU through the plain versions, against the JAX
package's own functions (``ddls_tpu/sim/jax_env.py``) under x64.

The surface is the registry's ``failures`` spec (8 servers, its speeds,
loadgen arrivals), its env with native candidate pricing and the price
block in the observation; one bank of 60 jobs sampled from it, equal on
both sides. Two scenarios: the spec's own (four windows) and a dense
fuzzed one on the same surface (``fuzzed_scenario``: 24 windows of both
kinds, speeds between 0.5 and 1.5). Each episode holds against the reference's: actions,
rewards, accepts, causes and ``has_job`` equal; t and jct within rel 1e-9
(``tests/test_jax_episode.py``'s limit: the two are different float64
programs). The policy's logp and value are not held: the reference's
forward runs its float32 parameters in float32, the port's in float64.
The failure walk acts: the jct trace differs from the same episode's
without the scenario, and a replay of the episode's actions through
``make_episode_fn``'s steps gives the same jct and counts the walk's
branches (under the dense scenario each episode takes all three: a
preemption's push, a straggler that fits, one that spills).

One intra-op thread, as the other torch test modules."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ddls_tpu.scenarios as ref
from ddls_tpu.envs import RampJobPartitioningEnvironment as RefEnv
from ddls_tpu.hardware.topologies import build_topology as ref_topology
from ddls_tpu.models.policy import GNNPolicy as RefPolicy
from ddls_tpu.sim import jax_env
from ddls_tpu_torch import scenarios as port
from ddls_tpu_torch.envs import RampJobPartitioningEnvironment as PortEnv
from ddls_tpu_torch.hardware.topologies import build_topology
from ddls_tpu_torch.models.convert import flatten_tree, params_from_flax
from ddls_tpu_torch.models.policy import GNNPolicy
from ddls_tpu_torch.sim import device_env
from ddls_tpu_torch.sim.fixture import (POLICY_ARCH, fuzzed_scenario,
                                        scenario_episode_diffs)

torch.set_num_threads(1)

REL = 1e-9
BANK_JOBS, BANK_SEED = 60, 3
PRICES = dict(candidate_pricing="native", obs_include_candidate_prices=True)
ORACLE_NAMES = ("action", "reward", "accept", "cause", "jct", "t", "has_job")
POLICY_NAMES = ("action", "logp", "value", "reward", "accept", "cause",
                "jct", "t", "has_job")
TAKEN = ("preempt_push", "straggle_fit", "straggle_spill")


def build_surface():
    ps, rs = port.failures_spec(), ref.failures_spec()
    penv = PortEnv(**port.env_kwargs(ps), **PRICES, device="cpu",
                   scenario_runtime=port.build_runtime(
                       ps, build_topology(ps.topology)))
    renv = RefEnv(**ref.env_kwargs(rs), **PRICES,
                  scenario_runtime=ref.build_runtime(
                      rs, ref_topology(rs.topology)))
    obs = penv.reset(seed=0)
    robs = renv.reset(seed=0)
    et = device_env.build_episode_tables(penv)
    ot = device_env.build_obs_tables(penv, et)
    bank = device_env.sample_job_bank(et, penv, BANK_JOBS, BANK_SEED)
    rbank = jax_env.sample_job_bank(jax_env.build_episode_tables(renv),
                                    renv, BANK_JOBS, BANK_SEED)
    for name, value in bank.items():
        np.testing.assert_array_equal(value, rbank[name], err_msg=name)
    with jax.enable_x64(True):
        ret = jax_env.build_episode_tables(renv)
        rot = jax_env.build_obs_tables(renv, ret)
        rmodel = RefPolicy(n_actions=renv.max_partitions_per_op + 1,
                           **POLICY_ARCH)
        params = rmodel.init(jax.random.PRNGKey(7),
                             jax.tree_util.tree_map(jnp.asarray, robs))
    model = GNNPolicy(n_actions=penv.max_partitions_per_op + 1,
                      graph_feature_dim=obs["graph_features"].shape[0],
                      **POLICY_ARCH)
    model.load_state_dict(params_from_flax(flatten_tree(params), model))
    model = model.double().eval()
    horizon = float(bank["arrival_t"][np.isfinite(bank["arrival_t"])][-1])
    scenarios = {"spec": et.scenario,
                 "dense": fuzzed_scenario(et, horizon + 2000.0)}
    assert et.scenario is not None
    return {"et": et, "ot": ot, "ret": ret, "rot": rot, "bank": bank,
            "model": model, "rmodel": rmodel, "params": params,
            "scenarios": scenarios}


@pytest.fixture(scope="module")
def surface():
    return build_surface()


def _with(et, scenario):
    return dataclasses.replace(et, scenario=scenario, on_device={})


def _reference(s, which, policy):
    ret = dataclasses.replace(s["ret"], scenario=s["scenarios"][which])
    with jax.enable_x64(True):
        bank = {k: jnp.asarray(v) for k, v in s["bank"].items()}
        if policy:
            fn = jax.jit(jax_env.make_policy_episode_fn(
                ret, s["rot"], s["rmodel"], greedy=True))
            out = fn(bank, s["params"], jax.random.PRNGKey(0))
        else:
            out = jax.jit(jax_env.make_oracle_episode_fn(ret, s["rot"]))(
                bank)
        return ({k: np.asarray(v) for k, v in out.items() if k != "trace"},
                [np.asarray(x) for x in out["trace"]])


def _port(s, scenario, policy):
    et = _with(s["et"], scenario)
    if policy:
        fn = device_env.make_policy_episode_fn(
            et, s["ot"], s["model"], greedy=True, device="cpu",
            dtype=torch.float64)
    else:
        fn = device_env.make_oracle_episode_fn(et, s["ot"], device="cpu",
                                               dtype=torch.float64)
    return fn(s["bank"])


def _hold(out, rout, rtrace, names):
    trace = {n: x.numpy() for n, x in zip(names, out["trace"])}
    for name, want in zip(names, rtrace):
        if name in ("jct", "t"):
            np.testing.assert_allclose(trace[name], want, rtol=REL, atol=0,
                                       err_msg=name)
        elif name not in ("logp", "value"):
            np.testing.assert_array_equal(trace[name], want, err_msg=name)
    for key in ("accepted", "blocked", "completed", "arrived",
                "blocked_total"):
        assert int(out[key]) == int(rout[key]), key
    return trace


def _branches(s, scenario, actions):
    """The failure walk's branch counts over a replay of ``actions`` on
    the bank (``make_episode_fn``'s steps, ``scenario_episode_diffs``),
    and its jct trace."""
    et = _with(s["et"], scenario)
    ek = device_env.episode_kernels(et, device="cpu", dtype=torch.float64)
    bank = {name: torch.from_numpy(s["bank"][name][None]).to(
        want or torch.float64) for name, want in device_env.BANK_FIELDS}
    acts = torch.from_numpy(actions[None].astype(np.int32))
    _, _, trace, branches = scenario_episode_diffs(ek, bank, acts,
                                                   acts.shape[1])
    return branches, trace["jct"][0].numpy()


@pytest.mark.parametrize("which", ["spec", "dense"])
@pytest.mark.parametrize("policy", [False, True],
                         ids=["oracle", "price_policy"])
def test_episode_under_scenario_equals_reference(surface, which, policy):
    s = surface
    scenario = s["scenarios"][which]
    names = POLICY_NAMES if policy else ORACLE_NAMES
    rout, rtrace = _reference(s, which, policy)
    out = _port(s, scenario, policy)
    trace = _hold(out, rout, rtrace, names)
    n = int(trace["has_job"].sum())
    assert n > 20 and trace["accept"].any() and (trace["cause"] > 0).any()
    nominal = _port(s, None, policy)
    moved = trace["jct"] != nominal["trace"][names.index("jct")].numpy()
    assert moved.sum() > 5, int(moved.sum())
    # the same decisions replayed through the episode's step: the same
    # adjusted jct, and under the dense scenario every walk branch taken
    branches, jct = _branches(s, scenario, trace["action"])
    np.testing.assert_array_equal(jct, trace["jct"])
    if which == "dense":
        assert all(branches[k] > 0 for k in TAKEN), branches
