"""K9's plain version against the JAX sampler: the port's
``mask_sample_logp_plain`` on the uniforms that ``jax.random.categorical``
draws from a key makes the reference's ``_sample_actions`` decision
(ddls_tpu/rl/ppo.py:262 over ddls_tpu/models/policy.py:87's masked
logits): actions equal, logp within 1e-6 in float32 (the two frameworks
sum the softmax in other orders) and within 1e-12 in float64. The rows are
the shipped policy's raw logits on real rollout observations plus edge
cases: a fully masked row, a one-valid-action row, an exact tie and a
near tie of ``m + g``. On the CPU the wrapper takes the plain version."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddls_tpu.models.policy import GNNPolicy as JaxPolicy
from ddls_tpu.rl.ppo import PPOLearner as JaxLearner
from ddls_tpu_torch.models.policy import (FLOAT32_TINY, gumbel_uniforms,
                                          mask_sample_logp,
                                          mask_sample_logp_plain)
from ddls_tpu_torch.rl.fixture import load_train_fixture
from ddls_tpu_torch.rl.ppo import PPOLearner
from ddls_tpu_torch.serve.fixture import EXPORT_PATH
from ddls_tpu_torch.serve.server import load_export

N_STEPS = 4  # rollout steps of the fixture (8 envs each) used as rows


@pytest.fixture(scope="module")
def rows():
    """(raw logits [R, 17] float64, action mask [R, 17] int32): the shipped
    policy's raw logits on the fixture's first rollout steps, then the
    edge-case rows (fully masked, one valid action, exact tie, near tie;
    every other entry of a tie row far below any Gumbel draw's reach)."""
    model, params, _ = load_export(EXPORT_PATH)
    learner = PPOLearner(model, load_train_fixture()["cfg"], device="cpu")
    learner.init_state(params)
    fx = load_train_fixture()
    logits, masks = [], []
    for t in range(N_STEPS):
        obs = {k: v[t] for k, v in fx["traj"]["obs"].items()}
        with torch.no_grad():
            raw, _ = learner.model.trunk(learner.device_batch(obs))
        logits.append(raw.double().numpy())
        masks.append(obs["action_mask"].astype(np.int32))
    logits, masks = np.concatenate(logits), np.concatenate(masks)
    a = logits.shape[1]
    edge_l = np.zeros((4, a))
    edge_m = np.ones((4, a), np.int32)
    edge_m[0] = 0
    edge_m[1] = 0
    edge_m[1, 7] = 1
    edge_l[1, 7] = -3.25
    edge_l[2:] = -20.0
    edge_l[2, 3] = edge_l[2, 5] = 4.0
    edge_l[3, 2] = 4.0
    edge_l[3, 6] = np.nextafter(np.float32(4.0), np.float32(5.0))
    return np.concatenate([logits, edge_l]), np.concatenate([masks, edge_m])


def _jax_sample(logits, mask, key):
    """The reference's ``_sample_actions`` with an apply_fn that returns
    these logits through ``GNNPolicy._mask_logits``."""
    masker = types.SimpleNamespace(apply_action_mask=True)

    def apply_fn(params, obs):
        return JaxPolicy._mask_logits(masker, obs["logits"],
                                      obs["mask"]), obs["values"]

    obs = {"logits": jnp.asarray(logits), "mask": jnp.asarray(mask),
           "values": jnp.zeros(logits.shape[0], logits.dtype)}
    me = types.SimpleNamespace(apply_fn=apply_fn)
    actions, logp, _ = JaxLearner._sample_actions(me, None, obs, key)
    return np.asarray(actions), np.asarray(logp)


def _uniforms(key, shape, dtype):
    """The uniforms ``categorical`` draws from ``key`` (``_gumbel`` mode
    "low")."""
    return np.array(jax.random.uniform(key, shape, dtype,
                                       minval=jnp.finfo(dtype).tiny,
                                       maxval=1.0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_jax_sampling_float32(rows, seed):
    logits64, mask = rows
    logits = logits64.astype(np.float32)
    key = jax.random.PRNGKey(seed)
    u = _uniforms(key, logits.shape, jnp.float32)
    # the tie rows draw one uniform for both of their candidates
    n = logits.shape[0] - 4
    u[n + 2, 5] = u[n + 2, 3]
    u[n + 3, 6] = u[n + 3, 2]
    want_a, want_logp = _jax_sample(logits, mask, key)
    got_a, got_logp = mask_sample_logp(torch.from_numpy(logits),
                                       torch.from_numpy(mask),
                                       torch.from_numpy(u))
    assert got_a.dtype == torch.int32 and got_logp.dtype == torch.float32
    # the real rows, the fully masked row and the one-valid-action row
    # (the tie rows' uniforms were edited above, so JAX drew others there)
    real = slice(0, n + 2)
    np.testing.assert_array_equal(got_a.numpy()[real], want_a[real])
    np.testing.assert_allclose(got_logp.numpy()[real], want_logp[real],
                               rtol=0, atol=1e-6)
    # categorical drew exactly these uniforms: its argmax of m + g
    with np.errstate(divide="ignore"):  # log(0) = -inf, then the floor
        masked = logits + np.maximum(np.log(mask.astype(np.float32)),
                                     np.finfo(np.float32).min)
    np.testing.assert_array_equal(
        np.argmax(masked - np.log(-np.log(u)), axis=1)[real], want_a[real])
    # the edge rows, against their closed forms
    a_count = logits.shape[1]
    assert got_a[n] == 0
    assert abs(float(got_logp[n]) + np.log(a_count)) <= 1e-6
    assert got_a[n + 1] == 7 and float(got_logp[n + 1]) == 0.0
    assert got_a[n + 2] == 3  # an exact tie goes to the lower index
    assert got_a[n + 3] == 6  # one float32 step apart: the larger wins


@pytest.mark.parametrize("seed", [0, 3])
def test_plain_matches_jax_sampling_float64(rows, seed):
    logits, mask = rows
    key = jax.random.PRNGKey(seed)
    with jax.enable_x64(True):
        u = _uniforms(key, logits.shape, jnp.float64)
        want_a, want_logp = _jax_sample(logits, mask, key)
        assert want_logp.dtype == np.float64
    got_a, got_logp = mask_sample_logp_plain(torch.from_numpy(logits),
                                             torch.from_numpy(mask),
                                             torch.from_numpy(u))
    assert got_logp.dtype == torch.float64
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    np.testing.assert_allclose(got_logp.numpy(), want_logp, rtol=0,
                               atol=1e-12)


def test_gumbel_uniforms_follow_jax_range():
    """The main path's noise: float32 in [tiny, 1), reproducible from the
    generator's seed."""
    gen = torch.Generator().manual_seed(0)
    u = gumbel_uniforms((64, 17), gen)
    again = gumbel_uniforms((64, 17), torch.Generator().manual_seed(0))
    assert u.dtype == torch.float32 and torch.equal(u, again)
    assert float(u.min()) >= FLOAT32_TINY and float(u.max()) < 1.0


def test_wrapper_checks_inputs():
    logits = torch.zeros(2, 17)
    mask = torch.ones(2, 17, dtype=torch.int32)
    with pytest.raises(ValueError, match="CPU or all on"):
        mask_sample_logp(logits, mask, torch.zeros(2, 17, device="meta"))
