"""The plain versions of K17-K20 (the heads, the optimiser, the minibatch
assembly) and of the repaired K15 (the ES rank weights) against the JAX
package, on the CPU, where the wrappers take their plain versions.

Inputs come from numpy seeds or the committed training fixture.
Tolerances, each with its reason:
* the heads (K17) against flax's ``MLPHead`` at float32: 1e-6 of each
  output's largest magnitude (XLA's and PyTorch's float32 matrix products
  sum in other orders), the backward (K18's plain version, autograd)
  against ``jax.grad`` the same;
* the optimiser (K19's plain version) against ``optax.chain(
  clip_by_global_norm, adam | rmsprop)`` under x64: 1e-9 after every one
  of four steps, the clip firing and not, adam and rmsprop with and
  without momentum;
* the minibatch assembly (K20's plain version, and the DQN batch it now
  builds): every array equal to ``prepare_flat_batch`` of the same
  samples, exactly;
* the ES rank weights and float32 gradient (K15's plain version) equal to
  the jitted reference's, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddls_tpu.models.policy import MLPHead as JaxMLPHead
from ddls_tpu.parallel.mesh import make_mesh
from ddls_tpu.rl import es as jes
from ddls_tpu_torch.models import policy as tpolicy
from ddls_tpu_torch.rl import es as tes
from ddls_tpu_torch.rl import learner as tlearner
from ddls_tpu_torch.rl.fixture import load_train_fixture

torch.set_num_threads(1)

HEADS = [((17,), 17), ((256,), 17), ((256, 256), 17), ((), 17)]


def _flax_heads(hiddens, n_actions, seed):
    x = np.random.default_rng(seed).normal(0, 1, (37, 24)).astype(
        np.float32)
    heads = [JaxMLPHead(tuple(hiddens), n_actions),
             JaxMLPHead(tuple(hiddens), 1)]
    params = [h.init(jax.random.PRNGKey(seed + i), jnp.asarray(x))
              for i, h in enumerate(heads)]
    return x, heads, params


def _torch_layers(params):
    """flax Dense params ({kernel [in, out], bias}) as nn.Linear's
    (weight [out, in], bias)."""
    dense = params["params"]
    return [(torch.from_numpy(np.asarray(dense[f"Dense_{i}"]["kernel"]).T
                              .copy()),
             torch.from_numpy(np.asarray(dense[f"Dense_{i}"]["bias"])))
            for i in range(len(dense))]


def _close(got, want, tol):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(scale, 1e-30))


@pytest.mark.parametrize("hiddens,n_actions", HEADS)
def test_heads_plain_match_flax_mlp_head_f32(hiddens, n_actions):
    """K17's plain version against flax's ``MLPHead`` (both heads), and
    K18's against ``jax.grad`` of the same, at float32 within 1e-6."""
    x, heads, params = _flax_heads(hiddens, n_actions, 3)
    logit_layers, value_layers = (_torch_layers(p) for p in params)
    logits, values = tpolicy.mlp_heads(torch.from_numpy(x), logit_layers,
                                       value_layers, "relu")
    _close(logits.numpy(), heads[0].apply(params[0], jnp.asarray(x)), 1e-6)
    _close(values.numpy(), heads[1].apply(params[1], jnp.asarray(x))[:, 0],
           1e-6)

    rng = np.random.default_rng(4)
    dlogits = rng.normal(0, 1, (37, n_actions)).astype(np.float32)
    dvalue = rng.normal(0, 1, 37).astype(np.float32)

    def objective(p0, p1, xx):
        return (jnp.sum(heads[0].apply(p0, xx) * dlogits)
                + jnp.sum(heads[1].apply(p1, xx)[:, 0] * dvalue))

    g0, g1, gx = jax.grad(objective, argnums=(0, 1, 2))(
        params[0], params[1], jnp.asarray(x))
    dx, grads = tpolicy.mlp_heads_bwd(
        torch.from_numpy(x), logit_layers, value_layers, "relu",
        torch.from_numpy(dlogits), torch.from_numpy(dvalue))
    _close(dx.numpy(), gx, 1e-6)
    want = []
    for g in (g0, g1):
        for i in range(len(g["params"])):
            dense = g["params"][f"Dense_{i}"]
            want += [np.asarray(dense["kernel"]).T, dense["bias"]]
    assert len(grads) == len(want)
    for got, ref in zip(grads, want):
        _close(got.numpy(), ref, 1e-6)


def test_policy_heads_run_through_mlp_heads():
    """``GNNPolicy.trunk``'s heads are ``mlp_heads`` over the modules' own
    tensors, equal to each ``MLPHead.forward`` (the plain stack)."""
    model = tpolicy.GNNPolicy(n_actions=5, graph_feature_dim=7,
                              out_features_msg=4, out_features_hidden=8,
                              out_features_node=4, out_features_graph=4,
                              fcnet_hiddens=(6,))
    x = torch.randn(9, 8, generator=torch.Generator().manual_seed(0))
    logits, values = tpolicy.mlp_heads(
        x, tpolicy.head_layers(model.logit_head),
        tpolicy.head_layers(model.value_head), "relu")
    assert torch.equal(logits, model.logit_head(x))
    assert torch.equal(values, model.value_head(x)[:, 0])


# ------------------------------------------------------- K19's plain
@pytest.mark.parametrize("rule", ["adam", "rmsprop", "rmsprop_momentum"])
@pytest.mark.parametrize("clip", [None, 3.0])
def test_optimizer_plain_matches_optax_x64(rule, clip):
    """K19's plain version against optax under x64 over four steps, whose
    gradients' global norms (~1, ~60, ~0.5, ~60) straddle the clip of 3
    (or run unclipped): params and moments within 1e-9."""
    rng = np.random.default_rng(8)
    shapes = [(5, 3), (3,), (2, 7), (1,)]
    params = [rng.normal(0, 1, s) for s in shapes]
    steps = [[rng.normal(0, scale, s) for s in shapes]
             for scale in (0.2, 12.0, 0.1, 12.0)]
    lr, b1, b2, eps = 1e-3, 0.9, 0.999, 1e-8
    decay, momentum, rms_eps = 0.99, 0.5, 0.1
    with jax.enable_x64(True):
        if rule == "adam":
            inner = optax.adam(lr, b1=b1, b2=b2, eps=eps)
        else:
            inner = optax.rmsprop(lr, decay=decay, eps=rms_eps,
                                  momentum=(momentum if rule ==
                                            "rmsprop_momentum" else None))
        tx = (inner if clip is None else
              optax.chain(optax.clip_by_global_norm(clip), inner))
        j_params = [jnp.asarray(p) for p in params]
        opt_state = tx.init(j_params)
        for g in steps:
            updates, opt_state = tx.update([jnp.asarray(x) for x in g],
                                           opt_state, j_params)
            j_params = optax.apply_updates(j_params, updates)
        j_params = [np.asarray(p) for p in j_params]
    t_params = [torch.from_numpy(p.copy()) for p in params]
    mu = (None if rule == "rmsprop"
          else [torch.zeros_like(p) for p in t_params])
    nu = [torch.zeros_like(p) for p in t_params]
    for count, g in enumerate(steps, start=1):
        if rule == "adam":
            hp = tlearner.OptimizerStep("adam", lr, clip, b1, b2, eps,
                                        1 - b1 ** count, 1 - b2 ** count)
        else:
            hp = tlearner.OptimizerStep(rule, lr, clip, momentum, decay,
                                        rms_eps)
        tlearner.clip_adam_plain(t_params, [torch.from_numpy(x) for x in g],
                                 mu, nu, hp)
    for got, want in zip(t_params, j_params):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


def test_clip_adam_on_the_cpu_is_the_plain_version():
    """``clip_adam`` on CPU tensors is ``clip_adam_plain``, bit for bit,
    and builds no device table."""
    rng = np.random.default_rng(9)
    params = [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
              for s in ((4, 3), (3,))]
    state = tlearner.TrainState(names=["a", "b"], params=params,
                                mu=[torch.zeros_like(p) for p in params],
                                nu=[torch.zeros_like(p) for p in params])
    ref = [p.clone() for p in params]
    grads = [torch.from_numpy(rng.normal(0, 9, p.shape).astype(np.float32))
             for p in params]
    hp = tlearner.OptimizerStep("adam", 1e-3, 1.0, 0.9, 0.999, 1e-8, 0.1,
                                1e-3)
    tlearner.clip_adam(state, grads, hp)
    tlearner.clip_adam_plain(ref, grads, [torch.zeros_like(p) for p in ref],
                             [torch.zeros_like(p) for p in ref], hp)
    assert all(torch.equal(a, b) for a, b in zip(state.params, ref))
    assert state.opt_table is None


# ------------------------------------------------------- K20's plain
def _fixture_rows(n=None):
    fx = load_train_fixture()
    obs = fx["traj"]["obs"]
    t_len, lanes = np.shape(obs["node_features"])[:2]
    rows = {k: np.swapaxes(np.asarray(v), 0, 1).reshape(
        (t_len * lanes,) + np.shape(v)[2:]) for k, v in obs.items()}
    return fx, rows


def test_sample_structure_equals_each_sample_alone():
    """``_sample_structure`` (one ``prepare_flat_batch`` of the batch,
    re-based per sample) equals ``prepare_flat_batch`` of every sample
    alone, row for row."""
    _, rows = _fixture_rows()
    idx = np.random.default_rng(1).permutation(len(rows["node_split"]))[:40]
    sel = {k: v[idx] for k, v in rows.items()}
    structure, node_mask = tlearner._sample_structure(sel)
    for i in range(len(idx)):
        host = tpolicy.prepare_flat_batch({k: v[i:i + 1]
                                           for k, v in sel.items()})
        want = np.concatenate([host["src"], host["edge_dst"],
                               host["csr_row_ptr"], host["csr_col"],
                               host["src_csr_row_ptr"],
                               host["src_csr_col"]])
        np.testing.assert_array_equal(structure[i], want)
        np.testing.assert_array_equal(node_mask[i], host["node_mask"])


def test_minibatch_plain_equals_prepare_flat_batch():
    """K20's plain version on the staged fixture: a shuffled minibatch, one
    with repeated samples, one sample and the full batch, each array equal
    to ``prepare_flat_batch`` of the same samples (at the staged bucket)."""
    from ddls_tpu_torch.rl.ppo import PPOLearner
    from ddls_tpu_torch.serve import load_export
    from ddls_tpu_torch.serve.fixture import EXPORT_PATH

    fx, rows = _fixture_rows()
    model, _, _ = load_export(EXPORT_PATH)
    learner = PPOLearner(model, fx["cfg"], device="cpu")
    staged = learner.stage_traj(fx["traj"], fx["last_values"])
    n = staged.t_len * staged.lanes
    rng = np.random.default_rng(2)
    for idx in (rng.permutation(n)[:128], rng.integers(0, n, 64),
                np.array([5]), np.arange(n)):
        got = tlearner.minibatch_gather(
            staged.tensors, torch.from_numpy(idx.astype(np.int64)),
            staged.n_nodes, staged.n_edges)
        sel = {k: v[idx] for k, v in rows.items()}
        sel["node_features"] = sel["node_features"][:, :staged.n_nodes]
        for key in ("edge_features", "edges_src", "edges_dst"):
            sel[key] = sel[key][:, :staged.n_edges]
        want = tpolicy.prepare_flat_batch(sel)
        assert set(got) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key].numpy(), value,
                                          err_msg=key)


def test_dqn_batch_halves_equal_prepare_flat_batch():
    """The DQN update's two halves, now staged per sample and gathered by
    K20, equal ``host_batch`` (``prepare_flat_batch`` at each half's
    bucket) array for array."""
    from ddls_tpu_torch.rl import dqn as tdqn

    _, rows = _fixture_rows()
    model = tpolicy.GNNPolicy(n_actions=rows["action_mask"].shape[1],
                              graph_feature_dim=rows["graph_features"]
                              .shape[1], fcnet_hiddens=(16,),
                              apply_action_mask=False)
    learner = tdqn.ApexDQNLearner(model, tdqn.DQNConfig(), device="cpu")
    rng = np.random.default_rng(3)
    a, b = rng.integers(0, len(rows["node_split"]), (2, 48))
    batch = {"obs": {k: v[a] for k, v in rows.items()},
             "next_obs": {k: v[b] for k, v in rows.items()},
             "actions": np.zeros(48, np.int32),
             "rewards": np.zeros(48, np.float32),
             "discounts": np.ones(48, np.float32),
             "weights": np.ones(48, np.float32)}
    staged = learner.stage_batch(batch)
    for half in ("obs", "next_obs"):
        want = learner.host_batch(batch[half], grad=True)
        assert set(staged[half]) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(staged[half][key].numpy(), value,
                                          err_msg=f"{half}/{key}")


# ------------------------------------------------ K15: the rank weights
def _fitness_cases(p, seed):
    rng = np.random.default_rng(seed)
    cases = [rng.integers(0, 4, p).astype(np.float32) for _ in range(6)]
    cases += [rng.normal(0, 1, p).astype(np.float32)]
    nan = rng.integers(0, 3, p).astype(np.float32)
    nan[p // 2] = np.nan
    cases += [nan, np.full(p, 2.5, np.float32)]
    return cases


@pytest.mark.parametrize("p", [2, 4, 10, 32, 64])
def test_rank_weights_equal_the_jitted_reference(p):
    """The learner's rank weights (K15's plain version) equal the
    reference's jitted ``centered_ranks`` bit for bit (a fused multiply-add
    with the float32 reciprocal), where the eager one divides;
    ``centered_ranks`` keeps the eager arithmetic."""
    jitted = jax.jit(jes.centered_ranks)
    for fit in _fitness_cases(p, p):
        want = np.asarray(jitted(jnp.asarray(fit)))
        got = tes.rank_weights(torch.from_numpy(fit)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tes.centered_ranks(torch.from_numpy(fit)).numpy(),
            np.asarray(jes.centered_ranks(jnp.asarray(fit))))


def test_es_gradient_f32_bit_equals_the_jitted_reference():
    """K15's plain float32 gradient equals the reference's jitted
    ``_update``'s (recorded through a pass-through transformation), bit
    for bit, at P = 10 on fitness with ties and all-equal members."""
    cfg = jes.ESConfig()
    learner = jes.ESLearner(None, cfg, make_mesh(1), population=10)
    learner.tx = optax.chain(optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u)), optax.adam(cfg.stepsize))
    rng = np.random.default_rng(11)
    for fit in _fitness_cases(10, 12):
        theta = rng.normal(0, 1, 96).astype(np.float32)
        eps = rng.normal(0, 1, (5, 96)).astype(np.float32)
        state = learner.init_state({"a": jnp.asarray(theta)})
        state, _ = learner.update(state, {"a": jnp.asarray(eps)}, fit)
        want = np.asarray(state.opt_state[0]["a"])
        got, _, _ = tes.es_update_plain(
            torch.from_numpy(fit), torch.from_numpy(eps),
            torch.from_numpy(theta), cfg.noise_stdev, cfg.l2_coeff)
        np.testing.assert_array_equal(got.numpy(), want)
