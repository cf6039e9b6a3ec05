"""The port's GNN policy (ddls_tpu_torch/models) against the flax one
(ddls_tpu/models), on the CPU.

Parameters are flax-initialised from a fixed key and carried across by
``params_from_flax``; inputs are made from numpy seeds. Outputs agree at
atol 1e-5 (f32, sums in another order). Masked logits are compared
exactly: both sides compute ``logit + finfo(float32).min``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as nn

from ddls_tpu.models import gnn as jgnn
from ddls_tpu.models import policy as jpolicy
from ddls_tpu_torch.models import convert, gnn as tgnn, policy as tpolicy
from ddls_tpu_torch.ops import segment as tseg
from ddls_tpu_torch.ops.segment import build_csr

ATOL = 1e-5
F32_MIN = np.finfo(np.float32).min


def _state(flax_params, model):
    return convert.params_from_flax(
        convert.flatten_tree({"params": flax_params["params"]}), model)


def _port(model, flax_params):
    model.load_state_dict(_state(flax_params, model))
    return model.eval()


class _FlaxFeature(nn.Module):
    """A bare flax FeatureModule under a fixed name, so its tree maps onto
    a port FeatureModule's state dict."""
    features: int
    depth: int
    activation: str

    @nn.compact
    def __call__(self, x):
        return jgnn.FeatureModule(self.features, self.depth,
                                  self.activation, name="m")(x)


def _feature_pair(k_in, features, depth, activation, seed=0):
    fm = _FlaxFeature(features, depth, activation)
    params = fm.init(jax.random.PRNGKey(seed), jnp.zeros((1, k_in)))
    port = tgnn.FeatureModule(k_in, features, depth, activation)
    flat = {k.replace("params/m/", "params/"): v for k, v in
            convert.flatten_tree({"params": params["params"]}).items()}
    port.load_state_dict(convert.params_from_flax(flat, port))
    return fm, params, port


@pytest.mark.parametrize("k_in", [5, 16])
def test_feature_module_fast_variance_at_large_mean(k_in):
    """Integer inputs offset by 1e3: every sum is exact in f32 whatever the
    order, so the port must reproduce flax's LayerNorm formula itself —
    E[x^2] - E[x]^2 with means as sum * (1/K) and epsilon 1e-6. The
    two-pass variance (torch's layer_norm) lands far off on these
    inputs, which the last assert shows."""
    rng = np.random.default_rng(k_in)
    x = (1e3 + rng.integers(0, 4, (64, k_in))).astype(np.float32)
    fm, params, port = _feature_pair(k_in, 8, 1, "relu")
    ref = np.asarray(fm.apply(params, jnp.asarray(x)))
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    t = torch.from_numpy(x)
    two_pass = torch.relu(torch.nn.functional.linear(
        torch.nn.functional.layer_norm(t, (k_in,), port.LayerNorm_0.weight,
                                       port.LayerNorm_0.bias, eps=1e-6),
        port.Dense_0.weight, port.Dense_0.bias)).detach().numpy()
    assert np.abs(two_pass - ref).max() > 1e-3


@pytest.mark.parametrize("activation", sorted(tgnn.ACTIVATIONS))
@pytest.mark.parametrize("k_in,depth", [(2, 1), (32, 2), (51, 1), (64, 1)])
def test_feature_module_matches_flax(activation, k_in, depth):
    rng = np.random.default_rng(k_in + depth)
    x = rng.normal(0.5, 2.0, (40, k_in)).astype(np.float32)
    fm, params, port = _feature_pair(k_in, 16, depth, activation, seed=3)
    ref = np.asarray(fm.apply(params, jnp.asarray(x)))
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_feature_module_fused_gather_and_concat():
    """K1's load: rows concat(a[idx], b) and concat(a, zeros) through one
    module equal the flax module on the materialised concat."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, (7, 6)).astype(np.float32)
    b = rng.uniform(0, 1, (11, 6)).astype(np.float32)
    idx = rng.integers(0, 7, 11).astype(np.int32)
    fm, params, port = _feature_pair(12, 10, 1, "relu", seed=4)
    ref_msg = fm.apply(params, jnp.concatenate([a[idx], b], axis=1))
    ref_self = fm.apply(params, jnp.concatenate([a, np.zeros_like(a)], 1))
    t = torch.from_numpy
    got_msg = port(t(a), idx=t(idx), b=t(b))
    got_self = port(t(a), b_width=6)
    np.testing.assert_allclose(got_msg.detach().numpy(),
                               np.asarray(ref_msg), atol=ATOL)
    np.testing.assert_allclose(got_self.detach().numpy(),
                               np.asarray(ref_self), atol=ATOL)


def _graph_inputs(rng, n, e, n_real, e_real):
    node = np.zeros((n, 5), np.float32)
    node[:n_real] = rng.uniform(0, 1, (n_real, 5))
    edge = np.zeros((e, 2), np.float32)
    edge[:e_real] = rng.uniform(0, 1, (e_real, 2))
    src = np.zeros(e, np.int32)
    dst = np.zeros(e, np.int32)
    src[:e_real] = rng.integers(0, n_real, e_real)
    dst[:e_real] = rng.integers(0, n_real, e_real)
    return node, edge, src, dst, np.arange(n) < n_real, np.arange(e) < e_real


def _port_graph_args(node, edge, src, dst, node_mask, edge_mask):
    row_ptr, col = build_csr(dst, edge_mask, node.shape[0])
    t = torch.from_numpy
    return (t(node), t(edge), t(np.where(edge_mask, src, 0).astype(np.int32)),
            t(node_mask.astype(np.float32)), t(row_ptr), t(col))


def test_mean_pool_layer_matches_flax():
    rng = np.random.default_rng(11)
    inputs = _graph_inputs(rng, 14, 24, 11, 17)
    layer = jgnn.MeanPoolLayer(8, 12)
    params = layer.init(jax.random.PRNGKey(1), *map(jnp.asarray, inputs))
    ref = layer.apply(params, *map(jnp.asarray, inputs))
    port = tgnn.MeanPoolLayer(5, 2, 8, 12)
    port.load_state_dict(_state(params, port))
    got = port(*_port_graph_args(*inputs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL)


@pytest.mark.parametrize("num_rounds,depth", [(2, 1), (3, 2)])
def test_gnn_matches_flax(num_rounds, depth):
    rng = np.random.default_rng(num_rounds)
    inputs = _graph_inputs(rng, 16, 30, 13, 22)
    net = jgnn.GNN(8, 12, 6, num_rounds, depth)
    params = net.init(jax.random.PRNGKey(2), *map(jnp.asarray, inputs))
    ref = net.apply(params, *map(jnp.asarray, inputs))
    port = tgnn.GNN(5, 2, 8, 12, 6, num_rounds, depth)
    port.load_state_dict(_state(params, port))
    got = port(*_port_graph_args(*inputs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL)


N_ACTIONS = 9
ARCH = dict(out_features_msg=8, out_features_hidden=12, out_features_node=6,
            out_features_graph=4, fcnet_hiddens=(10, 7))


def _obs(rng, n, e, n_real, e_real, mask_valid=(0, 1, 2, 4, 8)):
    node, edge, src, dst, _, _ = _graph_inputs(rng, n, e, n_real, e_real)
    mask = np.zeros(N_ACTIONS, np.int32)
    mask[list(mask_valid)] = 1
    return {"node_features": node, "edge_features": edge,
            "graph_features": rng.uniform(0, 1, 17 + N_ACTIONS).astype(
                np.float32),
            "edges_src": src, "edges_dst": dst,
            "node_split": np.array([n_real], np.int32),
            "edge_split": np.array([e_real], np.int32),
            "action_set": np.arange(N_ACTIONS, dtype=np.int32),
            "action_mask": mask}


def _policy_pair(apply_action_mask=True):
    rng = np.random.default_rng(21)
    jm = jpolicy.GNNPolicy(n_actions=N_ACTIONS,
                           apply_action_mask=apply_action_mask, **ARCH)
    params = jm.init(jax.random.PRNGKey(3), _obs(rng, 12, 20, 8, 10))
    port = _port(tpolicy.GNNPolicy(N_ACTIONS, 17 + N_ACTIONS,
                                   apply_action_mask=apply_action_mask,
                                   **ARCH), params)
    return jm, params, port


def _assert_logits(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    masked = ref == F32_MIN
    np.testing.assert_array_equal(got == F32_MIN, masked)
    np.testing.assert_array_equal(got[masked], ref[masked])
    np.testing.assert_allclose(got[~masked], ref[~masked], atol=ATOL)


@pytest.mark.parametrize("apply_action_mask", [True, False])
def test_policy_single_forward_matches_flax(apply_action_mask):
    jm, params, port = _policy_pair(apply_action_mask)
    rng = np.random.default_rng(31)
    for n_real, e_real in [(8, 10), (12, 20), (1, 0)]:
        obs = _obs(rng, 12, 20, n_real, e_real)
        lo_ref, va_ref = jm.apply(params, obs)
        with torch.no_grad():
            lo, va = port(obs)
        _assert_logits(lo.detach().numpy(), lo_ref)
        np.testing.assert_allclose(va.item(), float(va_ref), atol=ATOL)


def test_policy_flat_batched_matches_flax():
    """B observations (one with zero real nodes, one fully masked action
    row) as one flattened graph: masked logits, values and the greedy
    action (K4's argmax) against batched_policy_apply + np.argmax."""
    jm, params, port = _policy_pair()
    rng = np.random.default_rng(41)
    obs = [_obs(rng, 12, 20, int(rng.integers(1, 13)),
                int(rng.integers(0, 21)) if i else 0) for i in range(5)]
    obs[2] = _obs(rng, 12, 20, 0, 0)
    obs[3] = _obs(rng, 12, 20, 6, 9, mask_valid=())
    for o in obs:  # edges only among real nodes
        n = int(o["node_split"][0])
        m = int(o["edge_split"][0]) if n else 0
        o["edge_split"][0] = m
    stacked = {k: np.stack([o[k] for o in obs]) for k in obs[0]}
    lo_ref, va_ref = jpolicy.batched_policy_apply(jm, params, stacked)
    batch = tpolicy.batch_to_device(tpolicy.prepare_flat_batch(stacked),
                                    torch.device("cpu"))
    lo, va, actions = port.flat_batched(batch)
    _assert_logits(lo.detach().numpy(), lo_ref)
    np.testing.assert_allclose(va.detach().numpy(), np.asarray(va_ref),
                               atol=ATOL)
    np.testing.assert_array_equal(actions.numpy(),
                                  np.argmax(np.asarray(lo_ref), axis=1))


def test_mask_logits_argmax_matches_reference_and_breaks_ties_low():
    jm = jpolicy.GNNPolicy(n_actions=5)
    logits = np.array([[1.0, 3.0, 3.0, 0.5, 3.0],
                       [2.0, -1.0, 7.0, 7.0, 0.0],
                       [0.2, 0.9, 0.4, 0.9, 0.1],
                       [-5.0, -4.0, -3.0, -3.0, -9.0]], np.float32)
    mask = np.array([[1, 1, 1, 0, 1],
                     [0, 1, 0, 0, 1],
                     [0, 0, 0, 0, 0],   # fully masked: all finfo.min
                     [1, 1, 1, 1, 1]], np.int32)
    ref = np.asarray(jm._mask_logits(jnp.asarray(logits),
                                     jnp.asarray(mask)))
    masked, actions = tpolicy.mask_logits_argmax(torch.from_numpy(logits),
                                                 torch.from_numpy(mask))
    np.testing.assert_array_equal(masked.numpy(), ref)
    np.testing.assert_array_equal(actions.numpy(), np.argmax(ref, axis=1))
    np.testing.assert_array_equal(actions.numpy(), [1, 4, 0, 2])
    assert actions.dtype == torch.int64


def test_params_from_flax_rejects_missing_extra_and_misshapen_leaves():
    _, params, port = _policy_pair()
    flat = convert.flatten_tree({"params": params["params"]})
    state = convert.params_from_flax(flat, port)
    assert set(state) == set(port.state_dict())
    kernel = "params/gnn/round_0/node_module/Dense_0/kernel"
    np.testing.assert_array_equal(
        state["gnn.round_0.node_module.Dense_0.weight"].numpy(),
        np.asarray(flat[kernel]).T)
    missing = {k: v for k, v in flat.items() if k != kernel}
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_flax(missing, port)
    extra = dict(flat, **{"params/logit_head/Dense_9/kernel":
                          np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="no place"):
        convert.params_from_flax(extra, port)
    bad = dict(flat, **{kernel: np.zeros((4, 4), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_flax(bad, port)
    assert convert.checkpoint_graph_feature_dim(flat) == 17 + N_ACTIONS
    assert convert.checkpoint_graph_feature_dim({}) is None


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="unrecognised activation"):
        tgnn.FeatureModule(4, 4, activation="softsign")


# ------------------------------------------------------------- gradients
@pytest.mark.parametrize("activation", sorted(tgnn.ACTIVATIONS))
@pytest.mark.parametrize("form", ["rows", "gather_concat", "zero_half"])
def test_ln_linear_act_bwd_plain_is_the_autograd_of_the_forward(activation,
                                                                form):
    """K5's plain version (the kernel's explicit backward formulas) equals
    torch autograd of K1's plain forward, in float64 (atol 1e-10: the same
    derivative, sums reordered), including a row whose variance clamps
    at exactly 0 (all features equal), where both pass half the gradient."""
    rng = np.random.default_rng(len(activation) + len(form))
    t = torch.from_numpy
    rows, fa, fb, fo = 23, 5, 3, 7  # K = 8: the tie rows' sums are exact
    kwargs = {}
    if form == "gather_concat":
        a = t(rng.normal(0, 1, (9, fa)))
        a[3] = 0.75  # gathered and concatenated with b below: see b[4]
        idx = rng.integers(0, 9, rows).astype(np.int32)
        idx[4] = 3
        b = rng.normal(0, 1, (rows, fb))
        b[4] = 0.75
        kwargs = dict(idx=t(idx), b=t(b).requires_grad_(True))
        tie = 4
    elif form == "zero_half":
        a = t(rng.normal(0, 1, (rows, fa)))
        a[2] = 0.0  # concat(0, zeros): variance exactly 0
        kwargs = dict(b_width=fb)
        tie = 2
    else:
        a = t(rng.normal(0, 1, (rows, fa + fb)))
        a[5] = 1.5
        tie = 5
    a.requires_grad_(True)
    k_in = fa + fb
    params = [t(rng.normal(1, 0.3, k_in)), t(rng.normal(0, 0.3, k_in)),
              t(rng.normal(0, 0.5, (fo, k_in))), t(rng.normal(0, 0.5, fo))]
    for p in params:
        p.requires_grad_(True)
    dout = t(rng.normal(0, 1, (rows, fo)))
    x = tgnn._row_input(a.detach(), kwargs.get("idx"),
                        kwargs["b"].detach() if "b" in kwargs else None,
                        kwargs.get("b_width", 0))
    raw = tgnn._ln_dense(x, *(p.detach() for p in params))[3]
    assert float(raw[tie]) == 0.0 and bool((raw != 0).sum() == rows - 1)
    out = tgnn.ln_linear_act(a, *params, activation, **kwargs)
    wrt = [a, *params] + ([kwargs["b"]] if "b" in kwargs else [])
    ref = torch.autograd.grad(out, wrt, dout)
    dx, db, dw, dbias, dlnw, dlnb = tgnn.ln_linear_act_bwd(
        a.detach(), *(p.detach() for p in params), activation, dout,
        **{k: (v.detach() if torch.is_tensor(v) else v)
           for k, v in kwargs.items()})
    if "idx" in kwargs:
        row_ptr, col = build_csr(kwargs["idx"].numpy(), np.ones(rows, bool),
                                 a.shape[0])
        dx = tseg.csr_segment_sum(dx, t(row_ptr), t(col))
    got = [dx, dlnw, dlnb, dw, dbias] + ([db] if "b" in kwargs else [])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-10)


@pytest.mark.parametrize("activation", ["relu", "leaky_relu"])
def test_ln_linear_act_bwd_plain_takes_the_kink_side_from_the_output(
        activation):
    """Given the forward's output, the plain backward reads each relu /
    leaky_relu derivative decision from it: with its own forward's output
    it gives the same bits as without, and a pre-activation put on the
    other side of the kink (as another summation order can put one that
    sits a rounding away from 0) moves only that entry's gradient, by
    d out x (the derivative's jump) (float64, exact and 1e-12)."""
    rng = np.random.default_rng(7)
    t = torch.from_numpy
    rows, k_in, fo = 17, 6, 5
    a = t(rng.normal(0, 1, (rows, k_in)))
    params = [t(rng.normal(1, 0.3, k_in)), t(rng.normal(0, 0.3, k_in)),
              t(rng.normal(0, 0.5, (fo, k_in))), t(rng.normal(0, 0.5, fo))]
    dout = t(rng.normal(0, 1, (rows, fo)))
    out = tgnn.ln_linear_act_plain(a, *params, activation)
    ref = tgnn.ln_linear_act_bwd_plain(a, *params, activation, dout)
    same = tgnn.ln_linear_act_bwd_plain(a, *params, activation, dout,
                                        out=out)
    for g, r in zip(same, ref):
        assert (g is None and r is None) or torch.equal(g, r)
    r, o = 3, 2
    slope = 0.0 if activation == "relu" else 0.01
    positive = bool(out[r, o] > 0)
    flipped = out.clone()
    flipped[r, o] = -0.5 if positive else 0.5
    moved = tgnn.ln_linear_act_bwd_plain(a, *params, activation, dout,
                                         out=flipped)
    jump = (slope - 1.0) if positive else (1.0 - slope)
    dbias, dbias_ref = moved[3], ref[3]
    np.testing.assert_allclose(float(dbias[o] - dbias_ref[o]),
                               float(dout[r, o]) * jump, atol=1e-12)
    keep = [i for i in range(fo) if i != o]
    assert torch.equal(dbias[keep], dbias_ref[keep])


def _grad_obs(rng, n_pad=12, e_pad=20):
    """A batch with real padding, one sample's node features at an integer
    1e3 offset (the LayerNorm's fast variance is exact there and far off
    the two-pass one), and rows whose variance clamps at exactly 0: equal
    node features, equal edge features, an all-zero graph vector."""
    obs = [_obs(rng, n_pad, e_pad, int(rng.integers(3, n_pad + 1)),
                int(rng.integers(1, e_pad + 1))) for _ in range(4)]
    for o in obs:
        n = int(o["node_split"][0])
        m = int(o["edge_split"][0])
        o["edges_src"][:m] %= n
        o["edges_dst"][:m] %= n
    obs[1]["node_features"][:] = (1e3 + rng.integers(
        0, 4, obs[1]["node_features"].shape)).astype(np.float32)
    obs[0]["node_features"][1] = 0.5
    obs[2]["edge_features"][0] = 0.25
    obs[3]["graph_features"][:] = 0.0
    return {k: np.stack([o[k] for o in obs]) for k in obs[0]}


def test_policy_param_grads_match_jax_grad():
    """d (a fixed linear function of logits and values) / d params through
    the port's plain path equals jax.grad through batched_policy_apply,
    leaf for leaf. float32: atol 1e-4 of each leaf's largest gradient
    (XLA sums the Dense and segment reductions in another order, and the
    1e3-offset rows magnify one rounding step by their 1/std)."""
    jm, params, port = _policy_pair()
    stacked = _grad_obs(np.random.default_rng(51))
    rng = np.random.default_rng(52)
    w_logits = rng.normal(0, 1, (4, N_ACTIONS)).astype(np.float32)
    w_values = rng.normal(0, 1, 4).astype(np.float32)
    valid = stacked["action_mask"] > 0

    def jax_scalar(p):
        lo, va = jpolicy.batched_policy_apply(jm, p, stacked)
        return (jnp.sum(jnp.where(valid, lo, 0.0) * w_logits)
                + jnp.sum(va * w_values))

    ref = convert.flatten_tree({"params": jax.grad(jax_scalar)(params)[
        "params"]})
    batch = tpolicy.batch_to_device(tpolicy.prepare_flat_batch(stacked),
                                    torch.device("cpu"))
    lo, va, _ = port.flat_batched(batch)
    scalar = (torch.sum(torch.where(torch.from_numpy(valid), lo,
                                    torch.zeros(())) * torch.from_numpy(
                                        w_logits))
              + torch.sum(va * torch.from_numpy(w_values)))
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(scalar, [p for _, p in
                                         port.named_parameters()])
    got = convert.params_to_flax(dict(zip(names, grads)))
    assert sorted(got) == sorted(ref)
    for key, value in got.items():
        r = np.asarray(ref[key])
        scale = max(float(np.abs(r).max()), 1e-3)
        np.testing.assert_allclose(value, r, rtol=0, atol=1e-4 * scale,
                                   err_msg=key)


def test_params_to_flax_inverts_params_from_flax():
    _, params, port = _policy_pair()
    flat = convert.flatten_tree({"params": params["params"]})
    back = convert.params_to_flax(convert.params_from_flax(flat, port))
    assert sorted(back) == sorted(flat)
    for key, value in back.items():
        np.testing.assert_array_equal(value, np.asarray(flat[key]))
        assert value.dtype == np.float32


def test_prepare_flat_batch_keeps_the_float_type_and_gives_grad_inputs():
    rng = np.random.default_rng(61)
    stacked = _grad_obs(rng)
    host = tpolicy.prepare_flat_batch(stacked)
    assert host["node_features"].dtype == np.float32
    wide = dict(stacked, node_features=stacked["node_features"].astype(
        np.float64))
    host64 = tpolicy.prepare_flat_batch(wide)
    for key in ("node_features", "edge_features", "graph_features",
                "node_mask"):
        assert host64[key].dtype == np.float64, key
    n = stacked["node_features"].shape[1]
    e = stacked["edges_src"].shape[1]
    mask = (np.arange(e) < stacked["edge_split"][:, :1]).reshape(-1)
    offsets = np.repeat(np.arange(4) * n, e)
    np.testing.assert_array_equal(
        host["edge_dst"], np.where(mask, stacked["edges_dst"].reshape(-1)
                                   + offsets, -1))
    row_ptr, col = build_csr(host["src"], mask, 4 * n)
    np.testing.assert_array_equal(host["src_csr_row_ptr"], row_ptr)
    np.testing.assert_array_equal(host["src_csr_col"], col)
