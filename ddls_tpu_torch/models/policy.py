"""GNN actor-critic in PyTorch: per-node embeddings -> pooled graph
embedding -> masked action logits + value.

Counterpart of ``ddls_tpu/models/policy.py``. A batch runs as one
flattened mega-graph of B*N nodes and B*E edges, as ``flat_batched`` does
there; the host assembles it (``flat_graph_inputs``: per-sample offsets,
the node mask and the destination-sorted CSR) so the device runs only the
forward. The readout is kernel K3 (pooling + concat), the two MLP heads
are kernel K17 (``mlp_heads``: both heads, every layer, one launch; its
backward K18), and kernel K4 (``mask_logits_argmax``) masks the logits and
picks the greedy action in one launch; rollouts take kernel K9 (``mask_sample_logp``) in its place,
which masks, samples by Gumbel-max from handed-in uniforms and gives the
log-probability. Training differentiates through the mask: ``logits +
max(log mask, finfo.min)`` has derivative 1 with respect to the logits, so
on the card K4's autograd wrapper passes the gradient through unchanged.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddls_tpu_torch import kernels
from ddls_tpu_torch.envs.obs import EDGE_FEATURE_DIM, NODE_FEATURE_DIM
from ddls_tpu_torch.models.gnn import (_ACTIVATION_CODES, GNN, FeatureModule,
                                       get_activation)
from ddls_tpu_torch.ops.segment import build_csr, masked_mean_pool_concat

FLOAT32_MIN = float(np.finfo(np.float32).min)


# ------------------------------------------- K4: mask logits + greedy pick
def mask_logits_argmax_plain(logits: torch.Tensor, mask: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``logits + max(log(mask), finfo(float32).min)`` and its argmax per
    row (the first maximum, as ``np.argmax``)."""
    floor = torch.clamp(torch.log(mask.to(torch.float32)), min=FLOAT32_MIN)
    masked = logits + floor
    return masked, torch.argmax(masked, dim=1)


def mask_logits_argmax(logits: torch.Tensor, mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: masked logits [B, A] (float32) and greedy actions [B] (int64)
    from ``logits`` [B, A] float32 and the action ``mask`` [B, A] int32.
    A masked logit is finite (``finfo.min + logit``), as the reference's
    ``_mask_logits`` makes it; ties go to the lowest index."""
    if kernels.on_cpu(logits, mask):
        return mask_logits_argmax_plain(logits, mask)
    if kernels.needs_grad(logits):
        return _MaskLogitsArgmax.apply(logits, mask)
    return _mask_logits_argmax_cuda(logits, mask)


class _MaskLogitsArgmax(torch.autograd.Function):
    """K4 forward; the masked logits' gradient is the logits' (the mask
    term does not depend on them), the actions have none."""

    @staticmethod
    def forward(ctx, logits, mask):
        masked, actions = _mask_logits_argmax_cuda(logits, mask)
        ctx.mark_non_differentiable(actions)
        return masked, actions

    @staticmethod
    def backward(ctx, d_masked, d_actions):
        return d_masked, None


def _mask_logits_argmax_cuda(logits, mask):
    kernels.check_cuda("logits", logits, torch.float32)
    if logits.dim() != 2:
        raise ValueError(f"logits must be [B, A], got "
                         f"{tuple(logits.shape)}")
    rows, a = logits.shape
    kernels.check_cuda("mask", mask, torch.int32, (rows, a))
    masked = torch.empty_like(logits)
    actions = torch.empty(rows, dtype=torch.int64, device=logits.device)
    if rows and a:
        kernels.launch("mask_logits_argmax", logits.data_ptr(),
                       mask.data_ptr(), masked.data_ptr(),
                       actions.data_ptr(), rows, a)
    return masked, actions


# ------------------------------- K9: mask + Gumbel-max sample + log-prob
FLOAT32_TINY = float(np.finfo(np.float32).tiny)


def gumbel_uniforms(shape, generator: torch.Generator,
                    device=None) -> torch.Tensor:
    """Uniforms in ``[finfo(float32).tiny, 1)`` for K9, drawn from
    ``generator`` and moved into that range the way
    ``jax.random.uniform(minval=tiny, maxval=1)`` moves its [0, 1) draw
    (``u * (1 - tiny) + tiny``, floored at ``tiny``)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device if device is not None
                   else generator.device)
    return torch.clamp_min(u * (1.0 - FLOAT32_TINY) + FLOAT32_TINY,
                           FLOAT32_TINY)


def mask_sample_logp_plain(logits: torch.Tensor, mask: torch.Tensor,
                           u: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``m = logits + max(log(mask), finfo(float32).min)`` (float32's
    floor in every float type, as the reference's ``_mask_logits``); ``a =
    argmax(m - log(-log(u)))`` (the first maximum); ``logp =
    log_softmax(m)[a]`` as ``jax.nn.log_softmax`` computes it. Returns
    (actions [B] int32, logp [B]) in the logits' float type."""
    floor = torch.clamp(torch.log(mask.to(logits.dtype)), min=FLOAT32_MIN)
    m = logits + floor
    gumbel = -torch.log(-torch.log(u.to(logits.dtype)))
    actions = torch.argmax(m + gumbel, dim=1)
    shifted = m - m.max(dim=1, keepdim=True).values
    lse = torch.log(torch.exp(shifted).sum(dim=1))
    logp = shifted.gather(1, actions[:, None])[:, 0] - lse
    return actions.to(torch.int32), logp


def mask_sample_logp(logits: torch.Tensor, mask: torch.Tensor,
                     u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9: sampled actions [B] (int32) and their log-probabilities [B]
    (float32) from raw ``logits`` [B, A] float32, the action ``mask``
    [B, A] int32 and uniforms ``u`` [B, A] float32 in [tiny, 1) (see
    ``mask_sample_logp_plain`` for the arithmetic). A <= 32."""
    if kernels.on_cpu(logits, mask, u):
        return mask_sample_logp_plain(logits, mask, u)
    kernels.check_cuda("logits", logits, torch.float32)
    if logits.dim() != 2 or not 0 < logits.shape[1] <= 32:
        raise ValueError(f"logits must be [B, A] with 0 < A <= 32, got "
                         f"{tuple(logits.shape)}")
    rows, a = logits.shape
    kernels.check_cuda("mask", mask, torch.int32, (rows, a))
    kernels.check_cuda("u", u, torch.float32, (rows, a))
    actions = torch.empty(rows, dtype=torch.int32, device=logits.device)
    logp = torch.empty(rows, dtype=torch.float32, device=logits.device)
    if rows:
        kernels.launch("mask_sample_logp", logits.data_ptr(),
                       mask.data_ptr(), u.data_ptr(), actions.data_ptr(),
                       logp.data_ptr(), rows, a)
    return actions, logp


# -------------------------------- K17, K18: the logit and value heads
Layers = List[Tuple[torch.Tensor, torch.Tensor]]
# what K17 and K18 take: up to three layers a head, hidden widths up to
# 256, an input up to 64 wide, up to 64 actions (kernels/csrc/mlp_heads.cu)
_HEAD_MAX_LAYERS, _HEAD_MAX_HIDDEN, _HEAD_MAX_IN, _HEAD_MAX_OUT = 3, 256, 64, 64
# K18's grid: tiles of 8 rows, at most one block per SM of the H100, so the
# partial sums (and the bits of the result) depend on the row count alone
_HEAD_BWD_TILE, _HEAD_BWD_MAX_BLOCKS = 8, 132


def _mlp_stack(x: torch.Tensor, layers: Layers, activation: str
               ) -> torch.Tensor:
    """One head in plain PyTorch: ``F.linear`` then the activation on
    every layer but the last (``nn.Linear``'s arithmetic, as flax's
    ``MLPHead``)."""
    act = get_activation(activation)
    for i, (w, b) in enumerate(layers):
        x = F.linear(x, w, b)
        if i < len(layers) - 1:
            x = act(x)
    return x


def mlp_heads_plain(x: torch.Tensor, logit_layers: Layers,
                    value_layers: Layers, activation: str
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both heads in plain PyTorch; returns (logits [B, A], values
    [B])."""
    return (_mlp_stack(x, logit_layers, activation),
            _mlp_stack(x, value_layers, activation)[:, 0])


def mlp_heads_bwd_plain(x: torch.Tensor, logit_layers: Layers,
                        value_layers: Layers, activation: str,
                        dlogits: torch.Tensor, dvalue: torch.Tensor
                        ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The backward of ``mlp_heads_plain`` by autograd: (dx [B, K], the
    gradients of every weight and bias, head by head and layer by layer,
    in the order of ``logit_layers + value_layers`` flattened)."""
    leaves = [t.detach().requires_grad_() for t in
              [x] + [t for layer in logit_layers + value_layers
                     for t in layer]]
    pairs = list(zip(leaves[1::2], leaves[2::2]))
    n_logit = len(logit_layers)
    with torch.enable_grad():
        logits, values = mlp_heads_plain(leaves[0], pairs[:n_logit],
                                         pairs[n_logit:], activation)
        grads = torch.autograd.grad((logits, values), leaves,
                                    (dlogits, dvalue), allow_unused=True,
                                    materialize_grads=True)
    return grads[0], list(grads[1:])


def head_layers(head: "MLPHead") -> Layers:
    """A head's (weight [out, in], bias [out]) pairs, where its
    ``nn.Linear``s hold them (under ``functional_call``, the ones it
    substitutes)."""
    return [(getattr(head, f"Dense_{i}").weight,
             getattr(head, f"Dense_{i}").bias)
            for i in range(head.n_layers)]


def mlp_heads(x: torch.Tensor, logit_layers: Layers, value_layers: Layers,
              activation: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """K17: the logit head and the value head over ``x`` [B, K] in one
    launch -> (raw logits [B, A], values [B]); on the card differentiable
    through K18. The weights are read in ``nn.Linear``'s layout, [out, in]
    float32, where they lie (no copy). Takes up to three layers a head (at
    most two hidden, each up to 256 wide), K <= 64 and A <= 64; raises on
    anything else."""
    flat = [x] + [t for layer in logit_layers + value_layers for t in layer]
    if kernels.on_cpu(*flat):
        return mlp_heads_plain(x, logit_layers, value_layers, activation)
    if kernels.needs_grad(*flat):
        return _MLPHeads.apply(activation, len(logit_layers), *flat)
    table, _ = _heads_table(x, logit_layers, value_layers, activation)
    return _mlp_heads_cuda(x, table, logit_layers, activation)


def _heads_table(x, logit_layers, value_layers, activation):
    """Raise on what K17 and K18 cannot take; returns the host layer table
    their C entries read (per head and layer: the weight and bias
    pointers, in, out; then the two layer counts) and the parameter
    count."""
    if activation not in _ACTIVATION_CODES:
        get_activation(activation)  # raises with the known names
    kernels.check_cuda("x", x, torch.float32)
    if x.dim() != 2 or not 0 < x.shape[1] <= _HEAD_MAX_IN:
        raise ValueError(f"x must be [B, K <= {_HEAD_MAX_IN}], got "
                         f"{tuple(x.shape)}")
    table = [0] * (2 * _HEAD_MAX_LAYERS * 4 + 2)
    n_params = 0
    for h, layers in enumerate((logit_layers, value_layers)):
        if not 0 < len(layers) <= _HEAD_MAX_LAYERS:
            raise ValueError(f"the heads take 1 to {_HEAD_MAX_LAYERS} "
                             f"layers, got {len(layers)}")
        width = x.shape[1]
        for i, (w, b) in enumerate(layers):
            out = w.shape[0] if w.dim() == 2 else -1
            kernels.check_cuda(f"head {h} layer {i} weight", w,
                               torch.float32, (out, width))
            kernels.check_cuda(f"head {h} layer {i} bias", b, torch.float32,
                               (out,))
            last = i == len(layers) - 1
            limit = ((_HEAD_MAX_OUT if h == 0 else 1) if last
                     else _HEAD_MAX_HIDDEN)
            if not 0 < out <= limit:
                raise ValueError(f"head {h} layer {i} has {out} outputs; "
                                 f"the kernel takes 1 to {limit}")
            at = (h * _HEAD_MAX_LAYERS + i) * 4
            table[at:at + 4] = [w.data_ptr(), b.data_ptr(), width, out]
            n_params += out * width + out
            width = out
        table[2 * _HEAD_MAX_LAYERS * 4 + h] = len(layers)
    return (ctypes.c_int64 * len(table))(*table), n_params


def _mlp_heads_cuda(x, table, logit_layers, activation):
    rows = x.shape[0]
    logits = x.new_empty((rows, logit_layers[-1][0].shape[0]))
    values = x.new_empty(rows)
    if rows:
        kernels.launch("mlp_heads", x.data_ptr(), ctypes.addressof(table),
                       logits.data_ptr(), values.data_ptr(), rows,
                       _ACTIVATION_CODES[activation])
    return logits, values


def mlp_heads_bwd(x: torch.Tensor, logit_layers: Layers,
                  value_layers: Layers, activation: str,
                  dlogits: torch.Tensor, dvalue: torch.Tensor
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """K18 and its block-order reduce: ``mlp_heads_bwd_plain``'s result
    from float32 tensors on the card. It recomputes K17's pre-activations,
    so its activation-derivative decisions are K17's."""
    flat = [x] + [t for layer in logit_layers + value_layers for t in layer]
    if kernels.on_cpu(*flat, dlogits, dvalue):
        return mlp_heads_bwd_plain(x, logit_layers, value_layers,
                                   activation, dlogits, dvalue)
    table, n_params = _heads_table(x, logit_layers, value_layers,
                                   activation)
    rows = x.shape[0]
    kernels.check_cuda("dlogits", dlogits, torch.float32,
                       (rows, logit_layers[-1][0].shape[0]))
    kernels.check_cuda("dvalue", dvalue, torch.float32, (rows,))
    dx = x.new_empty(x.shape)
    blocks = max(1, min(-(-rows // _HEAD_BWD_TILE), _HEAD_BWD_MAX_BLOCKS))
    # no rows: zero partials, so the reduce gives zero gradients
    partial = (x.new_empty if rows else x.new_zeros)((blocks, n_params))
    if rows:
        kernels.launch("mlp_heads_bwd", x.data_ptr(),
                       ctypes.addressof(table), dlogits.data_ptr(),
                       dvalue.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                       rows, _ACTIVATION_CODES[activation], blocks)
    grads = x.new_empty(n_params)
    kernels.launch("mlp_heads_bwd_reduce", partial.data_ptr(),
                   grads.data_ptr(), blocks, n_params)
    out, at = [], 0
    for w, b in logit_layers + value_layers:
        out.append(grads[at:at + w.numel()].view(w.shape))
        at += w.numel()
        out.append(grads[at:at + b.numel()])
        at += b.numel()
    return dx, out


class _MLPHeads(torch.autograd.Function):
    """K17 forward, K18 backward (a head the loss does not reach gets a
    zero output gradient, as ``jax.grad`` gives it)."""

    @staticmethod
    def forward(ctx, activation, n_logit, x, *flat):
        pairs = list(zip(flat[0::2], flat[1::2]))
        table, _ = _heads_table(x, pairs[:n_logit], pairs[n_logit:],
                                activation)
        ctx.save_for_backward(x, *flat)
        ctx.activation, ctx.n_logit = activation, n_logit
        return _mlp_heads_cuda(x, table, pairs[:n_logit], activation)

    @staticmethod
    def backward(ctx, dlogits, dvalue):
        x, *flat = ctx.saved_tensors
        pairs = list(zip(flat[0::2], flat[1::2]))
        n_logit = ctx.n_logit
        rows = x.shape[0]
        if dlogits is None:
            dlogits = x.new_zeros((rows, pairs[n_logit - 1][0].shape[0]))
        if dvalue is None:
            dvalue = x.new_zeros(rows)
        dx, grads = mlp_heads_bwd(x, pairs[:n_logit], pairs[n_logit:],
                                  ctx.activation, dlogits.contiguous(),
                                  dvalue.contiguous())
        return (None, None, dx if ctx.needs_input_grad[2] else None,
                *grads)


# ---------------------------------------------------- host batch assembly
def flat_graph_inputs(edges_src: np.ndarray, edges_dst: np.ndarray,
                      node_split: np.ndarray, edge_split: np.ndarray,
                      max_nodes: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """The flattened mega-graph of a [B, E] edge batch, on the host:
    ``(src [B*E] int32, node_mask [B*N] float32, row_ptr [B*N+1] int32,
    col [B*E] int32)``. Sample b's node n becomes node ``b*N + n``;
    padded edges (past ``edge_split``) read node ``b*N`` and leave the
    CSR, so their contents never matter. Raises if a real edge's endpoint
    lies outside its graph's real nodes."""
    edges_src = np.asarray(edges_src)
    edges_dst = np.asarray(edges_dst)
    batch, n_edges_pad = edges_src.shape
    n_nodes = np.asarray(node_split).reshape(batch, -1)[:, 0]
    n_edges = np.asarray(edge_split).reshape(batch, -1)[:, 0]
    node_mask = np.arange(max_nodes) < n_nodes[:, None]
    edge_mask = np.arange(n_edges_pad) < n_edges[:, None]
    for key, ends in (("edges_src", edges_src), ("edges_dst", edges_dst)):
        bad = edge_mask & ((ends < 0) | (ends >= n_nodes[:, None]))
        if bad.any():
            b = int(np.flatnonzero(bad.any(axis=1))[0])
            raise ValueError(f"{key} of sample {b} points outside its "
                             f"{int(n_nodes[b])} real nodes")
    offsets = (np.arange(batch, dtype=np.int64) * max_nodes)[:, None]
    src = (np.where(edge_mask, edges_src, 0) + offsets).astype(np.int32)
    dst = np.where(edge_mask, edges_dst, 0) + offsets
    row_ptr, col = build_csr(dst.reshape(-1), edge_mask.reshape(-1),
                             batch * max_nodes)
    return (src.reshape(-1), node_mask.astype(np.float32).reshape(-1),
            row_ptr, col)


def prepare_flat_batch(obs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A stacked observation batch (the ``envs/obs.py`` keys, each [B, ...])
    -> the host arrays ``GNNPolicy.flat_batched`` takes. The float arrays
    keep the node features' float type (float32 from the env; float64 for
    the x64 parity runs on the CPU). Besides the forward's arrays it holds
    what a backward on the card reads: ``edge_dst`` [B*E] int32 (each
    edge's flattened destination, -1 for a padded edge) and the SOURCE
    CSR ``src_csr_row_ptr`` / ``src_csr_col`` (``build_csr`` of the
    flattened sources)."""
    nf = np.asarray(obs["node_features"])
    if not np.issubdtype(nf.dtype, np.floating):
        nf = nf.astype(np.float32)
    batch, n_nodes = nf.shape[:2]
    src, node_mask, row_ptr, col = flat_graph_inputs(
        obs["edges_src"], obs["edges_dst"], obs["node_split"],
        obs["edge_split"], n_nodes)
    edges_dst = np.asarray(obs["edges_dst"])
    n_edges = np.asarray(obs["edge_split"]).reshape(batch, -1)[:, 0]
    edge_mask = (np.arange(edges_dst.shape[1]) < n_edges[:, None]).reshape(
        -1)
    offsets = (np.arange(batch, dtype=np.int64) * n_nodes)[:, None]
    edge_dst = np.where(edge_mask, (edges_dst + offsets).reshape(-1),
                        -1).astype(np.int32)
    src_row_ptr, src_col = build_csr(src, edge_mask, batch * n_nodes)
    return {
        "node_features": nf,
        "edge_features": np.asarray(obs["edge_features"], nf.dtype),
        "graph_features": np.asarray(obs["graph_features"], nf.dtype),
        "action_mask": np.asarray(obs["action_mask"], np.int32),
        "src": src, "node_mask": node_mask.astype(nf.dtype),
        "csr_row_ptr": row_ptr, "csr_col": col, "edge_dst": edge_dst,
        "src_csr_row_ptr": src_row_ptr, "src_csr_col": src_col,
    }


# the batch keys the card's backward reads (GNN.forward's grad_inputs)
GRAD_INPUT_KEYS = ("edge_dst", "src_csr_row_ptr", "src_csr_col")


# ----------------------------------------------------------------- modules
class MLPHead(nn.Module):
    """Dense stack for the logit and value readouts; ``Dense_k`` names
    follow flax's. ``GNNPolicy`` runs both heads through K17
    (``mlp_heads``); ``forward`` is the one head in plain PyTorch."""

    def __init__(self, in_features: int, hiddens: Sequence[int],
                 out_features: int, activation: str = "relu", device=None):
        super().__init__()
        self.activation = activation
        get_activation(activation)
        widths = [in_features, *hiddens, out_features]
        self.n_layers = len(widths) - 1
        for i in range(self.n_layers):
            setattr(self, f"Dense_{i}",
                    nn.Linear(widths[i], widths[i + 1], device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _mlp_stack(x, head_layers(self), self.activation)


class GNNPolicy(nn.Module):
    """Actor-critic over padded-graph observations
    (``ddls_tpu/models/policy.py:GNNPolicy``, same defaults and parameter
    names). Unlike flax, the input widths are given, not inferred:
    ``graph_feature_dim`` is the encoder's graph-vector width."""

    def __init__(self, n_actions: int, graph_feature_dim: int,
                 out_features_msg: int = 32, out_features_hidden: int = 64,
                 out_features_node: int = 16, out_features_graph: int = 8,
                 num_rounds: int = 2, module_depth: int = 1,
                 activation: str = "relu",
                 fcnet_hiddens: Sequence[int] = (256, 256),
                 fcnet_activation: str = "relu",
                 apply_action_mask: bool = True,
                 node_feature_dim: int = NODE_FEATURE_DIM,
                 edge_feature_dim: int = EDGE_FEATURE_DIM,
                 device=None):
        super().__init__()
        self.n_actions = int(n_actions)
        self.graph_feature_dim = int(graph_feature_dim)
        self.apply_action_mask = bool(apply_action_mask)
        self.gnn = GNN(node_feature_dim, edge_feature_dim, out_features_msg,
                       out_features_hidden, out_features_node, num_rounds,
                       module_depth, activation, device)
        self.graph_module = FeatureModule(graph_feature_dim,
                                          out_features_graph, module_depth,
                                          activation, device)
        readout = out_features_node + out_features_graph
        self.logit_head = MLPHead(readout, fcnet_hiddens, n_actions,
                                  fcnet_activation, device)
        self.value_head = MLPHead(readout, fcnet_hiddens, 1,
                                  fcnet_activation, device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _mask_logits(self, logits: torch.Tensor, action_mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(masked logits, greedy actions) through K4; without action
        masking every action counts as valid (``logits + 0``)."""
        if not self.apply_action_mask:
            action_mask = torch.ones_like(action_mask)
        return mask_logits_argmax(logits, action_mask)

    def flat_batched(self, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """B observations as ONE flattened graph (``prepare_flat_batch``
        arrays as tensors on this model's device) -> (masked logits [B, A],
        values [B], greedy actions [B] int64). Differentiable: on the card
        the backward runs through K5, K6 and K4's pass-through, and reads
        the batch's ``edge_dst`` and source CSR."""
        logits, values = self.trunk(batch)
        masked, actions = self._mask_logits(logits, batch["action_mask"])
        return masked, values, actions

    def sample_batched(self, batch: Dict[str, torch.Tensor],
                       u: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The rollout forward: ``flat_batched`` with K4 replaced by K9,
        which masks the logits and samples from them with the uniforms
        ``u`` [B, A] -> (actions [B] int32, logp [B], values [B])."""
        logits, values = self.trunk(batch)
        mask = batch["action_mask"]
        if not self.apply_action_mask:
            mask = torch.ones_like(mask)
        actions, logp = mask_sample_logp(logits, mask, u)
        return actions, logp, values

    def trunk(self, batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """GNN, pooling and both heads (K17): (raw logits [B, A], values
        [B])."""
        nf = batch["node_features"]
        ef = batch["edge_features"]
        b, n, fn = nf.shape
        e = ef.shape[1]
        node_mask = batch["node_mask"]
        grad_inputs = {k: batch[k] for k in GRAD_INPUT_KEYS if k in batch}
        node_emb = self.gnn(nf.reshape(b * n, fn),
                            ef.reshape(b * e, ef.shape[2]), batch["src"],
                            node_mask, batch["csr_row_ptr"],
                            batch["csr_col"], grad_inputs)
        graph_emb = self.graph_module(batch["graph_features"])
        final_emb = masked_mean_pool_concat(
            node_emb.reshape(b, n, node_emb.shape[1]),
            node_mask.reshape(b, n), graph_emb)
        return mlp_heads(final_emb, head_layers(self.logit_head),
                         head_layers(self.value_head),
                         self.logit_head.activation)

    def forward(self, obs: Dict[str, np.ndarray]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One observation (the ``envs/obs.py`` dict) -> (masked logits
        [A], value []), as a batch of one through ``flat_batched``."""
        logits, values, _ = self.flat_batched(batch_to_device(
            prepare_flat_batch({k: np.asarray(v)[None]
                                for k, v in obs.items()}), self.device))
        return logits[0], values[0]


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
