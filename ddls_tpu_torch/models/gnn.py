"""Message-passing GNN over padded op graphs, in PyTorch.

Counterpart of ``ddls_tpu/models/gnn.py`` (same architecture, same
parameter names, so ``models/convert.py`` maps a flax tree onto it leaf by
leaf). The graph arrives flattened: a [V, F] node table, a [E, F] edge
table, ``src`` [E] int32 and the destination-sorted CSR of the unmasked
edges (``ops/segment.py:build_csr``) in place of ``edges_dst`` and the edge
mask.

Every ``FeatureModule``'s first LayerNorm -> Dense -> act is one launch of
kernel K1 (``ln_linear_act``), which also takes the message gather of
``MeanPoolLayer``: the reduce module reads ``concat(node_int[src],
edge_int)`` row by row, so the [E, msg] message tensor is never built, and
the self-message ``concat(node_int, 0)`` is the same call with a zero
right half. Dense layers past the first (``depth > 1``) are ``F.linear``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ddls_tpu_torch import kernels
from ddls_tpu_torch.ops.segment import csr_segment_mean

# the activations flax's get_activation knows, in K1's activation-code
# order (kernels/csrc/ln_linear_act.cu:activate)
ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "tanh": torch.tanh,
    "swish": lambda x: x * torch.sigmoid(x),
    # flax's nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}
_ACTIVATION_CODES = {name: i for i, name in enumerate(ACTIVATIONS)}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unrecognised activation {name!r}; "
                         f"choose from {sorted(ACTIVATIONS)}")


# ------------------------------------------------- K1: LN -> Dense -> act
def ln_linear_act_plain(a: torch.Tensor, ln_w: torch.Tensor,
                        ln_b: torch.Tensor, w: torch.Tensor,
                        bias: torch.Tensor, activation: str,
                        idx: Optional[torch.Tensor] = None,
                        b: Optional[torch.Tensor] = None,
                        b_width: int = 0) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: flax's LayerNorm (epsilon
    1e-6, fast variance ``max(E[x^2] - E[x]^2, 0)``, means as sum * (1/K)
    like XLA's ``jnp.mean``), then the Dense layer as a sum over the input
    features taken one feature at a time, so every row's result depends on
    that row alone whatever else shares the batch."""
    x = a if idx is None else a[idx.long()]
    if b is not None:
        x = torch.cat([x, b], dim=1)
    elif b_width:
        x = torch.cat([x, x.new_zeros((x.shape[0], b_width))], dim=1)
    inv_k = torch.tensor(1.0 / x.shape[1], dtype=x.dtype)
    mean = x.sum(dim=1) * inv_k
    var = torch.clamp((x * x).sum(dim=1) * inv_k - mean * mean, min=0.0)
    y = (x - mean[:, None]) * (torch.rsqrt(var + 1e-6)[:, None] * ln_w) + ln_b
    acc = y.new_zeros((y.shape[0], w.shape[0]))
    for k in range(w.shape[1]):
        acc = acc + y[:, k, None] * w[:, k]
    return get_activation(activation)(acc + bias)


def ln_linear_act(a: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                  w: torch.Tensor, bias: torch.Tensor, activation: str,
                  idx: Optional[torch.Tensor] = None,
                  b: Optional[torch.Tensor] = None,
                  b_width: int = 0) -> torch.Tensor:
    """K1: ``act(LN(x) @ w.T + bias)`` per row, where row ``r`` is
    ``concat(a[idx[r]] if idx is given else a[r], b[r] if b is given else
    zeros(b_width))``.

    ``a`` [Ra, Fa], ``b`` [R, Fb], ``ln_w``/``ln_b`` [Fa + Fb], ``w``
    [O, Fa + Fb] (torch layout), ``bias`` [O], all float32; ``idx`` [R]
    int32. The kernel takes Fa + Fb <= 64 and O <= 64."""
    if kernels.on_cpu(a, ln_w, ln_b, w, bias, idx, b):
        return ln_linear_act_plain(a, ln_w, ln_b, w, bias, activation,
                                   idx=idx, b=b, b_width=b_width)
    if activation not in _ACTIVATION_CODES:
        get_activation(activation)  # raises with the known names
    kernels.check_cuda("a", a, torch.float32)
    if a.dim() != 2:
        raise ValueError(f"a must be 2-D, got {tuple(a.shape)}")
    fa = a.shape[1]
    if idx is not None:
        kernels.check_cuda("idx", idx, torch.int32)
        if idx.dim() != 1:
            raise ValueError(f"idx must be 1-D, got {tuple(idx.shape)}")
        rows = idx.shape[0]
    else:
        rows = a.shape[0]
    if b is not None:
        kernels.check_cuda("b", b, torch.float32)
        if b.dim() != 2 or b.shape[0] != rows:
            raise ValueError(f"b must be [{rows}, Fb], got "
                             f"{tuple(b.shape)}")
        fb = b.shape[1]
    else:
        fb = int(b_width)
    k_in = fa + fb
    fo = w.shape[0]
    if k_in > 64 or fo > 64:
        raise ValueError(f"ln_linear_act takes <= 64 inputs and outputs, "
                         f"got {k_in} -> {fo}")
    kernels.check_cuda("ln_w", ln_w, torch.float32, (k_in,))
    kernels.check_cuda("ln_b", ln_b, torch.float32, (k_in,))
    kernels.check_cuda("w", w, torch.float32, (fo, k_in))
    kernels.check_cuda("bias", bias, torch.float32, (fo,))
    out = a.new_empty((rows, fo))
    if rows:
        kernels.launch("ln_linear_act", a.data_ptr(), kernels.ptr(idx),
                       kernels.ptr(b), ln_w.data_ptr(), ln_b.data_ptr(),
                       w.data_ptr(), bias.data_ptr(), out.data_ptr(), rows,
                       fa, fb, int(b is not None), fo,
                       _ACTIVATION_CODES[activation])
    return out


# ----------------------------------------------------------------- modules
class LayerNormParams(nn.Module):
    """flax ``LayerNorm``'s parameters (``scale`` -> ``weight``, ``bias``);
    the normalisation itself runs inside K1."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))


class FeatureModule(nn.Module):
    """LayerNorm -> Dense -> act, then (Dense -> act) ``depth - 1`` more
    times (``ddls_tpu/models/gnn.py:FeatureModule``). Attribute names
    follow flax's: ``LayerNorm_0``, ``Dense_0``, ``Dense_1``, ..."""

    def __init__(self, in_features: int, features: int, depth: int = 1,
                 activation: str = "relu", device=None):
        super().__init__()
        get_activation(activation)
        self.activation = activation
        self.depth = int(depth)
        self.LayerNorm_0 = LayerNormParams(in_features, device=device)
        for i in range(self.depth):
            setattr(self, f"Dense_{i}",
                    nn.Linear(in_features if i == 0 else features, features,
                              device=device))

    def forward(self, a: torch.Tensor, idx: Optional[torch.Tensor] = None,
                b: Optional[torch.Tensor] = None,
                b_width: int = 0) -> torch.Tensor:
        """The module over rows ``concat(a[idx] or a, b or zeros(b_width))``
        (see ``ln_linear_act``)."""
        dense = self.Dense_0
        x = ln_linear_act(a, self.LayerNorm_0.weight, self.LayerNorm_0.bias,
                          dense.weight, dense.bias, self.activation,
                          idx=idx, b=b, b_width=b_width)
        act = get_activation(self.activation)
        for i in range(1, self.depth):
            dense = getattr(self, f"Dense_{i}")
            x = act(F.linear(x, dense.weight, dense.bias))
        return x


class MeanPoolLayer(nn.Module):
    """One round of message passing + mean aggregation: the message on edge
    (u -> v) is ``concat(node_module(h_u), edge_module(e_uv))``, every node
    also sends itself ``concat(node_module(h_v), 0)``, the reduce module
    embeds both, and a node's new state is the mean over {self} U its
    in-edges, zeroed for masked nodes."""

    def __init__(self, in_features_node: int, in_features_edge: int,
                 out_features_msg: int, out_features_reduce: int,
                 module_depth: int = 1, activation: str = "relu",
                 device=None):
        super().__init__()
        self.half = out_features_msg // 2
        self.node_module = FeatureModule(in_features_node, self.half,
                                         module_depth, activation, device)
        self.edge_module = FeatureModule(in_features_edge, self.half,
                                         module_depth, activation, device)
        self.reduce_module = FeatureModule(2 * self.half,
                                           out_features_reduce, module_depth,
                                           activation, device)

    def forward(self, node_feats: torch.Tensor, edge_feats: torch.Tensor,
                src: torch.Tensor, node_mask: torch.Tensor,
                row_ptr: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
        node_int = self.node_module(node_feats)
        edge_int = self.edge_module(edge_feats)
        embedded_msgs = self.reduce_module(node_int, idx=src, b=edge_int)
        embedded_self = self.reduce_module(node_int, b_width=self.half)
        return csr_segment_mean(embedded_msgs, embedded_self, row_ptr, col,
                                node_mask)


class GNN(nn.Module):
    """``num_rounds`` MeanPool layers, node widths in -> hidden^(r-1) ->
    out, the original edge features re-used every round."""

    def __init__(self, in_features_node: int, in_features_edge: int,
                 out_features_msg: int = 32, out_features_hidden: int = 64,
                 out_features_node: int = 16, num_rounds: int = 2,
                 module_depth: int = 1, activation: str = "relu",
                 device=None):
        super().__init__()
        if num_rounds < 2:
            raise ValueError("num_rounds must be >= 2")
        self.num_rounds = int(num_rounds)
        dims = ([out_features_hidden] * (num_rounds - 1)
                + [out_features_node])
        width = in_features_node
        for i, dim in enumerate(dims):
            setattr(self, f"round_{i}",
                    MeanPoolLayer(width, in_features_edge, out_features_msg,
                                  dim, module_depth, activation, device))
            width = dim

    def forward(self, node_feats: torch.Tensor, edge_feats: torch.Tensor,
                src: torch.Tensor, node_mask: torch.Tensor,
                row_ptr: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
        h = node_feats
        for i in range(self.num_rounds):
            h = getattr(self, f"round_{i}")(h, edge_feats, src, node_mask,
                                            row_ptr, col)
        return h
