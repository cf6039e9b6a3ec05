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

On the card, a call that autograd records is a ``torch.autograd.Function``
whose backward is kernel K5 (``ln_linear_act_bwd``): per-row input
gradients and the parameter gradients, and, for the gathered left half of
a message call, the fold of the per-edge rows into the rows of ``node_int``
along the source CSR (K6 ``csr_segment_sum``, no atomics). On the CPU,
autograd differentiates the plain version, written so that its derivative
follows JAX's at the kinks (the variance clamp's tie passes half).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ddls_tpu_torch import kernels
from ddls_tpu_torch.ops.segment import csr_segment_mean, csr_segment_sum

# the activations flax's get_activation knows, in K1's activation-code
# order (kernels/csrc/ln_linear_act.cu:activate)
ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    # jnp.where(x >= 0, ...): the derivative at 0 is 1, as in JAX
    "leaky_relu": lambda x: torch.where(x >= 0, x, 0.01 * x),
    "tanh": torch.tanh,
    "swish": lambda x: x * torch.sigmoid(x),
    # flax's nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}
_ACTIVATION_CODES = {name: i for i, name in enumerate(ACTIVATIONS)}
LN_EPS = 1e-6  # flax LayerNorm's epsilon


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
    that row alone whatever else shares the batch (``_ln_dense``)."""
    x = _row_input(a, idx, b, b_width)
    return get_activation(activation)(_ln_dense(x, ln_w, ln_b, w, bias)[0])


def _row_input(a, idx, b, b_width):
    x = a if idx is None else a[idx.long()]
    if b is not None:
        x = torch.cat([x, b], dim=1)
    elif b_width:
        x = torch.cat([x, x.new_zeros((x.shape[0], b_width))], dim=1)
    return x


def _ln_dense(x, ln_w, ln_b, w, bias):
    """(pre-activation z, y, mean, raw, var, rstd) of the row arithmetic:
    flax's statistics in PyTorch's own summation order, the Dense sum one
    feature at a time. ``torch.maximum`` for the clamp, so autograd passes
    half the gradient at the tie raw == 0, as ``jnp.maximum`` does."""
    inv_k = torch.tensor(1.0 / x.shape[1], dtype=x.dtype)
    mean = x.sum(dim=1) * inv_k
    raw = (x * x).sum(dim=1) * inv_k - mean * mean
    var = torch.maximum(raw, torch.zeros((), dtype=x.dtype))
    rstd = torch.rsqrt(var + LN_EPS)
    y = (x - mean[:, None]) * (rstd[:, None] * ln_w) + ln_b
    acc = y.new_zeros((y.shape[0], w.shape[0]))
    for k in range(w.shape[1]):
        acc = acc + y[:, k, None] * w[:, k]
    return acc + bias, y, mean, raw, var, rstd


def activation_grad(z: torch.Tensor, activation: str) -> torch.Tensor:
    """d act / d z with JAX's rules at the kinks (relu: 0 at 0; leaky_relu:
    1 at 0), K5's ``activate_grad``."""
    if activation == "relu":
        return (z > 0).to(z.dtype)
    if activation == "leaky_relu":
        return torch.where(z >= 0, torch.ones_like(z),
                           torch.full_like(z, 0.01))
    if activation == "tanh":
        t = torch.tanh(z)
        return 1.0 - t * t
    if activation == "swish":
        sg = torch.sigmoid(z)
        return sg + z * sg * (1.0 - sg)
    if activation == "gelu":
        k = 0.7978845608028654
        t = torch.tanh(k * (z + 0.044715 * z ** 3))
        return (0.5 * (1.0 + t)
                + 0.5 * z * (1.0 - t * t) * k * (1.0 + 3 * 0.044715 * z * z))
    get_activation(activation)  # raises with the known names
    raise ValueError(f"no derivative for activation {activation!r}")


# ----------------------------------- K5: backward of LN -> Dense -> act
def ln_linear_act_bwd_plain(a, ln_w, ln_b, w, bias, activation, dout,
                            idx=None, b=None, b_width=0, out=None):
    """The backward of ``ln_linear_act`` in K5's arithmetic: returns
    ``(dx_rows [R, Fa], db [R, Fb] or None, dW [O, K], dbias [O], d ln_w
    [K], d ln_b [K])``. ``dx_rows`` is per row: for an ``idx`` call the
    caller folds it into the rows of ``a`` (``csr_segment_sum``). The
    LayerNorm part is the derivative of flax's fast variance (see
    ``kernels/csrc/ln_linear_act_bwd.cu``).

    ``out``, the forward's output on the same inputs, fixes the side of
    relu's and leaky_relu's kink for each pre-activation (``out > 0``,
    ``out >= 0``): given K1's output, this version takes the decisions
    that K1, and K5 which recomputes K1's pre-activations, took, so a
    pre-activation one rounding away from 0 in this version's summation
    order does not flip its derivative."""
    x = _row_input(a, idx, b, b_width)
    z, y, mean, raw, var, rstd = _ln_dense(x, ln_w, ln_b, w, bias)
    if out is not None and activation in ("relu", "leaky_relu"):
        side = out > 0 if activation == "relu" else out >= 0
        slope = 0.0 if activation == "relu" else 0.01
        dz = dout * torch.where(side, torch.ones_like(z),
                                torch.full_like(z, slope))
    else:
        dz = dout * activation_grad(z, activation)
    dy = dz @ w
    xc = x - mean[:, None]
    d_mul = dy * xc
    d_rstd = (d_mul * ln_w).sum(dim=1)
    dxc = dy * (rstd[:, None] * ln_w)
    d_var = d_rstd * (-0.5 * (rstd / (var + LN_EPS)))
    half = torch.tensor(0.5, dtype=x.dtype)
    d_raw = d_var * torch.where(raw > 0, torch.ones_like(raw),
                                torch.where(raw == 0, half,
                                            torch.zeros_like(raw)))
    d_mean = -dxc.sum(dim=1) - d_raw * (2.0 * mean)
    inv_k = 1.0 / x.shape[1]
    dx = dxc + (d_mean * inv_k)[:, None] + (d_raw * inv_k)[:, None] * (
        2.0 * x)
    fa = a.shape[1]
    db = dx[:, fa:] if b is not None else None
    return (dx[:, :fa], db, dz.t() @ y, dz.sum(dim=0),
            (d_mul * rstd[:, None]).sum(dim=0), dy.sum(dim=0))


# K1's and K5's grids, functions of the row count alone (so are K5's
# partial sums and the bits of its result): the smallest tile of 16, 32 or
# 64 rows that needs at most 256 CTAs (about two an SM of the H100) at one
# tile a CTA, else 64-row tiles over 256 CTAs, CTA g taking tiles g, g +
# CTAs, ... (ln_tile.cuh). K1's cap is the fastest of 132-1,024 at the
# update's calls (scripts/parent_kernel_check.py); K5's is its reduce's:
# groups of 16 CTAs' rows, then the (at most 16) groups (kGroup)
_TILES = (16, 32, 64)
_FWD_MAX_BLOCKS = 256
_BWD_GROUP = 16
_BWD_MAX_BLOCKS = _BWD_GROUP * _BWD_GROUP


def _tile_grid(rows: int, most: int) -> Tuple[int, int, int]:
    tile = next((t for t in _TILES if -(-rows // t) <= most), _TILES[-1])
    tiles = -(-rows // tile)
    return max(1, min(tiles, most)), tiles, tile


def fwd_grid(rows: int) -> Tuple[int, int, int]:
    """K1's (CTAs, tiles, rows a tile) for ``rows`` rows: CTA ``g`` takes
    tiles ``g, g + CTAs, ...`` (at least one CTA, for the zero-row
    call)."""
    return _tile_grid(rows, _FWD_MAX_BLOCKS)


def bwd_grid(rows: int) -> Tuple[int, int, int]:
    """K5's (CTAs, tiles, rows a tile) for ``rows`` rows, as ``fwd_grid``
    with at most ``_BWD_MAX_BLOCKS`` CTAs (its reduce's groups)."""
    return _tile_grid(rows, _BWD_MAX_BLOCKS)


def ln_linear_act_bwd_reduce_plain(partial: torch.Tensor) -> torch.Tensor:
    """The sum of the rows of ``partial`` [G, P], added one row at a time
    in order."""
    acc = partial.new_zeros(partial.shape[1])
    for g in range(partial.shape[0]):
        acc = acc + partial[g]
    return acc


def _bwd_counters(device: torch.device) -> torch.Tensor:
    """K5's reduce counters on ``device`` for the current stream
    (``kernels.stream_counters``)."""
    return kernels.stream_counters("ln_linear_act_bwd", 1 + _BWD_GROUP,
                                   device)


def ln_linear_act_bwd(a, ln_w, ln_b, w, bias, activation, dout, idx=None,
                      b=None, b_width=0, want_dx=True, want_db=True):
    """K5 ``ln_linear_act_bwd`` (its reduce over the CTAs inside the
    launch): the tuple of ``ln_linear_act_bwd_plain`` from float32 tensors
    on the card, without ``dx_rows`` when ``want_dx`` is False and without
    ``db`` when ``want_db`` is False (or ``b`` is None)."""
    if kernels.on_cpu(a, ln_w, ln_b, w, bias, dout, idx, b):
        out = ln_linear_act_bwd_plain(a, ln_w, ln_b, w, bias, activation,
                                      dout, idx=idx, b=b, b_width=b_width)
        return ((out[0] if want_dx else None),
                (out[1] if want_db else None)) + out[2:]
    rows, fa, fb, fo = _check_ln_linear_act(a, ln_w, ln_b, w, bias,
                                            activation, idx, b, b_width)
    kernels.check_cuda("dout", dout, torch.float32, (rows, fo))
    k_in = fa + fb
    n_params = fo * k_in + fo + 2 * k_in
    dx = a.new_empty((rows, fa)) if want_dx else None
    db = a.new_empty((rows, fb)) if (want_db and b is not None) else None
    blocks, _, tile = bwd_grid(rows)
    n_groups = -(-blocks // _BWD_GROUP)
    if rows:
        # the kernel's rows of partial sums are padded to float4s
        width = -(-n_params // 4) * 4
        grads = a.new_empty(width)
        counters = _bwd_counters(a.device)
        scratch = a.new_empty((blocks + n_groups, width))
        kernels.launch("ln_linear_act_bwd", a.data_ptr(), kernels.ptr(idx),
                       kernels.ptr(b), ln_w.data_ptr(), ln_b.data_ptr(),
                       w.data_ptr(), bias.data_ptr(), dout.data_ptr(),
                       kernels.ptr(dx), kernels.ptr(db), scratch.data_ptr(),
                       scratch[blocks:].data_ptr(), grads.data_ptr(),
                       counters.data_ptr(), rows, fa, fb, int(b is not None),
                       fo, _ACTIVATION_CODES[activation], tile, blocks,
                       _BWD_GROUP)
    else:  # no rows: zero gradients
        grads = a.new_zeros(n_params)
    n_w = fo * k_in
    return (dx, db, grads[:n_w].view(fo, k_in), grads[n_w:n_w + fo],
            grads[n_w + fo:n_w + fo + k_in], grads[n_w + fo + k_in:n_params])


def ln_linear_act(a: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                  w: torch.Tensor, bias: torch.Tensor, activation: str,
                  idx: Optional[torch.Tensor] = None,
                  b: Optional[torch.Tensor] = None,
                  b_width: int = 0,
                  src_csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> torch.Tensor:
    """K1: ``act(LN(x) @ w.T + bias)`` per row, where row ``r`` is
    ``concat(a[idx[r]] if idx is given else a[r], b[r] if b is given else
    zeros(b_width))``.

    ``a`` [Ra, Fa], ``b`` [R, Fb], ``ln_w``/``ln_b`` [Fa + Fb], ``w``
    [O, Fa + Fb] (torch layout), ``bias`` [O], all float32; ``idx`` [R]
    int32. The kernel takes Fa + Fb <= 64 and O <= 64. ``src_csr`` is the
    CSR of ``idx`` (``build_csr(idx, edge_mask, Ra)``): the card's backward
    of an ``idx`` call needs it."""
    if kernels.on_cpu(a, ln_w, ln_b, w, bias, idx, b):
        return ln_linear_act_plain(a, ln_w, ln_b, w, bias, activation,
                                   idx=idx, b=b, b_width=b_width)
    if not kernels.needs_grad(a, ln_w, ln_b, w, bias, b):
        return _ln_linear_act_cuda(a, ln_w, ln_b, w, bias, activation, idx,
                                   b, b_width)
    if idx is not None:
        if src_csr is None:
            raise ValueError("ln_linear_act's backward on the card folds "
                             "the gathered rows along the source CSR: pass "
                             "src_csr (prepare_flat_batch gives it)")
        if src_csr[0].shape[0] != a.shape[0] + 1:
            raise ValueError(f"src_csr's row_ptr must have {a.shape[0] + 1}"
                             f" entries, got {src_csr[0].shape[0]}")
        row_ptr, col = src_csr
    else:
        row_ptr = col = None
    return _LnLinearAct.apply(a, ln_w, ln_b, w, bias, idx, b, row_ptr, col,
                              activation, b_width)


def _check_ln_linear_act(a, ln_w, ln_b, w, bias, activation, idx, b,
                         b_width) -> Tuple[int, int, int, int]:
    """Raise on what K1 and K5 cannot take; returns (rows, Fa, Fb, O)."""
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
    return rows, fa, fb, fo


def _ln_linear_act_cuda(a, ln_w, ln_b, w, bias, activation, idx, b,
                        b_width):
    rows, fa, fb, fo = _check_ln_linear_act(a, ln_w, ln_b, w, bias,
                                            activation, idx, b, b_width)
    out = a.new_empty((rows, fo))
    if rows:
        blocks, _, tile = fwd_grid(rows)
        kernels.launch("ln_linear_act", a.data_ptr(), kernels.ptr(idx),
                       kernels.ptr(b), ln_w.data_ptr(), ln_b.data_ptr(),
                       w.data_ptr(), bias.data_ptr(), out.data_ptr(), rows,
                       fa, fb, int(b is not None), fo,
                       _ACTIVATION_CODES[activation], tile, blocks)
    return out


class _LnLinearAct(torch.autograd.Function):
    """K1 forward; K5 backward, and for a gathered left half the K6 fold
    along the source CSR."""

    @staticmethod
    def forward(ctx, a, ln_w, ln_b, w, bias, idx, b, row_ptr, col,
                activation, b_width):
        ctx.save_for_backward(a, ln_w, ln_b, w, bias, idx, b, row_ptr, col)
        ctx.activation, ctx.b_width = activation, b_width
        return _ln_linear_act_cuda(a, ln_w, ln_b, w, bias, activation, idx,
                                   b, b_width)

    @staticmethod
    def backward(ctx, dout):
        a, ln_w, ln_b, w, bias, idx, b, row_ptr, col = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, db, dw, dbias, dlnw, dlnb = ln_linear_act_bwd(
            a, ln_w, ln_b, w, bias, ctx.activation, dout.contiguous(),
            idx=idx, b=b, b_width=ctx.b_width, want_dx=need[0],
            want_db=need[6])
        if dx is not None and idx is not None:
            dx = csr_segment_sum(dx, row_ptr, col)
        return (dx, dlnw, dlnb, dw, dbias, None, db, None, None, None,
                None)


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
                b: Optional[torch.Tensor] = None, b_width: int = 0,
                src_csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """The module over rows ``concat(a[idx] or a, b or zeros(b_width))``
        (see ``ln_linear_act``)."""
        dense = self.Dense_0
        x = ln_linear_act(a, self.LayerNorm_0.weight, self.LayerNorm_0.bias,
                          dense.weight, dense.bias, self.activation,
                          idx=idx, b=b, b_width=b_width, src_csr=src_csr)
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
                row_ptr: torch.Tensor, col: torch.Tensor,
                grad_inputs: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """``grad_inputs``: what the card's backward needs (see
        ``GNN.forward``)."""
        g = grad_inputs or {}
        src_csr = ((g["src_csr_row_ptr"], g["src_csr_col"])
                   if "src_csr_row_ptr" in g else None)
        node_int = self.node_module(node_feats)
        edge_int = self.edge_module(edge_feats)
        embedded_msgs = self.reduce_module(node_int, idx=src, b=edge_int,
                                           src_csr=src_csr)
        embedded_self = self.reduce_module(node_int, b_width=self.half)
        return csr_segment_mean(embedded_msgs, embedded_self, row_ptr, col,
                                node_mask, edge_dst=g.get("edge_dst"))


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
                row_ptr: torch.Tensor, col: torch.Tensor,
                grad_inputs: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """``grad_inputs``: the host-built arrays that the card's backward
        reads (``edge_dst`` [E] int32, -1 for a padded edge; the source CSR
        ``src_csr_row_ptr`` [V+1] / ``src_csr_col`` [E], as
        ``prepare_flat_batch`` names them); on the CPU, and without
        gradients, they are not needed."""
        h = node_feats
        for i in range(self.num_rounds):
            h = getattr(self, f"round_{i}")(h, edge_feats, src, node_mask,
                                            row_ptr, col, grad_inputs)
        return h
