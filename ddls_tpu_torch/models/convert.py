"""The weight bridge: a flax ``GNNPolicy`` parameter tree <-> a state dict
of the port's ``GNNPolicy``.

The flax tree's paths are frozen by the shipped checkpoints:
``params/{gnn/round_i/{node,edge,reduce}_module, graph_module,
logit_head, value_head}/{Dense_k, LayerNorm_0}/{kernel, bias, scale}``.
The port's modules carry the same names, so the state-dict key is the
path without ``params/``, joined with dots, with ``kernel`` and ``scale``
renamed ``weight``. flax's ``Dense.kernel`` is [in, out] and torch's
``Linear.weight`` is [out, in], so kernels are transposed.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def flatten_tree(tree: Mapping[str, Any], prefix: str = ""
                 ) -> Dict[str, np.ndarray]:
    """A nested dict of arrays -> ``{"a/b/c": array}`` (the form the
    export ``.npz`` stores and ``params_from_flax`` reads)."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, prefix=f"{path}/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def params_from_flax(tree: Mapping[str, np.ndarray], model: nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """Convert a flattened flax tree (``flatten_tree`` of
    ``{"params": ...}``) into a state dict for ``model``, on the CPU.
    Raises on any leaf missing from the tree, any leaf the model does not
    have, and any shape that does not match."""
    expected = model.state_dict()
    state: Dict[str, torch.Tensor] = {}
    unknown = []
    for path, value in tree.items():
        parts = path.split("/")
        if len(parts) < 3 or parts[0] != "params" or \
                parts[-1] not in _LEAF_NAMES:
            unknown.append(path)
            continue
        key = ".".join(parts[1:-1] + [_LEAF_NAMES[parts[-1]]])
        if key not in expected:
            unknown.append(path)
            continue
        arr = np.array(value, dtype=np.float32)  # a writable copy
        if parts[-1] == "kernel":
            arr = arr.T
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(f"{path}: shape {tuple(np.shape(value))} does "
                             f"not fit {key} {tuple(expected[key].shape)}")
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    if unknown:
        raise ValueError(f"flax leaves with no place in the model: "
                         f"{sorted(unknown)}")
    missing = sorted(set(expected) - set(state))
    if missing:
        raise ValueError(f"model parameters missing from the flax tree: "
                         f"{missing}")
    return state


def params_to_flax(state: Mapping[str, torch.Tensor]
                   ) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_flax``: a state dict -> the flattened
    flax tree (``{"params/.../kernel": array}``), kernels transposed back
    to flax's [in, out], so a trained state dict compares leaf for leaf
    with the JAX params tree. A ``weight`` is a Dense ``kernel`` when its
    module is a ``Dense_k``, a LayerNorm ``scale`` otherwise."""
    tree: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        parts = key.split(".")
        module, leaf = parts[:-1], parts[-1]
        arr = value.detach().cpu().numpy()
        if leaf == "weight":
            if module[-1].startswith("Dense_"):
                leaf, arr = "kernel", arr.T
            else:
                leaf = "scale"
        elif leaf != "bias":
            raise ValueError(f"state-dict key {key!r} has no flax leaf")
        tree["/".join(["params", *module, leaf])] = np.ascontiguousarray(arr)
    return tree


def checkpoint_graph_feature_dim(tree: Mapping[str, np.ndarray]
                                 ) -> Optional[int]:
    """The graph-vector width a flattened tree was trained at:
    ``graph_module/Dense_0/kernel``'s input dimension; None when the tree
    has no such leaf."""
    kernel = tree.get("params/graph_module/Dense_0/kernel")
    if kernel is None or np.ndim(kernel) != 2:
        return None
    return int(np.shape(kernel)[0])
