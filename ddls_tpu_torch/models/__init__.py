"""Policy networks of the port (PyTorch): the GNN, the actor-critic and the
flax weight bridge."""
from ddls_tpu_torch.models.convert import (checkpoint_graph_feature_dim,
                                           flatten_tree, params_from_flax,
                                           params_to_flax)
from ddls_tpu_torch.models.gnn import GNN, FeatureModule, MeanPoolLayer
from ddls_tpu_torch.models.policy import (GNNPolicy, MLPHead,
                                          mask_logits_argmax,
                                          prepare_flat_batch)

__all__ = ["FeatureModule", "MeanPoolLayer", "GNN", "MLPHead", "GNNPolicy",
           "mask_logits_argmax", "prepare_flat_batch", "params_from_flax",
           "params_to_flax",
           "flatten_tree", "checkpoint_graph_feature_dim"]
