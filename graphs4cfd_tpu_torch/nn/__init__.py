"""Models: MLPs, MuS blocks, the MuS-GNN family and the training loss."""
from .losses import GraphLoss
from .mlp import MLP, apply_mlp, apply_mlp_tail
from .model import (GNN, grad_norm2, init_params_numpy, params_from_jax,
                    params_to_numpy)
from .mus_gnn import (MuSGNN, build_mus_plan, mus_apply,
                      NsOneScaleGNN, NsTwoScaleGNN, NsThreeScaleGNN,
                      NsFourScaleGNN, AdvOneScaleGNN, AdvTwoScaleGNN,
                      AdvThreeScaleGNN, AdvFourScaleGNN)

__all__ = [
    "MLP", "apply_mlp", "apply_mlp_tail", "GNN", "GraphLoss", "grad_norm2",
    "params_from_jax",
    "params_to_numpy", "init_params_numpy", "MuSGNN", "build_mus_plan",
    "mus_apply", "NsOneScaleGNN", "NsTwoScaleGNN", "NsThreeScaleGNN",
    "NsFourScaleGNN", "AdvOneScaleGNN", "AdvTwoScaleGNN",
    "AdvThreeScaleGNN", "AdvFourScaleGNN",
]
