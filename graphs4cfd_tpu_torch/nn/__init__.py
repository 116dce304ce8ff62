"""Models: MLPs, MuS blocks and the MuS-GNN family."""
from .mlp import MLP, apply_mlp, apply_mlp_tail
from .model import GNN, params_from_jax, params_to_numpy, init_params_numpy
from .mus_gnn import (MuSGNN, build_mus_plan, mus_apply,
                      NsOneScaleGNN, NsTwoScaleGNN, NsThreeScaleGNN,
                      NsFourScaleGNN, AdvOneScaleGNN, AdvTwoScaleGNN,
                      AdvThreeScaleGNN, AdvFourScaleGNN)

__all__ = [
    "MLP", "apply_mlp", "apply_mlp_tail", "GNN", "params_from_jax",
    "params_to_numpy", "init_params_numpy", "MuSGNN", "build_mus_plan",
    "mus_apply", "NsOneScaleGNN", "NsTwoScaleGNN", "NsThreeScaleGNN",
    "NsFourScaleGNN", "AdvOneScaleGNN", "AdvTwoScaleGNN",
    "AdvThreeScaleGNN", "AdvFourScaleGNN",
]
