"""Models: MLPs, MuS and REMuS blocks, the MuS-GNN, REMuS-GNN and gMuS-GNN
families and the training loss."""
from .losses import GraphLoss
from .mlp import MLP, apply_mlp, apply_mlp_tail
from .model import (GNN, grad_norm2, init_params_numpy, params_from_jax,
                    params_to_numpy)
from .mus_gnn import (MuSGNN, build_mus_plan, mus_apply,
                      NsOneScaleGNN, NsTwoScaleGNN, NsThreeScaleGNN,
                      NsFourScaleGNN, AdvOneScaleGNN, AdvTwoScaleGNN,
                      AdvThreeScaleGNN, AdvFourScaleGNN)
from .remus_gnn import (REMuSGNN, build_remus_plan, remus_apply,
                        NsRotEquiThreeScaleGNN, NsRotEquiTreeScaleGNN)
from .mugs_gnn import (MuGSGNN, build_mugs_plan, mugs_apply,
                       NsTwoGuillardScaleGNN, NsThreeGuillardScaleGNN,
                       NsFourGuillardScaleGNN)

__all__ = [
    "MLP", "apply_mlp", "apply_mlp_tail", "GNN", "GraphLoss", "grad_norm2",
    "params_from_jax",
    "params_to_numpy", "init_params_numpy", "MuSGNN", "build_mus_plan",
    "mus_apply", "NsOneScaleGNN", "NsTwoScaleGNN", "NsThreeScaleGNN",
    "NsFourScaleGNN", "AdvOneScaleGNN", "AdvTwoScaleGNN",
    "AdvThreeScaleGNN", "AdvFourScaleGNN", "REMuSGNN", "build_remus_plan",
    "remus_apply", "NsRotEquiThreeScaleGNN", "NsRotEquiTreeScaleGNN",
    "MuGSGNN", "build_mugs_plan", "mugs_apply", "NsTwoGuillardScaleGNN",
    "NsThreeGuillardScaleGNN", "NsFourGuillardScaleGNN",
]
