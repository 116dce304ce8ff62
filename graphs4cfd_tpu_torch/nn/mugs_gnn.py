"""gMuS-GNN family: multi-scale GNNs on Guillard-coarsened levels.

Port of ``graphs4cfd_tpu/nn/mugs_gnn.py:34-169``.  One engine runs any
gMuS arch dict.  The arch has no down or up keys: the level of each
``mp{l}..`` layer is the digit after ``mp``, and a level change between
consecutive layers is a transition:

  * down l -> l+1: the rows ``v[down_idx_{l+1}]`` (the coarse nodes in
    local numbering), whose backward goes through
    ``index_put_(accumulate=True)``; the level's own k-NN edges take over;
  * up l -> l-1: k-NN interpolation (``ops.interp.knn_interpolate``), then
    the skip of level l-1 concatenated, so the first layer after an up step
    (``mp121``, ``mp221``) takes a node input twice as wide; the level's
    edge state is the one it left.

Semantics (as in the JAX package): node input = concat(field, loc?,
glob?, omega?); SELU after the encoders and on both outputs of every MP
layer (inside the kernel, ``out_selu``); every level is a fixed-k k-NN
graph, so every MP layer runs ``ops.gn_block`` with the level's senders and
their host sorts (``loader.attach_sender_sorts``; without them the
backward sorts on the device); the last layer of a level's final group has
no consumer for its edge state (``skip_e_out``); residual step
``field[:, -num_fields:] + decoder(v)``.

The JAX package's ``scan_layers`` (folding same-shape layers into one
``lax.scan``, a compile-time option of XLA that leaves the numbers as
they are) has no counterpart: PyTorch runs the layers in turn.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..graph import Graph
from ..ops.fused_mlp import selu
from ..ops.interp import knn_interpolate
from .blocks import gn_block
from .mlp import apply_mlp
from .model import GNN
from .mus_gnn import node_input
from .remus_gnn import _suffix


def build_mugs_plan(arch: dict) -> List[Tuple]:
    """``[("mp", name, level)]`` in execution order, levels parsed from the
    names."""
    plan = []
    for name in arch:
        if name.startswith("mp"):
            plan.append(("mp", name, int(name[2])))
        elif not (name.startswith(("edge_encoder", "node_encoder"))
                  or name == "decoder"):
            raise ValueError(f"Unknown arch key for gMuS plan: {name!r}")
    return plan


def mugs_apply(layers, graph: Graph, plan, num_fields: int) -> torch.Tensor:
    """One residual time step of a gMuS-GNN."""
    v = selu(apply_mlp(layers["node_encoder"], node_input(graph)))
    e = {1: selu(apply_mlp(layers["edge_encoder"], graph.edge_attr))}
    for l in range(2, graph.num_levels + 1):
        e[l] = selu(apply_mlp(layers[f"edge_encoder{l}"],
                              graph.data[f"edge_attr_{l}"]))
    groups = []
    for _, name, lvl in plan:
        if groups and groups[-1][0] == lvl:
            groups[-1][1].append(name)
        else:
            groups.append((lvl, [name]))
    last_group_of_level = {lvl: i for i, (lvl, _) in enumerate(groups)}
    level, skips = 1, {}
    for gi, (lvl, names) in enumerate(groups):
        while lvl > level:
            level += 1
            skips[level - 1] = v
            v = v[graph.data[f"down_idx_{level}"].long()]
        while lvl < level:
            v = knn_interpolate(v, graph.data[f"up_idx_{level}"],
                                graph.data[f"up_w_{level}"])
            v = torch.cat([v, skips.pop(level - 1)], dim=-1)
            level -= 1
        s = _suffix(level)
        fixed_k = graph.get(f"fixed_k{s}")
        sort = ((graph.data[f"sender_perm{s}"],
                 graph.data[f"sender_sorted{s}"])
                if graph.has(f"sender_perm{s}") else None)
        # the V-cycle never comes back to this level: the last layer's e'
        # has no consumer
        e_dead = last_group_of_level[lvl] == gi
        for j, name in enumerate(names):
            v, e[level] = gn_block(
                layers[name], v, e[level], graph.data[f"senders{s}"],
                graph.data[f"receivers{s}"], fixed_k=fixed_k, out_selu=True,
                skip_e_out=e_dead and j == len(names) - 1, sender_sort=sort)
    return graph.field[:, -num_fields:] + apply_mlp(layers["decoder"], v)


class MuGSGNN(GNN):
    """Multi-scale GNN on Guillard-coarsened levels (any gMuS arch dict)."""

    def build_plan(self, arch: dict):
        return build_mugs_plan(arch)

    def forward(self, graph: Graph) -> torch.Tensor:
        return mugs_apply(self.layers, graph, self.plan, self.num_fields)


# the reference's class names (their pretrained tables wait for a later
# slice)
class NsTwoGuillardScaleGNN(MuGSGNN):
    pass


class NsThreeGuillardScaleGNN(MuGSGNN):
    pass


class NsFourGuillardScaleGNN(MuGSGNN):
    pass
