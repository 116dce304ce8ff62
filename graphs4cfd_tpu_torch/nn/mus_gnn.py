"""MuS-GNN family: multi-scale GNNs with grid-cluster pooling.

Port of ``graphs4cfd_tpu/nn/mus_gnn.py``.  One V-cycle engine runs any
MuS arch dict; the execution plan comes from the arch's key order, and the
reference's 8 class names are aliases.

Semantics (as in the JAX package):
  * node input = concat(field, loc?, glob?, omega?)
  * SELU after the encoders and after both outputs of every MP layer
  * tanh on the Down/Up pooling outputs
  * skip stack: Down pushes (v, e); Up consumes the coarse v and restores
    the fine level's edge features
  * the last level-1 MP layer before an Up or the decoder has a dead e'
    (``skip_e_out``), so the fused kernel does not store it
  * residual step: ``field[:, -num_fields:] + decoder(v)``
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..graph import Graph
from ..ops.fused_mlp import selu
from .blocks import down_mp, gn_block, pool_edges, up_mp
from .mlp import apply_mlp
from .model import GNN

_RESERVED = ("edge_encoder", "node_encoder", "decoder")


def build_mus_plan(arch: dict) -> List[Tuple]:
    """``mp*`` -> MP layer; ``down_mp{h}{l}`` -> pool to level ``l``;
    ``up_mp{l}{h}`` -> unpool from level ``l``."""
    plan = []
    for name in arch:
        if name in _RESERVED:
            continue
        if name.startswith("down_mp"):
            plan.append(("down", name, int(name[-1])))
        elif name.startswith("up_mp"):
            plan.append(("up", name, int(name[len("up_mp")])))
        elif name.startswith("mp"):
            plan.append(("mp", name))
        else:
            raise ValueError(f"Unknown arch key for MuS plan: {name!r}")
    return plan


def node_input(graph: Graph) -> torch.Tensor:
    parts = [graph.field] + [graph.data[n] for n in ("loc", "glob", "omega")
                             if graph.has(n)]
    return torch.cat(parts, dim=-1)


def mus_apply(layers, graph: Graph, plan, num_fields: int) -> torch.Tensor:
    """One residual time step of a MuS-GNN."""
    v = selu(apply_mlp(layers["node_encoder"], node_input(graph)))
    e = selu(apply_mlp(layers["edge_encoder"], graph.edge_attr))
    fixed_k = graph.get("fixed_k")
    sender_sort = ((graph.sender_perm, graph.sender_sorted)
                   if graph.has("sender_perm") else None)
    level = 1
    skips = []

    def mp(name, v, e, level, skip_e):
        if level == 1:
            return gn_block(layers[name], v, e, graph.senders,
                            graph.receivers, fixed_k=fixed_k, out_selu=True,
                            skip_e_out=skip_e, sender_sort=sender_sort)
        return gn_block(layers[name], v, e, graph.data[f"senders_{level}"],
                        graph.data[f"receivers_{level}"],
                        edge_mask=graph.data[f"edge_mask_{level}"],
                        out_selu=True)

    for i, op in enumerate(plan):
        if op[0] == "mp":
            nxt = plan[i + 1][0] if i + 1 < len(plan) else None
            # e' of the last layer of a level-1 group is dead when an up
            # (which restores e from the skip stack) or the decoder follows
            skip_e = (nxt in ("up", None) and level == 1
                      and fixed_k is not None)
            v, e = mp(op[1], v, e, level, skip_e)
        elif op[0] == "down":
            _, name, tgt = op
            skips.append((v, e))
            node_mask = (graph.node_mask if level == 1
                         else graph.data[f"node_mask_{level}"])
            v = down_mp(layers[name], v, graph.data[f"e_rel_{tgt}"],
                        graph.data[f"parent_{tgt}"],
                        graph.data[f"node_mask_{tgt}"].shape[0],
                        node_mask=node_mask)
            e = pool_edges(e, graph.data[f"edge_f2c_{tgt}"],
                           graph.data[f"senders_{tgt}"].shape[0])
            level = tgt
        elif op[0] == "up":
            _, name, src = op
            v_skip, e_skip = skips.pop()
            v = up_mp(layers[name], v, graph.data[f"e_rel_{src}"],
                      graph.data[f"parent_{src}"], v_skip)
            e = e_skip
            level = src - 1
    return graph.field[:, -num_fields:] + apply_mlp(layers["decoder"], v)


class MuSGNN(GNN):
    """Multi-scale GNN with grid-cluster pooling (any MuS arch dict)."""

    def build_plan(self, arch: dict):
        return build_mus_plan(arch)

    def forward(self, graph: Graph) -> torch.Tensor:
        return mus_apply(self.layers, graph, self.plan, self.num_fields)


# the reference's class names (its pretrained tables wait for a later slice)
class NsOneScaleGNN(MuSGNN):
    pass


class NsTwoScaleGNN(MuSGNN):
    pass


class NsThreeScaleGNN(MuSGNN):
    pass


class NsFourScaleGNN(MuSGNN):
    pass


class AdvOneScaleGNN(MuSGNN):
    pass


class AdvTwoScaleGNN(MuSGNN):
    pass


class AdvThreeScaleGNN(MuSGNN):
    pass


class AdvFourScaleGNN(MuSGNN):
    pass
