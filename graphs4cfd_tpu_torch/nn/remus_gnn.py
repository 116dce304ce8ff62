"""REMuS-GNN family: rotation-equivariant multi-scale message passing on
edges and edge-edge angles.

Port of ``graphs4cfd_tpu/nn/remus_gnn.py``.  One V-cycle engine runs any
REMuS arch dict; the execution plan comes from the arch's key order.

Semantics (as in the JAX package):
  * input: each level's node field window is projected onto the level's
    edge unit vectors and joined with ``glob`` and ``omega`` of the
    receiver (coarse levels read the fine nodes they came from,
    ``node_origin_{l}``); angle and inter-level angle features are encoded
    per level;
  * SELU after every encoder, after ``down_edge_mp`` and after
    ``up_edge_mp``; the inter-layer SELU of ``edge_mp`` is fused into the
    kernel's outputs (``out_selu``);
  * the last EdgeMP of a level's final group of layers has no consumer
    for its angles: the kernel does not store them (``skip_a_out``); the
    numbers do not change;
  * output: the decoded level-1 edge scalars are solved back into node
    vectors through the precomputed pinverses; ``num_fields`` is 2;
  * residual step: ``field[:, -2:] + out``;
  * ``compute_dtype`` bf16: the bf16 policy (``nn.blocks``); the pinverse
    solve of the decoded scalars runs in f32, so the step's output is f32.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..graph import Graph
from ..ops.fused_mlp import selu
from .blocks import (down_edge_mp, edge_mp, edge_scalar_to_node_vector,
                     up_edge_mp)
from .mlp import apply_mlp
from .model import GNN


def build_remus_plan(arch: dict) -> List[Tuple]:
    """``mp{l}..`` -> EdgeMP layer at level ``l``; ``down_mp{h}{l}`` ->
    pool to level ``l``; ``up_mp{l}{h}`` -> unpool from level ``l``."""
    plan = []
    for name in arch:
        if name.startswith(("angle_encoder", "edge_encoder")) \
                or name == "decoder":
            continue
        if name.startswith("down_mp"):
            plan.append(("down", name, int(name[-1])))
        elif name.startswith("up_mp"):
            plan.append(("up", name, int(name[len("up_mp")])))
        elif name.startswith("mp"):
            plan.append(("mp", name, int(name[2])))
        else:
            raise ValueError(f"Unknown arch key for REMuS plan: {name!r}")
    return plan


def _suffix(l: int) -> str:
    return "" if l == 1 else f"_{l}"


def _group(plan):
    """Consecutive MP layers of one level as one group: ``["mp_group",
    names, level]``; down and up ops as they are."""
    grouped = []
    for op in plan:
        if (op[0] == "mp" and grouped and grouped[-1][0] == "mp_group"
                and grouped[-1][2] == op[2]):
            grouped[-1][1].append(op[1])
        elif op[0] == "mp":
            grouped.append(["mp_group", [op[1]], op[2]])
        else:
            grouped.append(op)
    return grouped


def _encode(layers, graph: Graph, l: int, cd: torch.dtype, inputs=None):
    """Level ``l``'s edge, angle and (l > 1) inter-level angle states.
    ``inputs``: the level's node ``(field, glob, omega)`` rows, by default
    the rows of the fine nodes they came from (``node_origin_{l}``; graph
    parallelism gathers them from its halo table)."""
    s = _suffix(l)
    if inputs is None:
        origin = None if l == 1 else graph.data[f"node_origin_{l}"].long()
        pick = (lambda x: x) if origin is None else (lambda x: x[origin])
        inputs = pick(graph.field), pick(graph.glob), pick(graph.omega)
    f_l, glob_l, omega_l = inputs
    unit = graph.data[f"unit_vec{s}"]
    E, V = unit.shape[0], f_l.shape[0]
    k = E // V

    def rep(x):
        # canonical receivers: the receiver gather is a broadcast
        return x[:, None].expand(V, k, *x.shape[1:]).reshape(E, *x.shape[1:])

    proj = (rep(f_l).reshape(E, -1, 2) * unit[:, None, :]).sum(dim=-1)
    e_in = torch.cat([proj, rep(glob_l), rep(omega_l)], dim=-1)
    enc = "edge_encoder" if l == 1 else f"edge_encoder{l}"
    aenc = "angle_encoder" if l == 1 else f"angle_encoder{l}"
    angles = graph.data[f"angle_attr{s}"]
    e = selu(apply_mlp(layers[enc], e_in, cd))
    a = selu(apply_mlp(layers[aenc], angles.reshape(-1, angles.shape[-1]),
                       cd))
    xa = None
    if l > 1:
        xangles = graph.data[f"xangle_attr_{l}"]
        xa = selu(apply_mlp(layers[f"angle_encoder{l - 1}{l}"],
                            xangles.reshape(-1, xangles.shape[-1]), cd))
    return e, a, xa


def remus_apply(layers, graph: Graph, plan, num_fields: int = 2,
                cd: torch.dtype = torch.float32) -> torch.Tensor:
    """One residual time step of a REMuS-GNN (``cd``: the compute dtype)."""
    e, a, xa = {}, {}, {}
    for l in range(1, graph.num_levels + 1):
        e[l], a[l], xa[l] = _encode(layers, graph, l, cd)
    grouped = _group(plan)
    last_group_of_level = {op[2]: i for i, op in enumerate(grouped)
                           if op[0] == "mp_group"}

    def sort_of(key):
        # loader.attach_angle_sorts' (perm, sorted); without them the
        # backward sorts the sources on the device
        perm, srt = (key.replace("_src", tag) for tag in ("_perm", "_sorted"))
        return (graph.data[perm], graph.data[srt]) if graph.has(perm) else None

    for i, op in enumerate(grouped):
        if op[0] == "mp_group":
            _, names, l = op
            key = f"angle_src{_suffix(l)}"
            angle_src, sort = graph.data[key], sort_of(key)
            for j, name in enumerate(names):
                skip_a = (last_group_of_level[l] == i
                          and j == len(names) - 1)
                e[l], a[l] = edge_mp(layers[name], e[l], a[l], angle_src,
                                     out_selu=True, skip_a_out=skip_a,
                                     angle_sort=sort, cd=cd)
        elif op[0] == "down":
            _, name, tgt = op
            key = f"xangle_src_{tgt}"
            e[tgt] = down_edge_mp(layers[name], e[tgt - 1], e[tgt], xa[tgt],
                                  graph.data[key], out_selu=True,
                                  angle_sort=sort_of(key), cd=cd)
        elif op[0] == "up":
            _, name, src = op
            tgt = src - 1
            st, ss = _suffix(tgt), _suffix(src)
            e[tgt] = selu(up_edge_mp(
                layers[name], e[src], graph.data[f"unit_pinv{ss}"],
                graph.data[f"up_idx_{src}"], graph.data[f"up_w_{src}"],
                graph.data[f"unit_vec{st}"], e[tgt], cd=cd))
    dec = apply_mlp(layers["decoder"], e[1], cd)               # [E1, 1]
    out = edge_scalar_to_node_vector(dec, graph.unit_pinv)     # [V, 1, 2]
    return graph.field[:, -num_fields:] + out.reshape(out.shape[0], -1)


class REMuSGNN(GNN):
    """Rotation-equivariant multi-scale GNN (any REMuS arch dict).  Its
    output is one 2-D vector per node, so ``num_fields`` is 2."""

    NUM_FIELDS = 2

    def build_plan(self, arch: dict):
        return build_remus_plan(arch)

    def forward(self, graph: Graph) -> torch.Tensor:
        return remus_apply(self.layers, graph, self.plan, self.num_fields,
                           self.compute_dtype)

    def prepare_batch(self, batch: Graph) -> Graph:
        """The host sorts of the angle sources, which the backward's
        ``dvs`` sums walk (``loader.attach_angle_sorts``)."""
        from ..loader import attach_angle_sorts
        return attach_angle_sorts(batch)


class NsRotEquiThreeScaleGNN(REMuSGNN):
    """The reference's 3-scale REMuS-GNN with its pretrained table
    (``graphs4cfd_tpu/nn/remus_gnn.py:201-207``)."""
    PRETRAINED = {
        "RE3S-GNN-NsEllipse-v1": "NsREMuSGNN/NsRotEquiThreeScaleGNN.chk",
        "RE3S-GNN-TaylorGreen-TPU-v1":
            "NsREMuSGNN/NsRotEquiThreeScaleGNN_taylor_green_tpu.chk",
    }


# the reference's spelling
NsRotEquiTreeScaleGNN = NsRotEquiThreeScaleGNN
