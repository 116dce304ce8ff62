"""REMuS-GNN graph build: levels, unit vectors, angles and pinverses (numpy).

Port of ``ExtendGraph`` and ``BuildRemusGraph``
(``graphs4cfd_tpu/transforms/remus.py:33-119``), in local level numbering
and the fixed-k layout of ``ops.angles``.  Per level ``l`` (suffix ``""``
for level 1, ``"_l"`` above):

    unit_vec{_l}    [E_l, 2]     edge unit vectors
    unit_pinv{_l}   [V_l, 2, k]  pinverse of each node's incoming unit vectors
    angle_src{_l}   [E_l, k]     sender edges of each edge's k angles
    angle_attr{_l}  [E_l, k, 4]  [|e_in|, |e_out|, cos, sin]
    xangle_src_{l}  [E_l, k]     inter-level angles into level l (level-(l-1)
                                 edge ids); xangle_attr_{l} [E_l, k, 4]
    down_idx_{l}, node_origin_{l}, senders_{l}, receivers_{l},
    edge_attr_{l}, pos_{l}, fixed_k_{l}

The JAX package's ``wg_pref`` (a TPU gather window's size) has no
counterpart: the CUDA kernel loads angle-source rows by index.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..graph import Graph
from ..ops.angles import extend_graph, inter_level_angles
from ..ops.coarsen import guillard_coarsening
from ..ops.knn import connect_knn
from ..ops.linalg import pinv_k2_np


class ExtendGraph:
    """Unit vectors, angles and pinverses of a single-level k-NN graph."""

    def __call__(self, graph: Graph) -> Graph:
        k = graph.fixed_k
        unit, angle_src, angle_attr = extend_graph(graph.senders,
                                                   graph.edge_attr, k)
        graph.unit_vec = unit
        graph.angle_src = angle_src
        graph.angle_attr = angle_attr
        num_nodes = np.asarray(graph.pos).shape[0]
        graph.unit_pinv = pinv_k2_np(unit.reshape(num_nodes, k, 2))
        return graph


class BuildRemusGraph:
    """The multi-level REMuS graph: k-NN per level, Guillard coarsening
    between levels, edge lengths scaled by ``1 / (2 scale_edge_length[l])``."""

    def __init__(self, num_levels: int, k: int,
                 period: Optional[Sequence] = None,
                 scale_edge_length: Optional[Sequence] = None):
        self.num_levels = num_levels
        self.k = k
        self.period = period
        self.scale_edge_length = scale_edge_length

    def _scale(self, attr: np.ndarray, i: int) -> np.ndarray:
        if (self.scale_edge_length is not None
                and self.scale_edge_length[i] is not None):
            return attr / (2.0 * self.scale_edge_length[i])
        return attr

    def __call__(self, graph: Graph) -> Graph:
        k = self.k
        pos = np.asarray(graph.pos, dtype=np.float32)
        s, r, attr = connect_knn(pos, k, period=self.period)
        attr = self._scale(attr, 0)
        graph.senders, graph.receivers, graph.edge_attr = s, r, attr
        graph.fixed_k = k
        levels = [{"pos": pos, "senders": s, "receivers": r, "attr": attr,
                   "origin": np.arange(pos.shape[0], dtype=np.int32)}]
        for i in range(1, self.num_levels):
            prev = levels[-1]
            mask = guillard_coarsening(prev["senders"],
                                       prev["pos"].shape[0], k)
            down_idx = np.nonzero(mask)[0].astype(np.int32)
            pos_l = prev["pos"][down_idx]
            s_l, r_l, attr_l = connect_knn(pos_l, k, period=self.period)
            levels.append({"pos": pos_l, "senders": s_l, "receivers": r_l,
                           "attr": self._scale(attr_l, i),
                           "origin": prev["origin"][down_idx],
                           "down_idx": down_idx})
        for i, lv in enumerate(levels):
            suf = "" if i == 0 else f"_{i + 1}"
            unit, angle_src, angle_attr = extend_graph(lv["senders"],
                                                       lv["attr"], k)
            graph.data[f"unit_vec{suf}"] = unit
            graph.data[f"angle_src{suf}"] = angle_src
            graph.data[f"angle_attr{suf}"] = angle_attr
            graph.data[f"unit_pinv{suf}"] = pinv_k2_np(
                unit.reshape(lv["pos"].shape[0], k, 2))
            if i > 0:
                l = i + 1
                graph.data[f"down_idx_{l}"] = lv["down_idx"]
                graph.data[f"node_origin_{l}"] = lv["origin"]
                graph.data[f"senders_{l}"] = lv["senders"]
                graph.data[f"receivers_{l}"] = lv["receivers"]
                graph.data[f"edge_attr_{l}"] = lv["attr"]
                graph.data[f"pos_{l}"] = lv["pos"]
                graph.data[f"fixed_k_{l}"] = k
                xsrc, xattr = inter_level_angles(
                    levels[i - 1]["attr"], lv["senders"], lv["attr"],
                    lv["down_idx"], k)
                graph.data[f"xangle_src_{l}"] = xsrc
                graph.data[f"xangle_attr_{l}"] = xattr
        graph.num_levels = self.num_levels
        return graph
