"""gMuS-GNN graph build: a k-NN graph per level, Guillard coarsening
between levels (numpy).

Port of ``GuillardCoarseningAndConnectKNN``
(``graphs4cfd_tpu/transforms/mugs.py:26-76``).  Coarse levels are kept in
local numbering.  Per level ``l >= 2``:

    down_idx_{l}     [V_l]   index of each level-l node in level l-1
    node_origin_{l}  [V_l]   index of each level-l node in level 1
    senders_{l}, receivers_{l}, edge_attr_{l}   the level's own k-NN graph
    pos_{l}          [V_l, 2]
    fixed_k_{l}      ``k[l - 1]``

The output is byte-equal to the JAX package's.  The sender sorts that the
backward's ``dvs`` sums walk are added after ``collate``
(``loader.attach_sender_sorts``), not here.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..graph import Graph
from ..ops.coarsen import guillard_coarsening
from ..ops.knn import connect_knn


class GuillardCoarseningAndConnectKNN:
    """The level-1 k-NN graph plus 1-3 Guillard-coarsened levels; edge
    attributes of level ``l`` scaled by ``1 / (2 scale_edge_attr[l-1])``."""

    def __init__(self, k: List[int], period: Optional[Sequence] = None,
                 scale_edge_attr: Optional[Sequence] = None):
        if not 1 < len(k) < 5:
            raise ValueError("the number of levels in gMuS-GNN must be "
                             "between 2 and 4")
        self.k = k
        self.period = period
        self.scale_edge_attr = scale_edge_attr

    def _scale(self, attr: np.ndarray, i: int) -> np.ndarray:
        if (self.scale_edge_attr is not None
                and self.scale_edge_attr[i] is not None):
            return attr / (2.0 * self.scale_edge_attr[i])
        return attr

    def __call__(self, graph: Graph) -> Graph:
        pos = np.asarray(graph.pos, dtype=np.float32)
        s, r, attr = connect_knn(pos, self.k[0], period=self.period)
        graph.senders, graph.receivers = s, r
        graph.edge_attr = self._scale(attr, 0)
        graph.fixed_k = self.k[0]
        pos_prev = pos
        origin_prev = np.arange(pos.shape[0], dtype=np.int32)
        s_prev, k_prev = s, self.k[0]
        for i in range(1, len(self.k)):
            l = i + 1
            mask = guillard_coarsening(s_prev, pos_prev.shape[0], k_prev)
            down_idx = np.nonzero(mask)[0].astype(np.int32)
            pos_l = pos_prev[down_idx]
            s_l, r_l, attr_l = connect_knn(pos_l, self.k[i],
                                           period=self.period)
            graph.data[f"down_idx_{l}"] = down_idx
            graph.data[f"node_origin_{l}"] = origin_prev[down_idx]
            graph.data[f"senders_{l}"] = s_l
            graph.data[f"receivers_{l}"] = r_l
            graph.data[f"edge_attr_{l}"] = self._scale(attr_l, i)
            graph.data[f"pos_{l}"] = pos_l
            graph.data[f"fixed_k_{l}"] = self.k[i]
            pos_prev, origin_prev = pos_l, origin_prev[down_idx]
            s_prev, k_prev = s_l, self.k[i]
        graph.num_levels = len(self.k)
        return graph
