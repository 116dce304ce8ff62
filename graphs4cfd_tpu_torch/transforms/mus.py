"""MuS grid-cluster coarsening (port of
``graphs4cfd_tpu/transforms/mus.py:35-58``).

Per level ``l`` (2, 3, ...) it stores, per sample:

    parent_{l}    [V_{l-1}]      compacted coarse index of each fine node
    e_rel_{l}     [V_{l-1}, d]   normalised node->cell offsets
    pos_{l}       [V_l, d]       cell centroids
    senders_{l}, receivers_{l}   coarse edges (receiver-sorted, coalesced)
    edge_f2c_{l}  [E_{l-1}]      fine->coarse edge map (-1 = self-loop)
"""
from __future__ import annotations

from typing import List

from ..graph import Graph
from ..ops.coarsen import pool_edge_structure
from ..ops.voxel import grid_clustering


class GridClustering:
    """Build the MuS coarse-level hierarchy (2-4 levels)."""

    def __init__(self, cells_size: List[float]):
        self.num_levels = len(cells_size) + 1
        self.cells_size = cells_size

    def __call__(self, graph: Graph) -> Graph:
        pos = graph.pos
        senders, receivers = graph.senders, graph.receivers
        for i, cell in enumerate(self.cells_size):
            l = i + 2
            pos_c, parent, e_rel = grid_clustering(pos, cell)
            cs, cr, f2c, _ = pool_edge_structure(parent, senders, receivers)
            graph.data[f"parent_{l}"] = parent
            graph.data[f"e_rel_{l}"] = e_rel
            graph.data[f"pos_{l}"] = pos_c
            graph.data[f"senders_{l}"] = cs
            graph.data[f"receivers_{l}"] = cr
            graph.data[f"edge_f2c_{l}"] = f2c
            pos, senders, receivers = pos_c, cs, cr
        graph.num_levels = self.num_levels
        return graph
