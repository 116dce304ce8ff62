"""Spatial node reordering (port of ``graphs4cfd_tpu/transforms/order.py``).

``SpatialSort`` renumbers the point cloud along a Morton curve before
connectivity is built.  It permutes only point-cloud attributes and
refuses graphs that already carry topology.
"""
from __future__ import annotations

import numpy as np

from ..graph import Graph
from ..ops.order import spatial_sort_perm

_NODE_KEYS = ("pos", "field", "omega", "target", "bound", "loc", "glob")


class SpatialSort:
    def __call__(self, graph: Graph) -> Graph:
        if graph.has("senders"):
            raise ValueError("SpatialSort must be applied before "
                             "connectivity transforms")
        perm = spatial_sort_perm(np.asarray(graph.pos))
        for key in _NODE_KEYS:
            if graph.has(key):
                graph.data[key] = np.asarray(graph.data[key])[perm]
        return graph
