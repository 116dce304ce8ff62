"""Edge scaling (port of ``graphs4cfd_tpu/transforms/scale.py:20``)."""
from __future__ import annotations

from ..graph import Graph


class ScaleEdgeAttr:
    """Scale ``edge_attr`` by 1/(2r)."""

    def __init__(self, r: float):
        self.r = r

    def __call__(self, graph: Graph) -> Graph:
        graph.edge_attr = graph.edge_attr / (2.0 * self.r)
        return graph
