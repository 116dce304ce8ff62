"""Node subsets of a point cloud, before connectivity (port of
``graphs4cfd_tpu/transforms/subset.py:24-45``)."""
from __future__ import annotations

from typing import Iterable, Optional, Union

import numpy as np

from ..graph import Graph

_NODE_KEYS = ("pos", "field", "omega", "target", "bound", "loc", "glob")


def _subset(graph: Graph, idx) -> Graph:
    for key in _NODE_KEYS:
        if graph.has(key):
            graph.data[key] = np.asarray(graph.data[key])[idx]
    return graph


class NodeSubset:
    """Keep the nodes ``idx``, in that order."""

    def __init__(self, idx: Iterable[int]):
        self.idx = np.asarray(list(idx))

    def __call__(self, graph: Graph) -> Graph:
        return _subset(graph, self.idx)


class RandomNodeSubset:
    """Keep a random subset: a fraction of the nodes if ``num_nodes`` is a
    float, that many if it is an int."""

    def __init__(self, num_nodes: Union[float, int],
                 seed: Optional[int] = None):
        self.num_nodes = num_nodes
        self._rng = np.random.default_rng(seed)

    def __call__(self, graph: Graph) -> Graph:
        total = np.asarray(graph.pos).shape[0]
        count = (int(self.num_nodes * total)
                 if isinstance(self.num_nodes, float) else int(self.num_nodes))
        idx = self._rng.choice(total, size=count, replace=False)
        return _subset(graph, idx)
