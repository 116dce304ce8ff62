"""k-NN connectivity (port of ``graphs4cfd_tpu/transforms/connect.py:15``).

Emits the canonical receiver-sorted exact-k layout and records ``fixed_k``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..graph import Graph
from ..ops.knn import connect_knn


class ConnectKNN:
    """Connect nodes to their k nearest neighbours (exact indegree k).

    ``period``: per-axis domain period (None / value / "auto").
    """

    def __init__(self, k: int, period: Optional[Sequence] = None):
        self.k = k
        self.period = period

    def __call__(self, graph: Graph) -> Graph:
        s, r, attr = connect_knn(graph.pos, self.k, period=self.period)
        graph.senders = s
        graph.receivers = r
        graph.edge_attr = attr
        graph.fixed_k = self.k
        # sender-sorted permutation, kept for the deterministic backward
        # of the sender gather in the training slice
        perm = np.argsort(s, kind="stable").astype(np.int32)
        graph.sender_perm = perm
        graph.sender_sorted = s[perm]
        return graph
