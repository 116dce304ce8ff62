"""Level-to-level k-NN interpolation weights (numpy).

Port of ``BuildKnnInterpWeights``
(``graphs4cfd_tpu/transforms/interpolate.py:26-44``).  Per level ``l >= 2``:

    up_idx_{l}  [V_{l-1}, k]  level-l neighbours of each level-(l-1) node
    up_w_{l}    [V_{l-1}, k]  their 1/d² weights

read by REMuS unpooling (``nn.blocks.up_edge_mp``) and the gMuS up step
(``nn.mugs_gnn``).
"""
from __future__ import annotations

import numpy as np

from ..graph import Graph
from ..ops.interp import knn_interp_weights


class BuildKnnInterpWeights:
    """Up-sampling indices and weights for each consecutive level pair."""

    def __init__(self, k: int):
        self.k = k

    def __call__(self, graph: Graph) -> Graph:
        level = 2
        pos_prev = np.asarray(graph.pos, dtype=np.float32)
        while graph.has(f"pos_{level}"):
            pos_l = np.asarray(graph.data[f"pos_{level}"], dtype=np.float32)
            idx, w = knn_interp_weights(pos_l, pos_prev, self.k)
            graph.data[f"up_idx_{level}"] = idx
            graph.data[f"up_w_{level}"] = w
            pos_prev = pos_l
            level += 1
        graph.interp_k = self.k
        return graph
