"""Host-side graph-construction and augmentation transforms (numpy and the
C++ helper of ``graphs4cfd_tpu_torch.native``), with the names and
re-exports of ``graphs4cfd_tpu/transforms/__init__.py``."""
from .connect import ConnectKNN
from .mus import GridClustering, BatchGridClustering
from .mugs import GuillardCoarseningAndConnectKNN
from .remus import ExtendGraph, BuildRemusGraph
from .interpolate import (BuildKnnInterpWeights, InterpolateNodes,
                          InterpolateNodesToXml, interpolate_nodes)
from .scale import ScaleEdgeAttr, ScaleNs, scale_edges
from .noise import AddUniformNoise
from .geometric import (RandomGraphRotation, GraphRotation, RandomGraphFlip,
                        rotate_graph, flip_graph_dim)
from .subset import NodeSubset, RandomNodeSubset
from .order import SpatialSort

__all__ = [
    "ConnectKNN", "GridClustering", "BatchGridClustering",
    "GuillardCoarseningAndConnectKNN", "ExtendGraph", "BuildRemusGraph",
    "BuildKnnInterpWeights", "InterpolateNodes", "InterpolateNodesToXml",
    "interpolate_nodes", "ScaleEdgeAttr", "ScaleNs", "scale_edges",
    "AddUniformNoise", "RandomGraphRotation", "GraphRotation",
    "RandomGraphFlip", "rotate_graph", "flip_graph_dim", "NodeSubset",
    "RandomNodeSubset", "SpatialSort",
]
