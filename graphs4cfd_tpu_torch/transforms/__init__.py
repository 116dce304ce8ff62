"""Host-side graph-construction transforms (numpy), for the MuS and REMuS
slices."""
from .order import SpatialSort
from .connect import ConnectKNN
from .scale import ScaleEdgeAttr
from .mus import GridClustering
from .remus import BuildRemusGraph, ExtendGraph
from .interpolate import BuildKnnInterpWeights

__all__ = ["SpatialSort", "ConnectKNN", "ScaleEdgeAttr", "GridClustering",
           "BuildRemusGraph", "ExtendGraph", "BuildKnnInterpWeights"]
