"""Host-side graph-construction transforms (numpy), for the MuS, REMuS and
gMuS slices."""
from .order import SpatialSort
from .connect import ConnectKNN
from .scale import ScaleEdgeAttr
from .mus import GridClustering
from .remus import BuildRemusGraph, ExtendGraph
from .interpolate import BuildKnnInterpWeights
from .mugs import GuillardCoarseningAndConnectKNN

__all__ = ["SpatialSort", "ConnectKNN", "ScaleEdgeAttr", "GridClustering",
           "BuildRemusGraph", "ExtendGraph", "BuildKnnInterpWeights",
           "GuillardCoarseningAndConnectKNN"]
