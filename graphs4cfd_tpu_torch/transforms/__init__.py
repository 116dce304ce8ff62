"""Host-side graph-construction transforms (numpy), for the MuS slice."""
from .order import SpatialSort
from .connect import ConnectKNN
from .scale import ScaleEdgeAttr
from .mus import GridClustering

__all__ = ["SpatialSort", "ConnectKNN", "ScaleEdgeAttr", "GridClustering"]
