"""Feature scaling (port of ``graphs4cfd_tpu/transforms/scale.py:15-60``):
``scale_edges``, ``ScaleEdgeAttr`` and ``ScaleNs``."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..graph import Graph


def scale_edges(e, r: float):
    """Edge vectors scaled by 1/(2r)."""
    return e / (2.0 * r)


class ScaleEdgeAttr:
    """Scale ``edge_attr`` by 1/(2r)."""

    def __init__(self, r: float):
        self.r = r

    def __call__(self, graph: Graph) -> Graph:
        graph.edge_attr = graph.edge_attr / (2.0 * self.r)
        return graph


class ScaleNs:
    """Min-max normalise the u/v(/p) slices of ``field`` and ``target``
    and ``glob`` (Re): ``x <- (x - (a+b)/2) / ((b-a)/2)`` for each
    ``scaling[key] = (a, b)``; ``format`` is ``"uvp"`` or ``"uv"``."""

    def __init__(self, scaling: Dict[str, Tuple[float, float]], format: str):
        if format not in ("uvp", "uv"):
            raise ValueError(f"Unknown format {format}, must be 'uvp' or "
                             f"'uv'")
        mk = lambda key: ((0.5 * (scaling[key][0] + scaling[key][1]),
                           0.5 * abs(scaling[key][1] - scaling[key][0]))
                          if key in scaling else None)
        self.u, self.v, self.Re = mk("u"), mk("v"), mk("Re")
        self.p = mk("p") if format == "uvp" else None
        self.num_fields = 3 if format == "uvp" else 2

    def _scale_strided(self, arr: np.ndarray, offset: int, cd) -> np.ndarray:
        arr = np.array(arr, copy=True)
        arr[:, offset::self.num_fields] = \
            (arr[:, offset::self.num_fields] - cd[0]) / cd[1]
        return arr

    def __call__(self, graph: Graph) -> Graph:
        for offset, cd in ((0, self.u), (1, self.v), (2, self.p)):
            if cd is None or offset >= self.num_fields:
                continue
            graph.field = self._scale_strided(graph.field, offset, cd)
            if graph.has("target"):
                graph.target = self._scale_strided(graph.target, offset, cd)
        if self.Re is not None and graph.has("glob"):
            graph.glob = (graph.glob - self.Re[0]) / self.Re[1]
        return graph
