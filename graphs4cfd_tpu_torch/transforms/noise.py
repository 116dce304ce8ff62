"""Training noise (port of ``graphs4cfd_tpu/transforms/noise.py:16``):
``field += eps * U[-1, 1]``, per sample in the host pipeline."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..graph import Graph


class AddUniformNoise:
    """Add ``eps * U[-1, 1]`` noise to ``field``, drawn from one
    ``numpy.random.default_rng(seed)`` per transform."""

    def __init__(self, eps: float, seed: Optional[int] = None):
        self.eps = eps
        self._rng = np.random.default_rng(seed)

    def __call__(self, graph: Graph) -> Graph:
        field = np.asarray(graph.field)
        noise = self.eps * (2.0 * self._rng.random(field.shape,
                                                   dtype=np.float32) - 1.0)
        graph.field = field + noise
        return graph
