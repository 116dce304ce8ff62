"""k-NN inverse-square-distance interpolation between graph levels.

Port of ``graphs4cfd_tpu/ops/interp.py:19-43``: the weights are built on
the host (numpy) in the fixed-k layout ``[Q, k]``, so the device side is a
gather and a weighted mean over a static k axis, with no scatter.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .knn import cross_knn
from .segment import take_rows


def knn_interp_weights(pos_src: np.ndarray, pos_query: np.ndarray, k: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Neighbour indices and weights for interpolating ``pos_src`` values
    onto ``pos_query``: ``(idx [Q, k] int32, w [Q, k] float32)``, with
    ``w = 1 / max(d², 1e-16)``."""
    idx = cross_knn(pos_src, pos_query, k)
    diff = np.asarray(pos_src, dtype=np.float32)[idx] \
        - np.asarray(pos_query, dtype=np.float32)[:, None, :]
    d2 = (diff * diff).sum(axis=-1)
    weights = 1.0 / np.maximum(d2, 1e-16)
    return idx.astype(np.int32), weights.astype(np.float32)


def knn_interpolate(x: torch.Tensor, idx: torch.Tensor,
                    weights: torch.Tensor, take=take_rows) -> torch.Tensor:
    """``y[q] = sum_j w[q, j] x[idx[q, j]] / sum_j w[q, j]``.  ``take(x,
    idx)`` is the gather ``x[idx]``, whose backward adds in a fixed order:
    ``segment.take_rows``, or in graph parallelism a gather from the
    rank's halo table through ``ops.gather.gather_rows`` and its host
    sort."""
    w = weights[..., None]
    return (take(x, idx) * w).sum(dim=1) / w.sum(dim=1)
