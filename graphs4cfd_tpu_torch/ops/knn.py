"""Host-side k-nearest-neighbour graph construction.

Port of ``graphs4cfd_tpu/ops/knn.py:51-128``.  ``knn_neighbors`` runs the
port's C++ helper (``graphs4cfd_tpu_torch/native``): a uniform-grid
best-first search above 2000 points of at most 4 coordinates, brute force
below, as the JAX package's helper chooses.  ``knn_neighbors_plain`` is
its numpy version, chunked brute force, which the tests hold the helper
against bit for bit.  Both sum the squared distance one dimension at a
time in float64 (``d += t * t``, no fused multiply-add) and break ties by
index, so points at equal distances (a regular grid) get the JAX
package's neighbours.

Output convention: edges sorted by receiver, exactly ``k`` per receiver,
neighbours ordered by ascending distance (ties by index), so
``senders[v*k + j]`` is the j-th nearest neighbour of node ``v``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

_CHUNK = 2048


def _periodic_lift(pos: np.ndarray, period) -> Tuple[np.ndarray, list]:
    """Lift periodic axes to (cos, sin) pairs so that wrap-around neighbours
    are close in the lifted metric.  Returns the lifted coordinates and the
    resolved per-axis periods (None for non-periodic axes)."""
    dim = pos.shape[1]
    if period is None:
        period = (None,) * dim
    if len(period) != dim:
        raise ValueError(f"period must have {dim} entries")
    cols, resolved = [], []
    for d in range(dim):
        p = period[d]
        if p is None:
            cols.append(pos[:, d:d + 1])
            resolved.append(None)
        else:
            if p == "auto":
                p = float(pos[:, d].max() - pos[:, d].min())
            w = 2.0 * np.pi / p
            cols.append(np.stack([np.cos(w * pos[:, d]),
                                  np.sin(w * pos[:, d])], axis=1))
            resolved.append(float(p))
    return np.concatenate(cols, axis=1).astype(np.float64), resolved


def knn_neighbors(x: np.ndarray, queries: np.ndarray, k: int,
                  exclude_self: bool = False) -> np.ndarray:
    """For each query row, the indices of its k nearest rows of ``x``,
    through the C++ helper.  ``exclude_self`` assumes ``queries is x``
    and removes the zero-distance self match.  Returns int32 ``[Q, k]``
    ordered by ascending distance (ties by index)."""
    from .. import native
    return native.knn_neighbors(x, queries, k, exclude_self)


def knn_neighbors_plain(x: np.ndarray, queries: np.ndarray, k: int,
                        exclude_self: bool = False) -> np.ndarray:
    """``knn_neighbors`` in numpy: chunked brute force over ``[chunk, n]``
    distance arrays, the same bits as the helper."""
    if k < 1 or (k + 1 if exclude_self else k) > np.shape(x)[0]:
        raise ValueError(f"k={k} too large for {np.shape(x)[0]} points")
    x = np.ascontiguousarray(x, dtype=np.float64)
    q = np.ascontiguousarray(queries, dtype=np.float64)
    out = np.empty((q.shape[0], k), dtype=np.int32)
    for s in range(0, q.shape[0], _CHUNK):
        qc = q[s:s + _CHUNK]
        m = qc.shape[0]
        d2 = np.zeros((m, x.shape[0]))
        for d in range(x.shape[1]):
            t = qc[:, d:d + 1] - x[None, :, d]
            d2 += t * t
        if exclude_self:
            d2[np.arange(m), np.arange(s, s + m)] = np.inf
        # every point within the k-th distance, then the first k of them
        # by (distance, index): ties at the k-th distance go by index
        kth = np.partition(d2, k - 1, axis=1)[:, k - 1:k]
        rows, cols = np.nonzero(d2 <= kth)
        order = np.lexsort((cols, d2[rows, cols], rows))
        rows, cols = rows[order], cols[order]
        first = np.searchsorted(rows, np.arange(m))
        out[s:s + m] = cols[first[:, None] + np.arange(k)]
    return out


def connect_knn(pos: np.ndarray, k: int,
                period: Optional[Sequence] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Canonical k-NN graph of a point cloud.

    Returns ``(senders, receivers, edge_attr)``: int32 ``[V*k]``
    receiver-sorted (receiver v owns rows ``[v*k, (v+1)*k)``) and float32
    ``[V*k, dim]`` receiver-minus-sender offsets with periodic wrap-around.
    """
    pos = np.asarray(pos, dtype=np.float32)
    num_nodes, dim = pos.shape
    if dim not in (2, 3):
        raise ValueError(f"Invalid dimension: {dim}, must be 2 or 3.")
    lifted, periods = _periodic_lift(pos, period)
    nbr = knn_neighbors(lifted, lifted, k, exclude_self=True)  # [V, k]
    senders = nbr.reshape(-1).astype(np.int32)
    receivers = np.repeat(np.arange(num_nodes, dtype=np.int32), k)
    edge_attr = pos[receivers] - pos[senders]
    for d, p in enumerate(periods):
        if p is not None:
            col = edge_attr[:, d]
            col = np.where(col < -p / 2.0, col + p, col)
            col = np.where(col > p / 2.0, col - p, col)
            edge_attr[:, d] = col
    return senders, receivers, edge_attr.astype(np.float32)


def cross_knn(pos_src: np.ndarray, pos_query: np.ndarray,
              k: int) -> np.ndarray:
    """The k nearest rows of ``pos_src`` for every row of ``pos_query``,
    int32 ``[Q, k]`` (port of ``graphs4cfd_tpu/ops/knn.py:120-128``)."""
    return knn_neighbors(np.asarray(pos_src, dtype=np.float64),
                         np.asarray(pos_query, dtype=np.float64), k)
