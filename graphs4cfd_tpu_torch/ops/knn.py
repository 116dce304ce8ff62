"""Host-side k-nearest-neighbour graph construction (numpy).

Port of ``graphs4cfd_tpu/ops/knn.py:51-128``: the exact chunked brute-force
path only (the C++ helper of the JAX package waits for a later slice).

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
    """For each query row, the indices of its k nearest rows of ``x``.

    Chunked brute force (exact).  ``exclude_self`` assumes ``queries is x``
    and removes the zero-distance self match.  Returns int32 ``[Q, k]``
    ordered by ascending distance (ties by index).
    """
    n = x.shape[0]
    kk = k + 1 if exclude_self else k
    if kk > n:
        raise ValueError(f"k={k} too large for {n} points")
    x = np.ascontiguousarray(x, dtype=np.float64)
    q = np.ascontiguousarray(queries, dtype=np.float64)
    out = np.empty((q.shape[0], k), dtype=np.int32)
    x_sq = (x * x).sum(axis=1)
    for s in range(0, q.shape[0], _CHUNK):
        qc = q[s:s + _CHUNK]
        d2 = x_sq[None, :] - 2.0 * qc @ x.T          # [chunk, n]
        d2 += (qc * qc).sum(axis=1)[:, None]
        if exclude_self:
            rows = np.arange(s, s + qc.shape[0])
            d2[np.arange(qc.shape[0]), rows] = np.inf
        # partial top-k, then a stable sort by (distance, index)
        part = np.argpartition(d2, k - 1, axis=1)[:, :k]
        pd = np.take_along_axis(d2, part, axis=1)
        order = np.lexsort((part, pd), axis=1)
        out[s:s + qc.shape[0]] = np.take_along_axis(part, order, axis=1)
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
