"""Host-side uniform-grid clustering for MuS-GNN coarsening.

Copy of ``graphs4cfd_tpu/ops/voxel.py`` (numpy only).  Cell ids follow
torch_cluster's ``grid_cluster`` convention: linear index with the first
axis fastest, grid anchored at ``pos.min(0)``.
"""
from __future__ import annotations

from typing import Tuple, Union, Sequence

import numpy as np


def voxel_grid(pos: np.ndarray, size) -> np.ndarray:
    """Assign each point a linear cell id on a uniform grid.

    ``size`` is a scalar or per-axis sequence.  Matches torch_cluster
    ``grid_cluster``: ``cell_d = floor((pos_d - min_d)/size_d)``,
    ``id = Σ_d cell_d * Π_{d'<d} n_{d'}`` with ``n_d = floor((max_d-min_d)/size_d)+1``.
    """
    pos = np.asarray(pos, dtype=np.float64)
    dim = pos.shape[1]
    size = np.broadcast_to(np.asarray(size, dtype=np.float64), (dim,))
    start = pos.min(axis=0)
    end = pos.max(axis=0)
    num_cells = np.floor((end - start) / size).astype(np.int64) + 1
    cell = np.floor((pos - start) / size).astype(np.int64)
    cell = np.minimum(cell, num_cells - 1)  # guard points exactly at max
    strides = np.concatenate([[1], np.cumprod(num_cells[:-1])])
    return (cell * strides).sum(axis=1)


def grid_clustering(pos: np.ndarray, cell_size
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cluster nodes into grid cells — the MuS-GNN coarsening.

    Mirrors ``grid_clustering`` of the reference but returns the
    compacted form directly:

    * ``pos_coarse``  float32 ``[C, dim]`` — centroid of each non-empty cell,
      ordered by ascending cell id (same order as the reference's
      ``mask_2``-compacted output).
    * ``parent``      int32 ``[V]`` — compacted coarse index of each node
      (the reference's ``idx1_to_idx2`` lookup).
    * ``e_rel``       float32 ``[V, dim]`` — ``(pos_coarse[parent] - pos) / cell_size``,
      the normalised node→cell offset (the reference's ``e_12``).
    """
    pos = np.asarray(pos, dtype=np.float32)
    cluster = voxel_grid(pos, cell_size)
    uniq, parent = np.unique(cluster, return_inverse=True)
    parent = parent.astype(np.int32)
    num_coarse = uniq.shape[0]
    # centroid per non-empty cell
    sums = np.zeros((num_coarse, pos.shape[1]), dtype=np.float64)
    np.add.at(sums, parent, pos)
    counts = np.bincount(parent, minlength=num_coarse).astype(np.float64)
    pos_coarse = (sums / counts[:, None]).astype(np.float32)
    e_rel = (pos_coarse[parent] - pos) / np.asarray(cell_size, dtype=np.float32)
    return pos_coarse, parent, e_rel.astype(np.float32)
