"""MuS grid-cluster coarsening (port of
``graphs4cfd_tpu/transforms/mus.py:35-142``).

``GridClustering`` stores, per sample and per level ``l`` (2, 3, ...):

    parent_{l}    [V_{l-1}]      compacted coarse index of each fine node
    e_rel_{l}     [V_{l-1}, d]   normalised node->cell offsets
    pos_{l}       [V_l, d]       cell centroids
    senders_{l}, receivers_{l}   coarse edges (receiver-sorted, coalesced)
    edge_f2c_{l}  [E_{l-1}]      fine->coarse edge map (-1 = self-loop)

``BatchGridClustering`` is the reference's batch-shared clustering, run on
a collated batch (``DataLoader(batch_transform=...)``): one grid for all
samples, so samples share coarse nodes.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from ..graph import Graph
from ..ops.coarsen import pool_edge_structure
from ..ops.voxel import grid_clustering


class GridClustering:
    """Build the MuS coarse-level hierarchy (2-4 levels)."""

    def __init__(self, cells_size: List[float]):
        self.num_levels = len(cells_size) + 1
        self.cells_size = cells_size

    def __call__(self, graph: Graph) -> Graph:
        pos = graph.pos
        senders, receivers = graph.senders, graph.receivers
        for i, cell in enumerate(self.cells_size):
            l = i + 2
            pos_c, parent, e_rel = grid_clustering(pos, cell)
            cs, cr, f2c, _ = pool_edge_structure(parent, senders, receivers)
            graph.data[f"parent_{l}"] = parent
            graph.data[f"e_rel_{l}"] = e_rel
            graph.data[f"pos_{l}"] = pos_c
            graph.data[f"senders_{l}"] = cs
            graph.data[f"receivers_{l}"] = cr
            graph.data[f"edge_f2c_{l}"] = f2c
            pos, senders, receivers = pos_c, cs, cr
        graph.num_levels = self.num_levels
        return graph


class BatchGridClustering:
    """Batch-shared grid clustering of a collated graph: all samples'
    valid nodes on one grid anchored at the batch's position minimum, pad
    rows left out of the clustering and masked.  Coarse levels are padded
    to multiples of ``node_bucket``/``edge_bucket`` with their masks.
    The host sorts of a replaced level's senders (``sender_perm_{l}``,
    ``sender_sorted_{l}``, from ``loader.attach_sender_sorts``) are
    recomputed for the new level where the batch has them."""

    def __init__(self, cells_size: List[float], node_bucket: int = 64,
                 edge_bucket: int = 128):
        self.num_levels = len(cells_size) + 1
        self.cells_size = cells_size
        self.node_bucket = node_bucket
        self.edge_bucket = edge_bucket

    @staticmethod
    def _round_up(n: int, mult: int) -> int:
        return mult * math.ceil(n / mult) if mult > 1 else n

    def __call__(self, graph: Graph) -> Graph:
        if not graph.has("node_mask"):
            raise ValueError("BatchGridClustering is a post-collate (batch) "
                             "transform")
        pos = np.asarray(graph.pos)
        mask = np.asarray(graph.node_mask)
        senders = np.asarray(graph.senders)
        receivers = np.asarray(graph.receivers)
        emask = np.asarray(graph.edge_mask)
        for i, cell in enumerate(self.cells_size):
            l = i + 2
            V = pos.shape[0]
            pos_c, parent_v, e_rel_v = grid_clustering(pos[mask], cell)
            C = pos_c.shape[0]
            Cp = self._round_up(C, self.node_bucket)
            parent = np.zeros(V, np.int32)
            parent[mask] = parent_v
            e_rel = np.zeros((V, pos.shape[1]), np.float32)
            e_rel[mask] = e_rel_v
            # pad and self-loop fine edges drop (edge_f2c = -1); the coarse
            # edge set comes from the valid fine edges only
            cs, cr, f2c, _ = pool_edge_structure(parent, senders, receivers)
            f2c = np.where(emask, f2c, -1)
            keep = f2c >= 0
            pairs = np.stack([cs[f2c[keep]], cr[f2c[keep]]], 1) \
                if keep.any() else np.zeros((0, 2), np.int32)
            uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
            order = np.lexsort((uniq[:, 0], uniq[:, 1]))
            rank = np.empty(len(order), np.int64)
            rank[order] = np.arange(len(order))
            Ec = uniq.shape[0]
            Ep = self._round_up(max(Ec, 1), self.edge_bucket)
            new_f2c = np.full_like(f2c, -1)
            new_f2c[keep] = rank[inv].astype(f2c.dtype)
            cs_p = np.zeros(Ep, np.int32)
            cr_p = np.zeros(Ep, np.int32)
            if Ec:
                cs_p[:Ec] = uniq[order, 0]
                cr_p[:Ec] = uniq[order, 1]
            graph.data[f"parent_{l}"] = parent
            graph.data[f"e_rel_{l}"] = e_rel
            graph.data[f"pos_{l}"] = np.concatenate(
                [pos_c, np.zeros((Cp - C, pos.shape[1]), np.float32)])
            graph.data[f"senders_{l}"] = cs_p
            graph.data[f"receivers_{l}"] = cr_p
            graph.data[f"edge_f2c_{l}"] = new_f2c
            nm = np.zeros(Cp, bool)
            nm[:C] = True
            em = np.zeros(Ep, bool)
            em[:Ec] = True
            graph.data[f"node_mask_{l}"] = nm
            graph.data[f"edge_mask_{l}"] = em
            if graph.has(f"sender_perm_{l}"):
                perm = np.argsort(cs_p, kind="stable")
                graph.data[f"sender_perm_{l}"] = perm.astype(np.int32)
                graph.data[f"sender_sorted_{l}"] = cs_p[perm]
            pos, mask = graph.data[f"pos_{l}"], nm
            senders, receivers, emask = cs_p, cr_p, em
        graph.num_levels = self.num_levels
        return graph
