"""Geometric augmentation: rotations and axis flips.

Port of ``graphs4cfd_tpu/transforms/geometric.py:57-158``.  On a REMuS
graph (``angle_src`` present) edge and angle attributes do not change
under a rotation: only positions, the unit vectors of every level (their
pinverses recomputed by ``ops.linalg.pinv_k2_np``) and the velocity
fields rotate, and a flip raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..graph import Graph
from ..ops.linalg import pinv_k2_np


def _validate_eq(eq, format):
    if eq is not None:
        eq = eq.lower()
        if eq == "ns":
            if format is None:
                raise ValueError("format must be specified for NS equations")
            if format not in ("uvp", "uv"):
                raise ValueError(f"Unknown format {format}, must be 'uvp' "
                                 f"or 'uv'")
        elif eq != "adv":
            raise ValueError(f"Unknown equation type {eq}, must be 'ns' or "
                             f"'adv'")


def _rotation_matrix(theta, dim):
    """Rows ``[[cos, sin], [-sin, cos]]`` in 2-D (``new = x @ R``); the
    three-angle rotation in 3-D; float32."""
    theta = np.deg2rad(theta)
    if dim == 2:
        c, s = np.cos(theta), np.sin(theta)
        return np.array([[c, s], [-s, c]], dtype=np.float32)
    t0, t1, t2 = theta
    return np.array([
        [np.cos(t0) * np.cos(t1),
         np.cos(t0) * np.sin(t1) * np.sin(t2) - np.sin(t0) * np.cos(t2),
         np.cos(t0) * np.sin(t1) * np.cos(t2) + np.sin(t0) * np.sin(t2)],
        [np.sin(t0) * np.cos(t1),
         np.sin(t0) * np.sin(t1) * np.sin(t2) + np.cos(t0) * np.cos(t2),
         np.sin(t0) * np.sin(t1) * np.cos(t2) - np.cos(t0) * np.sin(t2)],
        [-np.sin(t1), np.cos(t1) * np.sin(t2), np.cos(t1) * np.cos(t2)],
    ], dtype=np.float32)


def _rot(R, x):
    # new_j = sum_i R[i, j] x_i
    return np.asarray(x, dtype=np.float32) @ R


def rotate_graph(graph: Graph, theta, eq: Optional[str] = None,
                 format: Optional[str] = None) -> Graph:
    """Rotate ``graph`` in place by ``theta`` degrees (three angles in
    3-D): positions, edge vectors (or a REMuS graph's unit vectors and
    pinverses), ``loc`` for ``eq="adv"``, the velocity pairs of ``field``
    and ``target`` for ``eq="ns"``."""
    _validate_eq(eq, format)
    dim = np.asarray(graph.pos).shape[1]
    R = _rotation_matrix(theta, dim)
    graph.pos = _rot(R, graph.pos)
    if graph.has("angle_src"):
        for suffix in ("", "_2", "_3", "_4"):
            uv_key = f"unit_vec{suffix}"
            if graph.has(uv_key):
                uv = _rot(R, graph.data[uv_key])
                graph.data[uv_key] = uv
                pinv_key = f"unit_pinv{suffix}"
                if graph.has(pinv_key):
                    k = graph.data[pinv_key].shape[2]
                    graph.data[pinv_key] = pinv_k2_np(uv.reshape(-1, k, 2))
    else:
        for key in ("edge_attr", "edge_attr_2", "edge_attr_3", "edge_attr_4"):
            if graph.has(key):
                graph.data[key] = _rot(R, graph.data[key])
    if eq == "adv":
        graph.loc = _rot(R, graph.loc)
    elif eq == "ns":
        stride = 3 if format == "uvp" else 2
        for key in ("field", "target"):
            if not graph.has(key):
                continue
            arr = np.array(graph.data[key], copy=True)
            for idx in range(0, arr.shape[1], stride):
                arr[:, idx:idx + 2] = _rot(R, arr[:, idx:idx + 2])
            graph.data[key] = arr
    return graph


class RandomGraphRotation:
    """Rotate by an angle drawn from U[0, 360) (three in 3-D), from one
    ``numpy.random.default_rng(seed)`` per transform."""

    def __init__(self, eq: Optional[str] = None, format: Optional[str] = None,
                 seed: Optional[int] = None):
        self.eq, self.format = eq, format
        self._rng = np.random.default_rng(seed)

    def __call__(self, graph: Graph) -> Graph:
        dim = np.asarray(graph.pos).shape[1]
        theta = (self._rng.uniform(0, 360) if dim == 2
                 else self._rng.uniform(0, 360, size=(3,)))
        return rotate_graph(graph, theta, eq=self.eq, format=self.format)


class GraphRotation:
    """Rotate by the fixed angle ``theta`` (degrees)."""

    def __init__(self, theta, eq: Optional[str] = None,
                 format: Optional[str] = None):
        self.theta, self.eq, self.format = theta, eq, format

    def __call__(self, graph: Graph) -> Graph:
        return rotate_graph(graph, self.theta, eq=self.eq, format=self.format)


def flip_graph_dim(graph: Graph, dim: int, eq: Optional[str] = None,
                   format: Optional[str] = None) -> Graph:
    """Mirror ``graph`` in place along axis ``dim``: positions, ``loc``,
    edge vectors and, for ``eq="ns"``, that velocity component of
    ``field`` and ``target``."""
    _validate_eq(eq, format)
    max_dim = np.asarray(graph.pos).shape[1]
    if dim >= max_dim:
        raise ValueError(f"Dimension {dim} is greater than the maximum "
                         f"dimension of the graph ({max_dim})")
    if graph.has("angle_src"):
        raise ValueError("Flipping graphs with angle indices is not supported")

    def flip_col(key, col, stride=None):
        if not graph.has(key):
            return
        arr = np.array(graph.data[key], copy=True)
        if stride is None:
            arr[:, col] = -arr[:, col]
        else:
            arr[:, col::stride] = -arr[:, col::stride]
        graph.data[key] = arr

    flip_col("pos", dim)
    flip_col("loc", dim)
    for key in ("edge_attr", "edge_attr_2", "edge_attr_3", "edge_attr_4"):
        flip_col(key, dim)
    if eq and eq.lower() == "ns":
        stride = 3 if format == "uvp" else 2
        flip_col("field", dim, stride)
        flip_col("target", dim, stride)
    return graph


class RandomGraphFlip:
    """Flip each enabled axis with probability 1/2, from one
    ``numpy.random.default_rng(seed)`` per transform."""

    def __init__(self, x_flip: bool = True, y_flip: bool = True,
                 z_flip: bool = True, eq: Optional[str] = None,
                 format: Optional[str] = None, seed: Optional[int] = None):
        self.flip = (x_flip, y_flip, z_flip)
        self.eq, self.format = eq, format
        self._rng = np.random.default_rng(seed)

    def __call__(self, graph: Graph) -> Graph:
        dim = np.asarray(graph.pos).shape[1]
        for axis, flag in enumerate(self.flip[:dim]):
            if flag and self._rng.integers(2):
                graph = flip_graph_dim(graph, axis, eq=self.eq,
                                       format=self.format)
        return graph
