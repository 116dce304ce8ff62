"""Interpolation transforms (numpy): level-to-level k-NN weights and
re-meshing.

Port of ``graphs4cfd_tpu/transforms/interpolate.py:26-108``.
``BuildKnnInterpWeights`` stores, per level ``l >= 2``:

    up_idx_{l}  [V_{l-1}, k]  level-l neighbours of each level-(l-1) node
    up_w_{l}    [V_{l-1}, k]  their 1/d² weights

read by REMuS unpooling (``nn.blocks.up_edge_mp``) and the gMuS up step
(``nn.mugs_gnn``).  ``interpolate_nodes`` (``InterpolateNodes``,
``InterpolateNodesToXml``) moves a point cloud's fields onto other nodes
with scipy's ``griddata``, as offline preprocessing.
"""
from __future__ import annotations

import os
import random
from typing import Optional, Union
from xml.etree import ElementTree

import numpy as np

from ..graph import Graph
from ..ops.interp import knn_interp_weights


class BuildKnnInterpWeights:
    """Up-sampling indices and weights for each consecutive level pair."""

    def __init__(self, k: int):
        self.k = k

    def __call__(self, graph: Graph) -> Graph:
        level = 2
        pos_prev = np.asarray(graph.pos, dtype=np.float32)
        while graph.has(f"pos_{level}"):
            pos_l = np.asarray(graph.data[f"pos_{level}"], dtype=np.float32)
            idx, w = knn_interp_weights(pos_l, pos_prev, self.k)
            graph.data[f"up_idx_{level}"] = idx
            graph.data[f"up_w_{level}"] = w
            pos_prev = pos_l
            level += 1
        graph.interp_k = self.k
        return graph


def interpolate_nodes(graph: Graph, pos: np.ndarray,
                      method: Optional[str] = None) -> Graph:
    """Move a point cloud's fields onto the nodes ``pos`` (scipy
    ``griddata``: cubic in 2-D, linear in 3-D, unless ``method`` is
    given); ``omega`` and ``bound`` interpolate linearly and are rounded.
    Graphs with edges raise."""
    from scipy.interpolate import griddata
    if graph.has("senders"):
        raise ValueError("Graphs cannot be interpolated, only sets of nodes.")
    old_pos = np.asarray(graph.pos)
    dim = pos.shape[1]
    if method is None:
        method = "cubic" if dim == 2 else "linear"
    interp = lambda vals, m: griddata(old_pos, np.asarray(vals), pos,
                                      method=m).astype(np.float32)
    if graph.has("loc"):
        graph.loc = interp(graph.loc, method)
    if graph.has("glob"):
        graph.glob = interp(graph.glob, method)
    graph.field = interp(graph.field, method)
    if graph.has("target"):
        graph.target = interp(graph.target, method)
    omega = interp(graph.omega, "linear")
    graph.omega = (omega >= 0.9).astype(np.float32)
    graph.bound = np.round(
        griddata(old_pos, np.asarray(graph.bound, dtype=np.float64), pos,
                 method="linear")).astype(np.uint8)
    graph.pos = pos.astype(np.float32)
    return graph


class InterpolateNodes:
    """``interpolate_nodes`` onto fixed nodes ``pos``."""

    def __init__(self, pos: np.ndarray):
        self.pos = np.asarray(pos, dtype=np.float32)

    def __call__(self, graph: Graph) -> Graph:
        return interpolate_nodes(graph, self.pos)


class InterpolateNodesToXml:
    """``interpolate_nodes`` onto the vertices of a NekMesh ``.xml`` mesh,
    or of a random choice (Python's ``random``) among ``num_meshes``
    drawn from a ``*_xml`` folder's meshes."""

    def __init__(self, xml_file: str, num_meshes: Union[int, str] = "all"):
        if isinstance(num_meshes, str) and num_meshes != "all":
            raise ValueError("num_meshes must be an int or 'all'")
        if xml_file.endswith(".xml"):
            self.xml_files = [xml_file]
        elif xml_file.endswith("_xml"):
            self.xml_files = [os.path.join(xml_file, f)
                              for f in sorted(os.listdir(xml_file))]
            if num_meshes == "all":
                num_meshes = len(self.xml_files)
            self.xml_files = random.choices(self.xml_files, k=num_meshes)

    def __call__(self, graph: Graph) -> Graph:
        dom = ElementTree.parse(random.choice(self.xml_files))
        verts = dom.findall("GEOMETRY/VERTEX/V")
        dim = np.asarray(graph.pos).shape[1]
        pos = np.array([list(map(float, v.text.split()[:dim]))
                        for v in verts], dtype=np.float32)
        return interpolate_nodes(graph, pos)
