"""Triangulation-based field plotting (port of ``graphs4cfd_tpu/plot.py``).

Boundary-masked triangulations, small-triangle masks, scatter plots,
gouraud ``field`` rendering and the 3-column truth/prediction/|error|
rollout panels ``compare_fields``, with the JAX module's functions and
signatures.  Inputs may be numpy arrays or tensors on any device, f32 or
bf16: each is detached, moved to the host and, if bf16, widened to f32
before numpy sees it.  matplotlib is imported inside the functions, so
importing this module needs no matplotlib; a call without it raises
``ModuleNotFoundError``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def triang_boundary_mask(pos, bound, boundary_idx=None):
    """Triangulation with triangles inside masked boundaries removed."""
    import matplotlib.tri as tri
    if boundary_idx is None:
        boundary_idx = 4
    pos, bound = _np(pos), _np(bound)
    triang = tri.Triangulation(pos[:, 0], pos[:, 1])
    on_vertices = bound[triang.triangles]        # [num_tri, 3]
    if isinstance(boundary_idx, int):
        mask = (on_vertices == boundary_idx).all(axis=1)
    else:
        mask = (on_vertices == boundary_idx[0]).all(axis=1)
        for idx in boundary_idx[1:]:
            mask = mask | (on_vertices == idx).all(axis=1)
    triang.set_mask(mask)
    return triang


def triang_small_tri_mask(pos, tri_ratio: float,
                          box: Optional[List[float]] = None):
    """Triangulation with large (hole-spanning) triangles masked out.

    Keeps triangles with area ≤ ``tri_ratio`` × mean area (the reference
    masks ``A > limit``, i.e. *removes* the large sliver triangles that
    triangulate across holes)."""
    import matplotlib.tri as tri
    pos = _np(pos)
    triang = tri.Triangulation(pos[:, 0], pos[:, 1])
    x = triang.x[triang.triangles]
    y = triang.y[triang.triangles]
    if box is not None:
        box_mask = ((x.max(axis=1) > box[0]) & (x.min(axis=1) < box[1])
                    & (y.max(axis=1) > box[2]) & (y.min(axis=1) < box[3]))
    a = np.linalg.norm([x[:, 1] - x[:, 0], y[:, 1] - y[:, 0]], axis=0)
    b = np.linalg.norm([x[:, 2] - x[:, 1], y[:, 2] - y[:, 1]], axis=0)
    c = np.linalg.norm([x[:, 0] - x[:, 2], y[:, 0] - y[:, 2]], axis=0)
    s = (a + b + c) / 2
    area = np.sqrt(np.maximum(s * (s - a) * (s - b) * (s - c), 0))
    limit = area.mean() * tri_ratio
    mask = (area > limit) & box_mask if box is not None else (area > limit)
    triang.set_mask(mask)
    return triang


def _triangulation(pos, bound, boundary_idx, tri_ratio, box):
    import matplotlib.tri as tri
    if bound is not None:
        return triang_boundary_mask(pos, bound, boundary_idx=boundary_idx)
    if tri_ratio is not None:
        return triang_small_tri_mask(pos, tri_ratio, box=box)
    return tri.Triangulation(_np(pos)[:, 0], _np(pos)[:, 1])


def pos(pos, s: float = 0.1, file: Optional[str] = None,
        fontsize: int = 13, show: bool = True):
    """Scatter node positions (2-D or 3-D)."""
    import matplotlib.pyplot as plt
    p = _np(pos)
    fig = plt.figure()
    if p.shape[1] == 2:
        ax = fig.add_subplot(111)
        ax.scatter(p[:, 0], p[:, 1], color="black", s=s)
        ax.set_aspect("equal")
        ax.set_xlabel("x", fontsize=fontsize)
        ax.set_ylabel("y", fontsize=fontsize)
    else:
        ax = fig.add_subplot(projection="3d")
        ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=s, color="k")
    if file is not None:
        fig.savefig(file)
    if show:
        plt.show()
    plt.close()


def pos_field(pos, u, s: float = 0.1, cmap: str = "coolwarm",
              file: Optional[str] = None, fontsize: int = 13,
              vmin=None, vmax=None, show: bool = True):
    """Scatter plot coloured by a scalar field."""
    import matplotlib.pyplot as plt
    p, u = _np(pos), _np(u)
    assert u.ndim == 1, "u must be a 1D array."
    assert p.shape[0] == u.shape[0], \
        "pos and u must have the same number of nodes."
    fig = plt.figure()
    if p.shape[1] == 2:
        ax = fig.add_subplot(111)
        im = ax.scatter(p[:, 0], p[:, 1], c=u, cmap=cmap, s=s,
                        vmin=vmin, vmax=vmax)
        ax.set_aspect("equal")
    else:
        ax = fig.add_subplot(projection="3d")
        im = ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=s, c=u, cmap=cmap,
                        vmin=vmin, vmax=vmax)
    cax = fig.add_axes([ax.get_position().x1 + 0.1, ax.get_position().y0,
                        0.02, ax.get_position().height])
    plt.colorbar(im, cax=cax)
    cax.yaxis.set_tick_params(labelsize=fontsize)
    if file:
        fig.savefig(file)
    if show:
        plt.show()
    plt.close()


def field(pos, u, vmin=None, vmax=None, cmap: str = "coolwarm",
          file: Optional[str] = None, fontsize: int = 13, bound=None,
          boundary_idx=None, tri_ratio: Optional[float] = None,
          box: Optional[List[float]] = None, show: bool = True):
    """Gouraud-shaded tripcolor rendering of a nodal field."""
    import matplotlib.pyplot as plt
    p, u = _np(pos), _np(u)
    assert u.ndim == 1, "u must be a 1D array."
    assert p.shape[0] == u.shape[0], \
        "pos and u must have the same number of nodes."
    fig = plt.figure()
    ax = fig.add_subplot(111)
    triang = _triangulation(p, bound, boundary_idx, tri_ratio, box)
    im = ax.tripcolor(triang, u, vmin=vmin, vmax=vmax, cmap=cmap,
                      shading="gouraud")
    ax.set_aspect("equal")
    cax = fig.add_axes([ax.get_position().x1 + 0.01, ax.get_position().y0,
                        0.02, ax.get_position().height])
    plt.colorbar(im, cax=cax)
    cax.yaxis.set_tick_params(labelsize=fontsize)
    ax.set_xticks([]), ax.set_yticks([])
    ax.set_xlim([p[:, 0].min(), p[:, 0].max()])
    ax.set_ylim([p[:, 1].min(), p[:, 1].max()])
    if file:
        fig.savefig(file, bbox_inches="tight")
    if show:
        plt.show()
    plt.close()


def compare_fields(pos, u1, u2, bound=None, boundary_idx=None,
                   tri_ratio: Optional[float] = None,
                   box: Optional[List[float]] = None,
                   figsize: Tuple[float, float] = (5, 5),
                   vmin=None, vmax=None, cmap: str = "coolwarm",
                   file: Optional[str] = None, fontsize: int = 13,
                   show: bool = True):
    """Rollout comparison panels: ground truth | prediction | |error|,
    one row per frame (``plot.py:233-319``)."""
    import matplotlib.pyplot as plt
    p, u1, u2 = _np(pos), _np(u1), _np(u2)
    assert u1.shape[0] == u2.shape[0], \
        "u1 and u2 must have the same number of nodes."
    assert u1.shape[1] == u2.shape[1], \
        "u1 and u2 must have the same number of frames."
    nrows = u1.shape[1]
    er = np.abs(u2 - u1)
    if vmin is None:
        vmin = u1.min()
    if vmax is None:
        vmax = u1.max()
    fig, ax = plt.subplots(nrows, 3, figsize=(3 * figsize[0],
                                              figsize[1] * nrows),
                           squeeze=False)
    triang = _triangulation(p, bound, boundary_idx, tri_ratio, box)
    for row in range(nrows):
        im0 = ax[row, 0].tripcolor(triang, u1[:, row], vmin=vmin, vmax=vmax,
                                   cmap=cmap, shading="gouraud")
        ax[row, 1].tripcolor(triang, u2[:, row], vmin=vmin, vmax=vmax,
                             cmap=cmap, shading="gouraud")
        im2 = ax[row, 2].tripcolor(triang, er[:, row], vmin=er.min(),
                                   vmax=er.max(), cmap="binary",
                                   shading="gouraud")
        for col in range(3):
            ax[row, col].set_aspect("equal")
        ax[row, 1].set_title(f"t = {row + 1}dt", fontsize=fontsize)
    cax0 = fig.add_axes([ax[0, 0].get_position().x0 - 0.05,
                         ax[0, 0].get_position().y0, 0.01,
                         ax[0, 0].get_position().height])
    plt.colorbar(im0, cax=cax0)
    cax0.yaxis.set_ticks_position("left")
    cax1 = fig.add_axes([ax[0, 2].get_position().x1 + 0.01,
                         ax[0, 2].get_position().y0, 0.01,
                         ax[0, 2].get_position().height])
    plt.colorbar(im2, cax=cax1)
    if file:
        fig.savefig(file)
    if show:
        plt.show()
    plt.close()
