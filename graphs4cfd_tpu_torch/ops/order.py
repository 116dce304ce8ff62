"""Spatial (Morton/Z-order) node ordering: host-side preprocessing.

Copy of ``graphs4cfd_tpu/ops/order.py`` (numpy only).  Renumbering the
point cloud along a Z-order curve before connectivity is built keeps the
senders of a receiver tile close in index space, so the GN-block kernel's
row loads of ``vs[senders]`` stay within a small, cache-resident window.
"""
from __future__ import annotations

import numpy as np


def _part1by1(x: np.ndarray) -> np.ndarray:
    """Spread the low 16 bits of ``x`` so there is a 0 between each."""
    x = x.astype(np.uint32) & np.uint32(0x0000FFFF)
    x = (x | (x << 8)) & np.uint32(0x00FF00FF)
    x = (x | (x << 4)) & np.uint32(0x0F0F0F0F)
    x = (x | (x << 2)) & np.uint32(0x33333333)
    x = (x | (x << 1)) & np.uint32(0x55555555)
    return x


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of ``x`` so there are 2 zeros between each."""
    x = x.astype(np.uint64) & np.uint64(0x3FF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
    return x


def morton_code(pos: np.ndarray) -> np.ndarray:
    """Z-order curve key per point (2-D: 16 bits/axis, 3-D: 10 bits/axis).

    Coordinates are min-max normalised per axis first, so the key depends
    only on relative positions.
    """
    pos = np.asarray(pos, dtype=np.float64)
    lo = pos.min(axis=0)
    span = pos.max(axis=0) - lo
    span[span == 0] = 1.0
    unit = (pos - lo) / span
    if pos.shape[1] == 2:
        q = np.minimum((unit * 65536.0).astype(np.uint32), 65535)
        return (_part1by1(q[:, 0]).astype(np.uint64)
                | (_part1by1(q[:, 1]).astype(np.uint64) << np.uint64(1)))
    elif pos.shape[1] == 3:
        q = np.minimum((unit * 1024.0).astype(np.uint64), 1023)
        return (_part1by2(q[:, 0])
                | (_part1by2(q[:, 1]) << np.uint64(1))
                | (_part1by2(q[:, 2]) << np.uint64(2)))
    raise ValueError(f"pos must be 2-D or 3-D, got {pos.shape[1]} dims")


def spatial_sort_perm(pos: np.ndarray) -> np.ndarray:
    """Permutation that renumbers nodes along the Z-order curve."""
    return np.argsort(morton_code(pos), kind="stable").astype(np.int32)
