"""Closed-form pseudo-inverses of ``[..., k, 2]`` stacks (numpy).

Port of ``pinv_k2_np`` (``graphs4cfd_tpu/ops/linalg.py:17-29``): the
matrices of REMuS-GNN's projections always have two columns (edge unit
vectors in 2-D), so ``pinv(A) = (AᵀA)⁻¹Aᵀ`` with a 2×2 inverse, in float64
and rounded to float32 once.  The host pipeline computes every pinverse
the rollout reads.
"""
from __future__ import annotations

import numpy as np


def pinv_k2_np(a: np.ndarray) -> np.ndarray:
    """Pseudo-inverse of a ``[..., k, 2]`` stack -> ``[..., 2, k]`` f32."""
    a = np.asarray(a, dtype=np.float64)
    at = np.swapaxes(a, -1, -2)                    # [..., 2, k]
    g = at @ a                                     # [..., 2, 2]
    det = g[..., 0, 0] * g[..., 1, 1] - g[..., 0, 1] * g[..., 1, 0]
    inv = np.empty_like(g)
    inv[..., 0, 0] = g[..., 1, 1]
    inv[..., 1, 1] = g[..., 0, 0]
    inv[..., 0, 1] = -g[..., 0, 1]
    inv[..., 1, 0] = -g[..., 1, 0]
    inv = inv / np.maximum(det, 1e-30)[..., None, None]
    return (inv @ at).astype(np.float32)
