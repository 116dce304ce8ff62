"""Closed-form pseudo-inverses of ``[..., k, 2]`` stacks.

Port of ``graphs4cfd_tpu/ops/linalg.py``: the matrices of REMuS-GNN's
projections always have two columns (edge unit vectors in 2-D), so
``pinv(A) = (AᵀA)⁻¹Aᵀ`` with a 2×2 inverse.  ``pinv_k2_np`` (numpy) works
in float64 and rounds to float32 once; the host pipeline computes every
pinverse the rollout reads with it.  ``pinv_k2`` (torch, on the tensor's
device, differentiable) is the device version, for users' own code and
``nn.blocks.lstsq``.
"""
from __future__ import annotations

import numpy as np
import torch


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


def pinv_k2(a: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse of a ``[..., k, 2]`` stack -> ``[..., 2, k]`` f32, on
    ``a``'s device: f32 normal equations, then one Newton–Schulz step
    (``X <- 2X - XAX``), which squares the rounding error of the Gram
    inverse (``graphs4cfd_tpu/ops/linalg.py:32-47``)."""
    a = a.float()
    at = a.transpose(-1, -2)
    g = at @ a
    det = g[..., 0, 0] * g[..., 1, 1] - g[..., 0, 1] * g[..., 1, 0]
    adj = torch.stack([
        torch.stack([g[..., 1, 1], -g[..., 0, 1]], dim=-1),
        torch.stack([-g[..., 1, 0], g[..., 0, 0]], dim=-1)], dim=-2)
    inv = adj / det.clamp_min(1e-30)[..., None, None]
    x = inv @ at
    return 2.0 * x - x @ a @ x
