"""Evaluation metrics (port of ``graphs4cfd_tpu/metrics.py``), numpy.

``r2`` keeps the reference's exact-mean element masking quirk: elements
equal to the target's mean are left out of both sums.
"""
from __future__ import annotations

import numpy as np


def _numpy(x):
    if hasattr(x, "detach"):          # a torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def r2(pred, target) -> float:
    """Coefficient of determination between ``pred`` and ``target``
    (1-D time point or 2-D rollout)."""
    pred, target = _numpy(pred), _numpy(target)
    if pred.ndim not in (1, 2):
        raise RuntimeError()
    mean = target.mean()
    mask = target != mean
    res = float(((target[mask] - pred[mask]) ** 2).sum())
    tot = float(((target[mask] - mean) ** 2).sum())
    return 1.0 - res / tot


def rollout_rmse(pred, target, node_mask=None) -> float:
    """Root-mean-square error of a rollout ``[V, num_fields * T]`` over the
    rows ``node_mask`` keeps."""
    pred, target = _numpy(pred), _numpy(target)
    if node_mask is not None:
        node_mask = _numpy(node_mask)
        pred, target = pred[node_mask], target[node_mask]
    return float(np.sqrt(((pred - target) ** 2).mean()))
