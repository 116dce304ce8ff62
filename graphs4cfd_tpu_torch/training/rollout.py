"""Autoregressive rollout (port of ``graphs4cfd_tpu/training/rollout.py``).

A Python loop over time steps: each prediction is fed back through the
rolled field window.  Runs under ``torch.inference_mode``: no gradient is
taken, so the kernels run without their backward.
"""
from __future__ import annotations

import torch

from ..graph import Graph


@torch.inference_mode()
def solve(model, graph: Graph, n_out: int) -> torch.Tensor:
    """Evaluate ``model`` on ``graph`` for ``n_out`` time steps; returns
    ``[V, num_fields * n_out]``, step by step.  The graph is not changed."""
    if n_out <= 0:
        raise ValueError("n_out must be greater than 0.")
    nf = model.num_fields
    field = graph.field
    preds = []
    for _ in range(n_out):
        pred = model(graph.replace(field=field))
        field = torch.cat([field[:, nf:], pred], dim=1)
        preds.append(pred)
    return torch.cat(preds, dim=1)
