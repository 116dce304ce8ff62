"""Autoregressive rollout (port of ``graphs4cfd_tpu/training/rollout.py``).

A Python loop over time steps: each prediction is fed back through the
rolled field window.  Runs under ``torch.inference_mode``: no gradient is
taken, so the kernels run without their backward.  Under the bf16 policy
(``model.compute_dtype``) each step runs in bf16 and returns the f32
field plus its bf16 increment, so the fed-back window stays f32.
"""
from __future__ import annotations

import torch

from ..graph import Graph


@torch.inference_mode()
def solve(model, graph, n_out: int) -> torch.Tensor:
    """Evaluate ``model`` on ``graph`` for ``n_out`` time steps; returns
    ``[V, num_fields * n_out]``, step by step.  The graph is not changed.
    A list or tuple of graphs is collated on the host first and moved to
    the device of the model's parameters
    (``graphs4cfd_tpu/training/rollout.py:40-42``)."""
    if n_out <= 0:
        raise ValueError("n_out must be greater than 0.")
    if isinstance(graph, (list, tuple)):
        from ..loader import collate
        graph = Graph.from_numpy(collate([g.numpy() for g in graph]),
                                 next(model.parameters()).device)
    nf = model.num_fields
    field = graph.field
    preds = []
    for _ in range(n_out):
        pred = model(graph.replace(field=field))
        field = torch.cat([field[:, nf:], pred], dim=1)
        preds.append(pred)
    return torch.cat(preds, dim=1)
