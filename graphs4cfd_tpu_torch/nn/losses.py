"""Training loss (port of ``graphs4cfd_tpu/nn/losses.py``).

``GraphLoss``: MSE plus an optional L1 penalty on the Dirichlet-boundary
nodes (``omega[:, 0] == 1``), over the valid rows only (``node_mask``):
padding rows carry values that must not enter the sums.  ``local_terms``
gives the numerators and denominators as one vector so that a sum of the
terms over ranks gives the exact global loss (``distributed``).

The loss and its counts are f32 whatever the model's compute dtype: a
step's prediction is ``field + decoder(...)``, the f32 field plus a bf16
output under the bf16 policy, which type promotion makes f32 (as in
``graphs4cfd_tpu/nn/losses.py:31-50``); a bf16 ``pred`` or ``target`` is
widened to f32 here, so no sum runs in bf16.
"""
from __future__ import annotations

import torch

from ..ops.fused_mlp import widen


class GraphLoss:
    """loss = MSE(pred, target) + lambda_d * L1(pred, target) on omega == 1."""

    def __init__(self, lambda_d: float = 0.0):
        self.lambda_d = lambda_d

    def local_terms(self, graph, pred: torch.Tensor,
                    target: torch.Tensor) -> torch.Tensor:
        """``[sq_sum, valid_count, l1_sum, dirichlet_count]`` over the
        local rows."""
        pred, target = widen(pred), widen(target)
        mask = graph.get("node_mask")
        if mask is None:
            mask = torch.ones(pred.shape[0], dtype=torch.bool,
                              device=pred.device)
        nf = pred.shape[1]
        diff = pred - target
        sq_sum = torch.where(mask[:, None], diff * diff, 0.0).sum()
        cnt = (mask.sum() * nf).to(pred.dtype)
        if self.lambda_d > 0:
            dirichlet = (graph.omega[:, 0] == 1) & mask
            l1_sum = torch.where(dirichlet[:, None], diff.abs(), 0.0).sum()
            dcnt = (dirichlet.sum() * nf).to(pred.dtype)
        else:
            l1_sum = dcnt = pred.new_zeros(())
        return torch.stack([sq_sum, cnt, l1_sum, dcnt])

    def from_terms(self, t: torch.Tensor) -> torch.Tensor:
        loss = t[0] / t[1].clamp_min(1.0)
        if self.lambda_d > 0:
            loss = loss + self.lambda_d * t[2] / t[3].clamp_min(1.0)
        return loss

    def distributed(self, graph, pred: torch.Tensor, target: torch.Tensor,
                    group=None) -> torch.Tensor:
        """The exact loss of the whole graph, on every rank of ``group``
        (graph parallel): each rank's ``local_terms`` summed by one
        all-reduce, then ``from_terms``.  The all-reduce passes the
        cotangent back unchanged, so the gradient of the one global loss
        reaches each rank's own terms once (the counts carry none); the
        caller then sums the parameter gradients over the ranks
        (``parallel.graph_parallel.gp_loss_and_grads``)."""
        from ..parallel.collectives import all_reduce_sum
        return self.from_terms(all_reduce_sum(
            self.local_terms(graph, pred, target), group))

    def __call__(self, graph, pred: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
        return self.from_terms(self.local_terms(graph, pred, target))
