"""Data parallelism over the ranks of a process group.

Port of ``graphs4cfd_tpu/parallel/dp.py``.  Each rank holds the same
parameters and runs its own shard of a ``loader.collate_sharded`` batch
(``loader.shard_of``, then ``model.prepare_batch``) through the model's
ordinary forward, so the kernels launch as they do on one device.  The
steps keep the per-rollout-step semantics of ``training.make_train_step``:

* a criterion with ``distributed`` (``GraphLoss``) gives the exact loss of
  the whole batch on every rank: one all-reduce of the per-rank sums;
  its transpose hands each rank's terms the cotangent unchanged, so each
  rank's backward yields its partial gradient, and one all-reduce sums
  them into the gradient of the whole batch (the JAX package's ``pmean``
  at ``dp.py:71-80`` compensates for how ``shard_map`` transposes a
  ``psum``; here the sum is the right reduction);
* any other criterion averages the per-shard losses over the ranks
  (``dp.py:77-80``): the mean's transpose gives each rank its loss's
  gradient over the rank count, and the same sum of the gradients makes
  their mean;
* then the trainer's norm, clip and Adam step (``clip_and_update_``), on
  the same bits on every rank, so the parameters stay the same bits.

``shard_map``, ``jit`` and ``scan`` have no counterpart: every rank runs
the same Python over its shard.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..graph import Graph
from ..training.rollout import solve
from ..training.trainer import clip_and_update_
from .collectives import all_reduce_grads_, all_reduce_sum


def _loss_fn(criterion, group):
    """``loss(graph, pred, target)`` over the whole batch: the exact global
    loss, or the mean of the ranks' losses for a criterion without
    ``distributed``."""
    if getattr(criterion, "distributed", None) is not None:
        return lambda g, pred, tgt: criterion.distributed(g, pred, tgt,
                                                          group)
    world = dist.get_world_size(group)
    return lambda g, pred, tgt: all_reduce_sum(criterion(g, pred, tgt),
                                               group) / world


def dp_loss_and_grads(model, criterion, graph: Graph, target: torch.Tensor,
                      group=None):
    """``(loss, prediction, gradients)`` of one time step of this rank's
    shard: the loss of the whole batch (the same on every rank) and every
    parameter's gradient of it, reduced over the ranks of ``group`` (the
    same on every rank)."""
    pred = model(graph)
    loss = _loss_fn(criterion, group)(graph, pred, target)
    grads = list(torch.autograd.grad(loss, list(model.parameters())))
    all_reduce_grads_(grads, group)
    return loss, pred, grads


def make_dp_train_step(model, criterion, n_out: int,
                       grad_clip_limit: Optional[float] = None, group=None):
    """``train_step(state, shard, lr, clip_on=True) -> (mean loss, mean
    gradient norm)``: ``training.make_train_step`` on this rank's shard of
    the batch; every rank of ``group`` calls it with its own shard, from
    the same parameters and Adam state.  Per rollout step: the loss of
    the whole batch, the gradients reduced over the ranks by one
    all-reduce, then the norm, clip and Adam step in place."""
    params = list(model.parameters())
    nf = model.num_fields

    def train_step(state, graph: Graph, lr: float, clip_on: bool = True):
        target = graph.target
        field = graph.field
        losses, gnorms = [], []
        for t in range(n_out):
            loss, pred, grads = dp_loss_and_grads(
                model, criterion, graph.replace(field=field),
                target[:, t * nf:(t + 1) * nf], group)
            gnorms.append(clip_and_update_(params, grads, state, lr,
                                           grad_clip_limit, clip_on))
            field = torch.cat([field[:, nf:], pred.detach()], dim=1)
            losses.append(loss.detach())
        return torch.stack(losses).mean(), torch.stack(gnorms).mean()
    return train_step


def make_dp_val_step(model, criterion, max_n_out: int, group=None):
    """``val_step(shard) -> mean loss`` of a ``max_n_out``-step rollout
    of every rank's shard (``training.make_val_step``), the loss of the
    whole batch at each step, the same on every rank."""
    loss_fn = _loss_fn(criterion, group)
    nf = model.num_fields

    @torch.no_grad()
    def val_step(graph: Graph):
        target = graph.target
        field = graph.field
        losses = []
        for t in range(max_n_out):
            g = graph.replace(field=field)
            pred = model(g)
            losses.append(loss_fn(g, pred, target[:, t * nf:(t + 1) * nf]))
            field = torch.cat([field[:, nf:], pred], dim=1)
        return torch.stack(losses).mean()
    return val_step


def make_dp_rollout(model, n_out: int):
    """``rollout(shard) -> [V_shard, num_fields * n_out]``: each rank
    rolls its own shard out (``training.rollout.solve``); no rank waits
    for another.  ``dp.py:150``'s output stacks the shards' rows on a
    leading axis: here each rank keeps its own."""
    if n_out <= 0:
        raise ValueError("n_out must be greater than 0.")
    return lambda graph: solve(model, graph, n_out)
