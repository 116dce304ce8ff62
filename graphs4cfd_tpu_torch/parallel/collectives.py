"""The collectives of the graph-parallel forward, with their transposes.

Each is a ``torch.autograd.Function`` over an explicit process ``group``,
so a backward through the partitioned forward runs the transposed
collective on every rank, in the same order on every rank (every rank
builds the same graph of operations).  The JAX package gets these
transposes from ``shard_map``; here they are written out:

* ``all_to_all``: equal splits; its transpose is the same exchange.
* ``all_gather``: the tiled gather (the fallback when the partitioner
  dropped a halo table); its transpose gives each rank the sum over ranks
  of its slice of the cotangent (a reduce-scatter).
* ``all_reduce_slice``: the sum over ranks, of which the rank keeps its
  own block of rows (``_scatter_mean``'s reduction); its transpose gives
  each rank's partial sum the whole cotangent (an all-gather).
* ``all_reduce_sum``: the sum over ranks (the loss terms); its transpose
  passes the cotangent through unchanged, so the gradient of the one
  global loss reaches each rank's own terms once.

``all_reduce_grads_`` sums a list of parameter gradients over the ranks
in place, through one flat buffer.

bf16 rows (the bf16 policy's activations, their halo tables and
cotangents) move as bf16.  The two reductions of bf16 rows, the
all-gather's transpose and ``all_reduce_slice``, widen them to f32, sum
and round once, so that a graph-parallel step differs from the
single-device step only in the order of f32 sums.
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                      + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    wide = x.float().contiguous()              # bf16 partials summed in f32
    out = wide.new_empty((x.shape[0] // dist.get_world_size(group),)
                         + x.shape[1:])
    dist.reduce_scatter_tensor(out, wide, group=group)
    return out.to(x.dtype)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.group), None


class _AllReduceSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = x.shape[0] // dist.get_world_size(group)
        r = dist.get_rank(group)
        full = x.float().contiguous().clone()  # bf16 partials summed in f32
        dist.all_reduce(full, group=group)
        return full[r * n:(r + 1) * n].to(x.dtype, copy=True)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Rank ``d``'s block ``o`` of rows goes to rank ``o``'s block ``d``
    (``x`` splits into world-size equal blocks of rows)."""
    return _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order along the rows."""
    return _AllGather.apply(x, group)


def all_reduce_slice(x: torch.Tensor, group=None) -> torch.Tensor:
    """Rank ``r``'s block of rows of the sum over ranks of ``x`` (whose
    rows split into world-size equal blocks)."""
    return _AllReduceSlice.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of ``x``; the cotangent goes back unchanged."""
    return _AllReduceSum.apply(x, group)


def all_reduce_grads_(grads: List[torch.Tensor], group=None) -> None:
    """Sum each gradient over the ranks of ``group`` in place, with one
    all-reduce of their concatenation."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
