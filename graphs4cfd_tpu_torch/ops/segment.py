"""Segment reductions on torch tensors.

Port of ``graphs4cfd_tpu/ops/segment.py:29-103``.  Semantics match
torch_scatter: empty segments give 0 for both ``sum`` and ``mean``.

Determinism: no ``index_add_`` and no ``scatter_add_``, whose float
atomics on CUDA change the order of each sum from run to run.  The sums
use ``index_put_(accumulate=True)``, which on CUDA stable-sorts the indices
and adds each segment's rows in their original order, so every run gives
the same bits.  (On the CPU PyTorch may split a sum across threads.)
"""
from __future__ import annotations

from typing import Optional

import torch


def _route(src: torch.Tensor, index: torch.Tensor, num_segments: int,
           mask: Optional[torch.Tensor]):
    """``(src, int64 index)`` with the rows where ``mask`` is False zeroed
    and spread over all segments (their index may be -1).  Piling them on
    one segment would make the per-segment sums walk them one by one: at
    the first pooling level most fine edges are dropped self-loops."""
    index = index.long()
    if mask is None:
        return src, index
    spread = torch.arange(index.shape[0], device=index.device) % num_segments
    keep = mask.reshape((-1,) + (1,) * (src.dim() - 1))
    return torch.where(keep, src, 0), torch.where(mask, index, spread)


def segment_sum(src: torch.Tensor, index: torch.Tensor, num_segments: int,
                *, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum ``src`` rows into ``num_segments`` buckets given by ``index``.

    Rows where ``mask`` (bool ``[E]``) is False contribute nothing.
    """
    out = src.new_zeros((num_segments,) + src.shape[1:])
    if num_segments == 0:
        return out
    src, index = _route(src, index, num_segments, mask)
    return out.index_put_((index,), src, accumulate=True)


def segment_mean(src: torch.Tensor, index: torch.Tensor, num_segments: int,
                 *, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of ``src`` rows per segment (sum / count, count clamped to 1)."""
    ones = src.new_ones(src.shape[0])
    count = segment_sum(ones, index, num_segments, mask=mask)
    total = segment_sum(src, index, num_segments, mask=mask)
    return total / count.clamp_min(1).reshape((-1,) + (1,) * (src.dim() - 1))


def aggregate_fixed_k(edge_feats: torch.Tensor, k: int,
                      num_nodes: int) -> torch.Tensor:
    """Mean over the k edges of each receiver in the canonical layout
    (receiver ``v`` owns rows ``[v*k, (v+1)*k)``): ``[V*k, F] -> [V, F]``."""
    if edge_feats.shape[0] != k * num_nodes:
        raise ValueError(f"fixed-k layout mismatch: {edge_feats.shape[0]} "
                         f"!= {k}*{num_nodes}")
    return edge_feats.reshape(num_nodes, k, -1).mean(dim=1)
