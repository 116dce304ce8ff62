"""Segment reductions on torch tensors.

Port of ``graphs4cfd_tpu/ops/segment.py:29-103``.  Semantics match
torch_scatter: empty segments give 0 for both ``sum`` and ``mean``.

Determinism: every sum adds its rows in the same order on every run
(``_index_sum``).  On CUDA that is ``index_put_(accumulate=True)``, which
stable-sorts the indices and adds each segment's rows in their original
order, where ``index_add_`` and ``scatter_add_`` use float atomics.  On
the CPU it is ``index_add_``, which walks the rows in order, where
``index_put_(accumulate=True)`` adds across threads in no fixed order: its
last bits then change from run to run, and a SELU input that lands on the
other side of 0 changes a gradient by O(1).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build


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


def _index_sum(out: torch.Tensor, index: torch.Tensor,
               src: torch.Tensor) -> torch.Tensor:
    """``out[index[i]] += src[i]`` in place, in a fixed order."""
    if out.device.type == "cpu":
        return out.index_add_(0, index, src)
    return out.index_put_((index,), src, accumulate=True)


def segment_sum(src: torch.Tensor, index: torch.Tensor, num_segments: int,
                *, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum ``src`` rows into ``num_segments`` buckets given by ``index``.

    Rows where ``mask`` (bool ``[E]``) is False contribute nothing.
    """
    out = src.new_zeros((num_segments,) + src.shape[1:])
    if num_segments == 0:
        return out
    src, index = _route(src, index, num_segments, mask)
    return _index_sum(out, index, src)


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


def sorted_segment_sum_plain(src: torch.Tensor, perm: torch.Tensor,
                             sorted_index: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """``out[n] = sum of src[perm[j]] over the j with sorted_index[j] == n``
    in plain PyTorch (``sorted_index = index[perm]`` is sorted)."""
    out = src.new_zeros((num_segments,) + src.shape[1:])
    return _index_sum(out, sorted_index.long(), src[perm.long()])


def sorted_segment_sum(src: torch.Tensor, perm: torch.Tensor,
                       sorted_index: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Sum the rows of ``src`` per segment, walking each segment's rows in
    the order ``perm`` gives them: the plain version for a CPU tensor, the
    CUDA kernel ``csrc/sorted_segment_sum.cu`` for a CUDA tensor (a
    binary-search pass finds each segment's run in ``sorted_index``, then
    one block of 8 warps sums each segment; no atomics, the same bits on
    every run).

    This is the transpose of the sender gather: the kernel's half of the
    ``dvs`` accumulation in ``pallas_gnblock.py:_make_bwd_kernel_wg`` and
    of ``segment.py:gather_sorted_bwd`` in the JAX package."""
    if src.device.type == "cpu":
        return sorted_segment_sum_plain(src, perm, sorted_index,
                                        num_segments)
    if src.device.type != "cuda":
        raise ValueError(f"sorted_segment_sum: unsupported device "
                         f"{src.device}")
    return _launch(src, perm, sorted_index, num_segments)


def _launch(src, perm, sorted_index, num_segments):
    rows = src.shape[0]
    if src.dim() != 2 or tuple(perm.shape) != (rows,) or \
            tuple(sorted_index.shape) != (rows,):
        raise ValueError(f"sorted_segment_sum takes src [rows, F] and perm, "
                         f"sorted_index [rows]; got {tuple(src.shape)}, "
                         f"{tuple(perm.shape)}, {tuple(sorted_index.shape)}")
    for t, want in ((src, torch.float32), (perm, torch.int32),
                    (sorted_index, torch.int32)):
        if t.device != src.device or t.dtype != want or \
                not t.is_contiguous():
            raise ValueError(f"sorted_segment_sum takes contiguous {want} "
                             f"on {src.device}; got {t.dtype} on "
                             f"{t.device}")
    out = torch.empty(num_segments, src.shape[1], device=src.device,
                      dtype=torch.float32)
    if num_segments == 0:
        return out
    lib = _build.load()
    offsets = torch.empty(num_segments + 1, device=src.device,
                          dtype=torch.int64)
    with torch.cuda.device(src.device):
        err = lib.g4c_sorted_segment_sum(
            src.data_ptr(), perm.data_ptr(), sorted_index.data_ptr(), rows,
            src.shape[1], num_segments, offsets.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err)
    sorted_segment_sum.launches += 1
    return out


#: kernel launches since the count was last set to 0
sorted_segment_sum.launches = 0


class _GatherSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index, perm, sorted_index):
        ctx.save_for_backward(perm, sorted_index)
        ctx.num_rows = x.shape[0]
        return x[index.long()]

    @staticmethod
    def backward(ctx, grad):
        perm, sorted_index = ctx.saved_tensors
        dx = sorted_segment_sum(grad.contiguous(), perm, sorted_index,
                                ctx.num_rows)
        return dx, None, None, None


def gather_sorted(x: torch.Tensor, index: torch.Tensor, perm: torch.Tensor,
                  sorted_index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` whose backward sums the cotangent rows per source row in
    sorted order (port of ``segment.py:gather_sorted_bwd``): ``perm`` sorts
    ``index`` stably and ``sorted_index = index[perm]``, as
    ``transforms.ConnectKNN`` and ``loader.collate`` attach them for the
    level-1 senders.  Plain advanced indexing would go back through
    ``index_put_``; ``index_select`` through ``index_add_``, whose float
    atomics change the sums' order from run to run on CUDA."""
    return _GatherSorted.apply(x, index, perm, sorted_index)
