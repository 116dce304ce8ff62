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

from types import SimpleNamespace
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
    return edge_feats.reshape((num_nodes, k) + edge_feats.shape[1:]).mean(
        dim=1)


#: L of ``csrc/sorted_segment_sum.cu`` (at least 8, its tile blocks' rows
#: per warp): a segment of more rows than this is not walked by one warp;
#: the kernel's tile blocks sum it, 8 rows to a warp.  Measured at 16, 32,
#: 64 and 128 (``profile_torch_step.py --segment-cases``): 16 is slower at
#: the MuS ``dvs``, and from 64 up one warp walks the 55-row runs of a
#: halo transpose.
LONG_ROWS = 32


def sorted_segment_sum_plain(src: torch.Tensor, perm: torch.Tensor,
                             sorted_index: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """``out[n] = sum of src[perm[j]] over the j with sorted_index[j] == n``
    in plain PyTorch (``sorted_index = index[perm]`` is sorted).  bf16
    rows are added in f32 into an f32 ``out``."""
    rows = src[perm.long()]
    if rows.dtype == torch.bfloat16:
        rows = rows.float()
    out = rows.new_zeros((num_segments,) + src.shape[1:])
    return _index_sum(out, sorted_index.long(), rows)


def sorted_segment_sum(src: torch.Tensor, perm: torch.Tensor,
                       sorted_index: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Sum the rows of ``src`` per segment, walking each segment's rows in
    the order ``perm`` gives them: the plain version for a CPU tensor, the
    CUDA kernel ``csrc/sorted_segment_sum.cu`` for a CUDA tensor.

    A first pass finds each segment's run in ``sorted_index`` (a thread
    per position, where the index changes); then each segment gets one
    warp, which adds its rows in sorted order from 0, as the plain version
    does on CUDA (so its bits), and an empty segment's warp writes zeros.
    A segment of more than ``LONG_ROWS`` rows (a padded batch's pile of
    pad rows) is summed by the kernel's tile blocks instead, 8 rows to a
    warp and 64 to a block, whose partials are added in a fixed order.
    No float atomics: the same bits on every run.

    This is the transpose of the sender gather: the kernel's half of the
    ``dvs`` accumulation in ``pallas_gnblock.py:_make_bwd_kernel_wg`` and
    of ``segment.py:gather_sorted_bwd`` in the JAX package.

    bf16 rows (the bf16 policy's sender cotangents) are added in f32, in
    the same order, into an f32 ``out``, as the JAX kernels add bf16
    cotangent rows into an f32 table (``pallas_gather.py:184,193``); their
    launches count in ``sorted_segment_sum.bf16``."""
    if src.device.type == "cpu":
        return sorted_segment_sum_plain(src, perm, sorted_index,
                                        num_segments)
    if src.device.type != "cuda":
        raise ValueError(f"sorted_segment_sum: unsupported device "
                         f"{src.device}")
    return _launch(src, perm, sorted_index, num_segments)


def _launch(src, perm, sorted_index, num_segments, long_rows=None,
            events=None):
    """The kernel; ``long_rows`` in the place of ``LONG_ROWS``; with
    ``events`` (two CUDA events) one is recorded after each of its two
    launches (the bounds pass, the sums)."""
    rows = src.shape[0]
    if src.dim() != 2 or tuple(perm.shape) != (rows,) or \
            tuple(sorted_index.shape) != (rows,):
        raise ValueError(f"sorted_segment_sum takes src [rows, F] and perm, "
                         f"sorted_index [rows]; got {tuple(src.shape)}, "
                         f"{tuple(perm.shape)}, {tuple(sorted_index.shape)}")
    if src.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"sorted_segment_sum takes float32 or bfloat16 "
                         f"rows, got {src.dtype}")
    for t, want in ((src, src.dtype), (perm, torch.int32),
                    (sorted_index, torch.int32)):
        if t.device != src.device or t.dtype != want or \
                not t.is_contiguous():
            raise ValueError(f"sorted_segment_sum takes contiguous {want} "
                             f"on {src.device}; got {t.dtype} on "
                             f"{t.device}")
    bf = int(src.dtype == torch.bfloat16)
    out = torch.empty(num_segments, src.shape[1], device=src.device,
                      dtype=torch.float32)
    if num_segments == 0:
        return out
    lib = _build.load()
    long_rows = LONG_ROWS if long_rows is None else long_rows
    F = src.shape[1]
    work = torch.empty(lib.g4c_sorted_segment_sum_work(rows, F,
                                                       num_segments),
                       device=src.device, dtype=torch.uint8)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        for part, event in (((3, None),) if events is None else
                            zip((1, 2), events)):
            _build.check(lib.g4c_sorted_segment_sum(
                src.data_ptr(), perm.data_ptr(), sorted_index.data_ptr(),
                rows, F, num_segments, long_rows, work.data_ptr(),
                out.data_ptr(), part, bf, stream))
            if event is not None:
                event.record()
    (sorted_segment_sum.bf16 if bf else sorted_segment_sum).launches += 1
    return out


#: kernel launches since the count was last set to 0 (f32 rows; bf16 rows
#: in ``sorted_segment_sum.bf16.launches``)
sorted_segment_sum.launches = 0
sorted_segment_sum.bf16 = SimpleNamespace(launches=0)


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


def take_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` (rows; ``index`` of any shape) whose backward is a sum
    in a fixed order, as ``_index_sum``'s: on the CPU ``index_select``
    goes back through ``index_add_``, elsewhere advanced indexing goes
    back through ``index_put_(accumulate=True)``."""
    index = index.long()
    if x.device.type != "cpu":
        return x[index]
    return torch.index_select(x, 0, index.reshape(-1)).reshape(
        *index.shape, *x.shape[1:])


#: the JAX package's name of the row gather (``graphs4cfd_tpu/ops/
#: segment.py:98``), also callable as ``ops.gather(x, index)``
gather = take_rows
