"""Row gather ``table[idx]``: the CUDA kernel ``csrc/gather_rows.cu``, its
wrapper and its plain PyTorch version.

Counterpart of the TPU kernel ``ops/pallas_gather.py:windowed_take`` of
the JAX package (``_wt_fwd``, kernel ``_fwd_kernel``), which computes
``table[indices]`` as a one-hot matmul over a window of the table plus
out-of-window exception rows, and of its transpose ``_wt_vjp_bwd``
(``zero_tail`` for graph-parallel halo tables).  The port computes the
same function without the window plan: the kernel loads each row by
index.  The transpose is ``ops.segment.sorted_segment_sum`` over a sort of
the indices (``csrc/sorted_segment_sum.cu``): every table row gets the sum
of the cotangent rows gathered from it, in a fixed order, and rows that
nothing gathers get 0.

The graph-parallel forwards (``parallel.graph_parallel``) gather through
it from every device-local halo table: the exchanges' send rows, the MuS
coarse levels' sender and receiver rows and up steps' parents, the gMuS
down selects and up interpolations, the REMuS node-origin rows and
up interpolations.

Tables are f32, or bf16 under the bf16 policy (the sender terms ``vs =
v @ Ws`` and the activations are bf16 there, so every halo table is):
the kernel copies the rows' bits, so both give the plain version's bits,
and its bf16 launches count apart, in ``gather_rows.bf16``.

Dispatch: ``gather_rows`` takes the plain version for a CPU tensor; for a
CUDA tensor it launches the kernel or raises.  The kernel gives a NaN row
for an index outside ``[0, S)`` and never reads outside the table; the
plain version raises ``IndexError`` (negative indices included).

The module itself is callable: ``ops.gather(x, index)`` is the JAX
package's ``ops.gather`` (``ops.segment.gather``, a plain row gather), so
that name works on the port while ``ops.gather.gather_rows`` stays this
kernel's wrapper.
"""
from __future__ import annotations

import sys
import types
from types import SimpleNamespace

import torch

from . import _build, segment


def _index_sort(idx: torch.Tensor):
    """``(perm, sorted idx)`` of ``idx``, int32, stable."""
    srt, perm = torch.sort(idx, stable=True)
    return perm.int(), srt.int()


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (an f32 or bf16 table, its type kept) for int32
    ``idx`` in ``[0, S)``; raises ``IndexError`` for an index outside
    (indexing would wrap a negative one)."""
    if idx.numel() and not (0 <= int(idx.min())
                            and int(idx.max()) < table.shape[0]):
        raise IndexError(f"an index lies outside the table's "
                         f"{table.shape[0]} rows")
    return table[idx.long()]


def _launch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows takes table [S, H] and idx [M]; got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gather_rows takes a float32 or bfloat16 table, "
                         f"got {table.dtype}")
    for t, want in ((table, table.dtype), (idx, torch.int32)):
        if t.device != table.device or t.dtype != want or \
                not t.is_contiguous():
            raise ValueError(f"gather_rows takes contiguous {want} on "
                             f"{table.device}; got {t.dtype} on {t.device}")
    S, H = table.shape
    bf = table.dtype == torch.bfloat16
    out = torch.empty(idx.shape[0], H, device=table.device,
                      dtype=table.dtype)
    if idx.shape[0] == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(table.device):
        err = lib.g4c_gather_rows(table.data_ptr(), idx.data_ptr(),
                                  idx.shape[0], H, S, out.data_ptr(),
                                  int(bf),
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(err)
    (gather_rows.bf16 if bf else gather_rows).launches += 1
    return out


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    return _launch(table, idx)


class GatherRowsFn(torch.autograd.Function):
    """``table[idx]`` whose backward sums the cotangent rows per table row
    with ``sorted_segment_sum`` over ``(perm, sorted idx)``.

    A bf16 table's cotangent rows are added in f32 and the sums rounded to
    bf16 once, when they are handed to the table: the point where the
    single-device bf16 path rounds its gather cotangents (``ops.gn_block``
    sums the sender cotangents in f32 into ``dvs`` and autograd hands the
    bf16 table ``dvs`` in bf16)."""

    @staticmethod
    def forward(ctx, table, idx, perm, srt):
        ctx.save_for_backward(perm, srt)
        ctx.num_rows, ctx.dtype = table.shape[0], table.dtype
        return _gather(table, idx)

    @staticmethod
    def backward(ctx, grad):
        perm, srt = ctx.saved_tensors
        dtab = segment.sorted_segment_sum(grad.contiguous(), perm, srt,
                                          ctx.num_rows)
        return dtab.to(ctx.dtype), None, None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                sort=None) -> torch.Tensor:
    """``table[idx]`` (``idx`` int32): the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor.  When a gradient is needed it goes
    through ``GatherRowsFn``; ``sort = (perm, sorted idx)`` (int32, a
    stable argsort of ``idx`` and ``idx`` in that order, as
    ``parallel.attach_gp_sorts`` attaches them) is the order its sums walk
    (sorted on the device if not given)."""
    if torch.is_grad_enabled() and table.requires_grad:
        perm, srt = sort if sort is not None else _index_sort(idx)
        return GatherRowsFn.apply(table, idx, perm, srt)
    return _gather(table, idx)


#: kernel launches since the count was last set to 0 (f32 tables; bf16
#: tables in ``gather_rows.bf16.launches``)
gather_rows.launches = 0
gather_rows.bf16 = SimpleNamespace(launches=0)


class _CallableModule(types.ModuleType):
    def __call__(self, node_feats: torch.Tensor,
                 index: torch.Tensor) -> torch.Tensor:
        return segment.gather(node_feats, index)


sys.modules[__name__].__class__ = _CallableModule
