"""The backward kernels' weight gradients on their own: the CUDA kernels of
``csrc/wgrad.cu`` and ``csrc/wgrad_bf16.cu``, a wrapper and the plain
PyTorch version, and the plan both backwards launch them with.

Every backward of the port (``ops.fused_mlp.mlp_chain_bwd``,
``ops.gn_block.gn_block_bwd``) ends with one launch of the weight-gradient
kernel over all of its products ``dW = X^T D`` and one launch of the
fixed-order reduction: each product is split over chunks of
``wgrad_chunk(rows)`` rows, a block sums one (product, chunk, 128-column
slice of K) into a partial, and the reduction adds the partials in a fixed
order.  ``weight_grads`` runs the same two launches on products given by
the caller, so that the kernel can be checked and timed on its own.

Under the bf16 policy (a bf16 ``D``; the JAX package's backward kernels'
``jnp.dot(h_prev.astype(bf16).T, da.astype(bf16),
preferred_element_type=f32)``, ``pallas_mlp.py:136``,
``pallas_gnblock.py:62``) ``X`` is bf16 or f32 and both operands are
rounded to bf16 (nearest even), the sums f32: ``csrc/wgrad_bf16.cu``'s
kernel (wgmma over bf16 tiles in shared memory).  Under f32 both operands
are f32: ``csrc/wgrad.cu``'s ``gn_wgrad_kernel`` (3xTF32 mma.sync).  The
gradients are f32 either way.  Its launches, and those the backwards make,
count in ``weight_grads.launches`` (f32) and ``weight_grads.bf16.launches``.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Sequence, Tuple

import torch

from . import _build
from .fused_mlp import is_bf16, operand_rounding

#: the split rule (``csrc/wgrad.cuh``): rows of a partial, at the least,
#: and the partials a product is split into at the least
WG_CHUNK, WG_MIN_CHUNK, WG_MIN_CHUNKS = 2048, 256, 64
#: products one launch takes (``csrc/wgrad.cuh:MAX_PRODS``)
MAX_PRODS = 18
#: the bf16 kernel's geometry (``csrc/wgrad_bf16.cu``): rows of a ring
#: stage, stages, and the bytes of one 64 x 128 bf16 tile (a stage holds an
#: X tile and a D tile)
BF16_STAGE_ROWS, BF16_STAGES, BF16_TILE_BYTES = 64, 3, 16384


def wgrad_chunk(rows: int) -> int:
    """Rows of each partial of a product over ``rows`` rows: ``WG_CHUNK``,
    halved (down to ``WG_MIN_CHUNK``) while there would be fewer than
    ``WG_MIN_CHUNKS`` partials.  A function of the row count alone."""
    c = WG_CHUNK
    while c > WG_MIN_CHUNK and -(-rows // c) < WG_MIN_CHUNKS:
        c //= 2
    return c


def bf16_smem() -> int:
    """Shared-memory bytes of one block of the bf16 kernel: the ring and 1 KB
    to align its swizzled tiles to 1024 bytes."""
    return 1024 + BF16_STAGES * 2 * BF16_TILE_BYTES


def plan(products: Sequence[Tuple[int, int, int]]):
    """The blocks of one launch over ``products`` (``(rows, K, N)`` each):
    per product ``(chunk, chunks, 128-column slices of K)``, the blocks in
    all and the partials' floats."""
    out, blocks, floats = [], 0, 0
    for rows, K, N in products:
        chunk = wgrad_chunk(rows)
        chunks, kt = -(-rows // chunk), -(-K // 128)
        out.append((chunk, chunks, kt))
        blocks += chunks * kt
        floats += chunks * K * N
    return out, blocks, floats


def chain_products(rows: int, dims: Sequence[int], preact: bool):
    """The products of an MLP chain's backward (``csrc/mlp_chain_bwd.cu:
    mlp_bwd_plan``) under the bf16 policy: ``(rows, K, N, X is bf16)`` per
    layer; X is the f32 layer input the tile kernel writes (after SELU)
    for layers 1..n-1 and, with ``preact``, layer 0; else the bf16 x."""
    return [(rows, dims[l], dims[l + 1], l == 0 and not preact)
            for l in range(len(dims) - 1)]


def gn_products(V: int, k: int, fe: int, fv: int, ed: Sequence[int],
                nd: Sequence[int]):
    """The products of a GN block's backward (``csrc/gn_block_bwd.cu:
    gn_bwd_plan``) under the bf16 policy, ``(rows, K, N, X is bf16)``:
    ``e^T dh1``, ``v^T dvr``, the edge layers' f32 inputs against their
    output cotangents, ``aggr^T dn_0``, ``v^T dn_0`` and the node layers'
    f32 inputs against theirs."""
    E, ne, nn = V * k, len(ed) - 1, len(nd) - 1
    return ([(E, fe, ed[1], True), (V, fv, ed[1], True)]
            + [(E, ed[l], ed[l + 1], False) for l in range(1, ne)]
            + [(V, ed[ne], nd[1], False), (V, fv, nd[1], True)]
            + [(V, nd[l], nd[l + 1], False) for l in range(1, nn)])


def weight_grads_plain(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """``[X^T D]`` in f32 for each ``(X, D)``; under the bf16 policy (a bf16
    ``D``) both operands rounded to bf16 first."""
    out = []
    for x, d in pairs:
        rnd = operand_rounding(is_bf16(d))
        out.append(rnd(x.float()).t() @ rnd(d.float()))
    return out


def weight_grads(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """``[X^T D]`` (f32) for each ``(X, D)``: the plain version for CPU
    tensors, the weight-gradient kernel and the reduction for CUDA tensors
    (or an error if the kernels do not take them)."""
    if all(d.device.type == "cpu" for _, d in pairs):
        return weight_grads_plain(pairs)
    return _launch(pairs)


def _check(pairs):
    if not 1 <= len(pairs) <= MAX_PRODS:
        raise ValueError(f"weight_grads takes 1-{MAX_PRODS} products, got "
                         f"{len(pairs)}")
    bf = is_bf16(pairs[0][1])
    dev = pairs[0][1].device
    for x, d in pairs:
        ok_types = ((x.dtype in (torch.float32, torch.bfloat16)
                     and d.dtype == torch.bfloat16) if bf else
                    x.dtype == d.dtype == torch.float32)
        if (x.dim() != 2 or d.dim() != 2 or x.shape[0] != d.shape[0]
                or not 1 <= d.shape[1] <= 128 or x.shape[1] < 1
                or not ok_types or x.device != dev or d.device != dev
                or not x.is_contiguous() or not d.is_contiguous()):
            raise ValueError(
                "weight_grads takes contiguous X [rows, K] and D [rows, N], "
                "N <= 128, on one CUDA device: both f32, or a bf16 D and an "
                f"f32 or bf16 X; got X {tuple(x.shape)} {x.dtype} and D "
                f"{tuple(d.shape)} {d.dtype}")
    return bf


def _launch(pairs, events=None):
    """Launch the kernel and the reduction.  With ``events`` (two
    ``torch.cuda.Event`` objects) each runs on its own and is followed by
    one event."""
    bf = _check(pairs)
    dev = pairs[0][1].device
    # the reduction writes every entry of a product with rows; one of no
    # rows is zero
    outs = [(torch.empty if x.shape[0] else torch.zeros)(
        x.shape[1], d.shape[1], device=dev, dtype=torch.float32)
        for x, d in pairs]
    todo = [(x, d, o) for (x, d), o in zip(pairs, outs) if x.shape[0] > 0]
    if not todo:
        return outs
    lib = _build.load()
    n = len(todo)
    rows = _build.int64_array([x.shape[0] for x, _, _ in todo])
    K = _build.int_array([x.shape[1] for x, _, _ in todo])
    N = _build.int_array([d.shape[1] for _, d, _ in todo])
    work = torch.empty(lib.g4c_wgrad_work(n, rows, K, N), device=dev,
                       dtype=torch.float32)
    args = (n, _build.ptr_array([x for x, _, _ in todo]),
            _build.int_array([is_bf16(x) for x, _, _ in todo]),
            _build.ptr_array([d for _, d, _ in todo]), rows, K, N,
            _build.ptr_array([o for _, _, o in todo]), work.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for part, event in (((6, None),) if events is None else
                            zip((2, 4), events)):
            _build.check(lib.g4c_wgrad(*args, part, int(bf), stream))
            if event is not None:
                event.record()
    count_launch(bf)
    return outs


def count_launch(bf16: bool) -> None:
    """One launch of the weight-gradient kernel (``bf16``: the bf16 one),
    by ``weight_grads`` or a backward."""
    (weight_grads.bf16 if bf16 else weight_grads).launches += 1


#: kernel launches since the count was last set to 0 (f32; bf16 in
#: ``weight_grads.bf16.launches``), the backwards' included
weight_grads.launches = 0
weight_grads.bf16 = SimpleNamespace(launches=0)
