"""Fused fixed-k GN block: the CUDA kernel ``csrc/gn_block.cu``, its
wrapper and its plain PyTorch version.

Counterpart of ``graphs4cfd_tpu/ops/pallas_gnblock.py:gn_block_fused_wg``
(forward kernel ``_make_fwd_kernel_wg:517``, called from
``_gn_wg_fwd_impl:836``; math ``_fwd_math:75-119``).  The sender gather
``vs[senders]`` happens inside the kernel, by index; ``vs = v @ Ws`` comes
from outside.  Aggregation is the mean over the k edges of each receiver
(canonical layout: receiver ``v`` owns edge rows ``[v*k, (v+1)*k)``) and
reads the edge state before the optional output SELU.

What bounds it on the H100 and what the design does about it: see the note
at the top of ``csrc/gn_block.cu``.

Dispatch: ``gn_block`` takes the plain version for CPU tensors.  For CUDA
tensors it launches the kernel or raises: the kernel takes f32, 2 <= k <=
96, 1-8 layers per chain and every width at most 128.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .fused_mlp import mlp_chain_plain, selu
from .segment import aggregate_fixed_k

#: (weights [in, out], biases, LayerNorm (scale, bias) or None)
Chain = Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor],
              Optional[Tuple[torch.Tensor, torch.Tensor]]]

MAX_LAYERS = 8
MAX_WIDTH = 128


def gn_block_plain(e: torch.Tensor, vs: torch.Tensor, v: torch.Tensor,
                   senders: torch.Tensor, k: int, edge: Chain, node: Chain,
                   *, out_selu: bool = False, skip_e_out: bool = False):
    """The kernel's function in plain PyTorch.  Returns ``(v', e')``,
    ``e'`` None when ``skip_e_out``.

    ``edge[0][0]`` is the whole first edge layer ``[fe + 2 fv, H]``: rows
    ``[0, fe)`` are ``We``, ``[fe + fv, fe + 2 fv)`` are ``Wr``; the ``Ws``
    rows between them made ``vs``.  ``node[0][0]`` is ``[Wa; Wv]``.
    """
    (ew, eb, eln), (nw, nb, nln) = edge, node
    fe, fv = e.shape[1], v.shape[1]
    h1 = (e @ ew[0][:fe] + vs[senders.long()]
          + torch.repeat_interleave(v @ ew[0][fe + fv:], k, dim=0) + eb[0])
    e_new = mlp_chain_plain(h1, ew[1:], eb[1:], *(eln or (None, None)),
                            preact_input=True)
    aggr = aggregate_fixed_k(e_new, k, v.shape[0])
    fa = aggr.shape[1]
    hn = aggr @ nw[0][:fa] + v @ nw[0][fa:] + nb[0]
    v_new = mlp_chain_plain(hn, nw[1:], nb[1:], *(nln or (None, None)),
                            preact_input=True)
    if out_selu:
        v_new, e_new = selu(v_new), selu(e_new)
    return v_new, (None if skip_e_out else e_new)


def _check(e, vs, v, senders, k, edge, node):
    (ew, eb, eln), (nw, nb, nln) = edge, node
    V, fv = v.shape
    fe = e.shape[1]
    if not 2 <= k <= 96:
        raise ValueError(f"gn_block kernel takes 2 <= k <= 96, got {k}")
    if e.shape[0] != k * V or tuple(senders.shape) != (k * V,):
        raise ValueError(f"fixed-k layout needs E = k*V: e {tuple(e.shape)},"
                         f" senders {tuple(senders.shape)}, V={V}, k={k}")
    for name, (w, b) in (("edge", (ew, eb)), ("node", (nw, nb))):
        if not 1 <= len(w) <= MAX_LAYERS or len(b) != len(w):
            raise ValueError(f"gn_block kernel takes 1-{MAX_LAYERS} "
                             f"{name} layers")
    ed = [fe + 2 * fv] + [w.shape[1] for w in ew]
    nd = [ed[-1] + fv] + [w.shape[1] for w in nw]
    for name, ws, bs, dims in (("edge", ew, eb, ed), ("node", nw, nb, nd)):
        for i, (w, b) in enumerate(zip(ws, bs)):
            if tuple(w.shape) != (dims[i], dims[i + 1]) or \
                    tuple(b.shape) != (dims[i + 1],):
                raise ValueError(f"{name} layer {i}: weight "
                                 f"{tuple(w.shape)}, bias {tuple(b.shape)} "
                                 f"do not chain from {dims[i]} features")
    if tuple(vs.shape) != (V, ed[1]):
        raise ValueError(f"vs must be [V, {ed[1]}], got {tuple(vs.shape)}")
    lns = [t for ln in (eln, nln) if ln is not None for t in ln]
    for ln, width in ((eln, ed[-1]), (nln, nd[-1])):
        if ln is not None and any(tuple(t.shape) != (width,) for t in ln):
            raise ValueError(f"LayerNorm params do not match width {width}")
    if max([fe, fv] + ed[1:] + nd[1:]) > MAX_WIDTH:
        raise ValueError(f"gn_block kernel takes widths up to {MAX_WIDTH}")
    floats = [e, vs, v, *ew, *eb, *nw, *nb, *lns]
    for t in floats + [senders]:
        want = torch.int32 if t is senders else torch.float32
        if t.device != v.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"gn_block kernel takes contiguous {want} on "
                             f"{v.device}; got {t.dtype} on {t.device}, "
                             f"contiguous={t.is_contiguous()}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in floats):
        raise NotImplementedError("gn_block has no backward kernel yet: "
                                  "call it under torch.no_grad()")
    return ed, nd


def gn_block(e: torch.Tensor, vs: torch.Tensor, v: torch.Tensor,
             senders: torch.Tensor, k: int, edge: Chain, node: Chain, *,
             out_selu: bool = False, skip_e_out: bool = False):
    """Run the GN block: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (or an error if the kernel does not take them).
    Returns ``(v', e')``, ``e'`` None when ``skip_e_out``."""
    if v.device.type == "cpu":
        return gn_block_plain(e, vs, v, senders, k, edge, node,
                              out_selu=out_selu, skip_e_out=skip_e_out)
    if v.device.type != "cuda":
        raise ValueError(f"gn_block: unsupported device {v.device}")
    ed, nd = _check(e, vs, v, senders, k, edge, node)
    (ew, eb, eln), (nw, nb, nln) = edge, node
    lib = _build.load()
    c_ed, c_nd = _build.int_array(ed), _build.int_array(nd)
    V, fv = v.shape
    fe = e.shape[1]
    smem = lib.g4c_gn_block_smem(k, fe, fv, len(ew), c_ed, len(nw), c_nd)
    if smem == 0 or smem > _build.MAX_SMEM:
        raise ValueError(f"gn_block kernel cannot hold these widths in "
                         f"shared memory ({smem} bytes)")
    v_out = torch.empty(V, nd[-1], device=v.device, dtype=torch.float32)
    e_out = (None if skip_e_out else
             torch.empty(k * V, ed[-1], device=v.device, dtype=torch.float32))
    if V == 0:
        return v_out, e_out
    eln, nln = eln or (None, None), nln or (None, None)
    with torch.cuda.device(v.device):
        err = lib.g4c_gn_block(
            e.data_ptr(), vs.data_ptr(), v.data_ptr(), senders.data_ptr(),
            e_out.data_ptr() if e_out is not None else None, v_out.data_ptr(),
            V, k, fe, fv,
            len(ew), _build.ptr_array(ew), _build.ptr_array(eb), c_ed,
            *[t.data_ptr() if t is not None else None for t in eln],
            len(nw), _build.ptr_array(nw), _build.ptr_array(nb), c_nd,
            *[t.data_ptr() if t is not None else None for t in nln],
            int(out_selu), torch.cuda.current_stream().cuda_stream)
    _build.check(err)
    gn_block.launches += 1
    return v_out, e_out


#: kernel launches since the count was last set to 0
gn_block.launches = 0
