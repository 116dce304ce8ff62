"""Fused fixed-k GN block: the CUDA kernel ``csrc/gn_block.cu``, its
wrapper and its plain PyTorch version.

Counterpart of three TPU kernels of the JAX package that compute one
function:

* ``ops/pallas_gnblock.py:gn_block_fused_wg`` (forward kernel
  ``_make_fwd_kernel_wg:517``; math ``_fwd_math:75-119``), the MuS
  level-1 GN block;
* ``ops/pallas_gnblock.py:gn_block_fused`` (kernel ``_make_fwd_kernel:132``),
  REMuS's ``down_edge_mp``;
* ``ops/pallas_edgemp.py:edge_mp_folded`` (kernel
  ``_make_fwd_kernel_fold:112``; math ``_fwd_math_folded:52-110``), one
  REMuS EdgeMP layer: a GN block on the line graph, whose "edges" are the
  angles, whose "nodes" are the edges and whose sender map is
  ``angle_src``.

The sender gather ``vs[senders]`` happens inside the kernel, by index;
``vs = src @ Ws`` comes from outside and has its own row count ``S``: the
node set itself (MuS, ``edge_mp``) or another one (``down_edge_mp``: the
finer level's edges).  Aggregation is the mean over the k edges of each
receiver (canonical layout: receiver ``v`` owns edge rows
``[v*k, (v+1)*k)``) and reads the edge state before the optional output
SELU.

What bounds it on the H100 and what the design does about it: see the note
at the top of ``csrc/gn_block.cu``.

Dispatch: ``gn_block`` takes the plain version for CPU tensors.  For CUDA
tensors it launches the kernel or raises: the kernel takes f32, 2 <= k <=
96, 1-8 layers per chain (2-8 in the backward), the node input ``fv`` at
most 256 wide (gMuS's ``mp121`` and ``mp221`` take the 256-wide ``v`` of
an up step and its skip) and every other width at most 128, within the
card's shared memory (the backward of 3-layer chains fits at k=6, not at
k=5).  A sender outside ``[0, S)`` gives NaN outputs on the card, forward
and backward, and is never read (the plain versions raise
``IndexError``).

Backward: when a gradient is needed, ``gn_block`` runs through
``GnBlockFn``, whose backward is ``gn_block_bwd``: the CUDA kernel
``csrc/gn_block_bwd.cu`` for CUDA tensors (counterpart of
``pallas_gnblock.py:_gn_wg_vjp_bwd:858``, kernel ``_make_bwd_kernel_wg:556``,
math ``:639-709``; of ``pallas_gnblock.py:_gn_vjp_bwd:324``, REMuS's
``down_edge_mp``; and of ``pallas_edgemp.py:_edgemp_fold_vjp_bwd:452``, one
EdgeMP layer), ``gn_block_bwd_plain`` for CPU tensors.  It recomputes
the forward and returns ``de``, ``dv`` (the ``Wr`` and ``Wv`` paths only),
``dvs`` (the per-edge first-layer cotangent summed per sender in sorted
order, ``ops.segment.sorted_segment_sum``) and every parameter gradient.
The ``Ws`` rows ``[fe, fe + fs)`` of the first edge layer's gradient are
zero: ``vs = src @ Ws`` is computed outside, so autograd gives ``Ws`` (and
the source) their share through ``dvs``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .fused_mlp import (chain_bwd_plain, dselu, layer_norm, layer_norm_bwd,
                        mlp_chain_plain, selu)
from .segment import (aggregate_fixed_k, gather_sorted, sorted_segment_sum,
                      sorted_segment_sum_plain)

#: (weights [in, out], biases, LayerNorm (scale, bias) or None)
Chain = Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor],
              Optional[Tuple[torch.Tensor, torch.Tensor]]]

MAX_LAYERS = 8
MAX_WIDTH = 128
MAX_NODE_WIDTH = 256


def repeat_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Each row ``k`` times in a row (receiver ``v`` -> edge rows
    ``[v*k, (v+1)*k)``).  A broadcast, so its backward is a sum over ``k``
    and not ``repeat_interleave``'s ``index_add_``."""
    return x[:, None, :].expand(x.shape[0], k, x.shape[1]).reshape(
        x.shape[0] * k, x.shape[1])


def _split_first(w, fe, fv):
    """``(We, Wr)`` of a first edge layer ``[We; Ws; Wr]``."""
    return w[:fe], w[w.shape[0] - fv:]


def _first_edge_layer(e, vs, v, senders, k, ew, eb, sender_sort):
    we, wr = _split_first(ew[0], e.shape[1], v.shape[1])
    if senders.numel() and not (0 <= int(senders.min())
                                and int(senders.max()) < vs.shape[0]):
        # the kernels give NaN there; negative indices would wrap here
        raise IndexError(f"a sender lies outside the table's "
                         f"{vs.shape[0]} rows")
    vsg = (gather_sorted(vs, senders, *sender_sort) if sender_sort
           else vs[senders.long()])
    return e @ we + vsg + repeat_k(v @ wr, k) + eb[0]


def gn_block_plain(e: torch.Tensor, vs: torch.Tensor, v: torch.Tensor,
                   senders: torch.Tensor, k: int, edge: Chain, node: Chain,
                   *, out_selu: bool = False, skip_e_out: bool = False,
                   sender_sort=None):
    """The kernel's function in plain PyTorch.  Returns ``(v', e')``,
    ``e'`` None when ``skip_e_out``.

    ``edge[0][0]`` is the whole first edge layer ``[fe + fs + fv, H]``:
    rows ``[0, fe)`` are ``We``, the last ``fv`` rows are ``Wr``; the
    ``fs`` ``Ws`` rows between them made ``vs [S, H]``, the table that
    ``senders`` (in ``[0, S)``) index.  ``node[0][0]`` is ``[Wa; Wv]``.
    ``sender_sort = (perm, sorted senders)`` routes the sender gather's
    backward through ``ops.segment.gather_sorted``.
    """
    (ew, eb, eln), (nw, nb, nln) = edge, node
    h1 = _first_edge_layer(e, vs, v, senders, k, ew, eb, sender_sort)
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


def _sender_sort(senders, sender_sort):
    """``(perm, sorted senders)`` as int32, sorting here if not given."""
    if sender_sort is not None:
        return sender_sort
    srt, perm = torch.sort(senders, stable=True)
    return perm.int(), srt.int()


def gn_block_bwd_plain(e, vs, v, senders, sender_sort, k: int, edge: Chain,
                       node: Chain, gv, ge, *, out_selu: bool = False):
    """The backward kernel's function in plain PyTorch (the math of
    ``pallas_gnblock.py:639-709``).  ``gv``/``ge`` are the cotangents of
    ``v'``/``e'`` (``ge`` None under ``skip_e_out``).  Returns ``(de, dv,
    dvs, (dW, db, dLN or None) of the edge chain, the same of the node
    chain)``; ``dv`` holds the ``Wr`` and ``Wv`` paths only, ``dvs`` has
    the table's ``S`` rows and the ``Ws`` rows ``[fe, fe + fs)`` of the
    first edge layer's ``dW`` are zero."""
    (ew, eb, eln), (nw, nb, nln) = edge, node
    V, fe, fv = v.shape[0], e.shape[1], v.shape[1]
    perm, srt = _sender_sort(senders, sender_sort)
    with torch.no_grad():
        # remat forward
        h1 = _first_edge_layer(e, vs, v, senders, k, ew, eb, None)
        e_pre = mlp_chain_plain(h1, ew[1:], eb[1:], preact_input=True)
        e_new = layer_norm(e_pre, *eln) if eln else e_pre
        aggr = aggregate_fixed_k(e_new, k, V)
        fa = aggr.shape[1]
        wa, wv = nw[0][:fa], nw[0][fa:]
        hn = aggr @ wa + v @ wv + nb[0]
        v_pre = mlp_chain_plain(hn, nw[1:], nb[1:], preact_input=True)
        v_new = layer_norm(v_pre, *nln) if nln else v_pre
        if out_selu:
            gv = gv * dselu(v_new)
            ge = ge * dselu(e_new) if ge is not None else None
        # node chain
        dnln = None
        if nln:
            gv, dscale, dbias = layer_norm_bwd(gv, v_pre, nln[0])
            dnln = (dscale, dbias)
        dhn, dnw, dnb = chain_bwd_plain(gv, hn, nw[1:], nb[1:],
                                        preact_input=True)
        dnw = [torch.cat([aggr.t() @ dhn, v.t() @ dhn])] + dnw
        dnb = [dhn.sum(dim=0)] + dnb
        dv = dhn @ wv.t()
        de_new = repeat_k(dhn @ wa.t() / k, k)
        if ge is not None:
            de_new = ge + de_new
        # edge chain
        deln = None
        if eln:
            de_new, dscale, dbias = layer_norm_bwd(de_new, e_pre, eln[0])
            deln = (dscale, dbias)
        dh1, dew, deb = chain_bwd_plain(de_new, h1, ew[1:], eb[1:],
                                        preact_input=True)
        we, wr = _split_first(ew[0], fe, fv)
        dvr = dh1.reshape(V, k, -1).sum(dim=1)
        dew = [torch.cat([e.t() @ dh1,
                          torch.zeros_like(ew[0][fe:ew[0].shape[0] - fv]),
                          v.t() @ dvr])] + dew
        deb = [dh1.sum(dim=0)] + deb
        de = dh1 @ we.t()
        dv = dv + dvr @ wr.t()
    dvs = sorted_segment_sum_plain(dh1, perm, srt, vs.shape[0])
    return de, dv, dvs, (dew, deb, deln), (dnw, dnb, dnln)


def _check(e, vs, v, senders, k, edge, node):
    """The layer widths ``(ed, nd)``, ``ed[0] = fe + fs + fv``, or
    ``ValueError`` if the kernels do not take these inputs."""
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
    if ew[0].shape[0] < fe + fv:
        raise ValueError(f"the first edge layer has {ew[0].shape[0]} rows, "
                         f"fewer than fe + fv = {fe + fv}")
    ed = [ew[0].shape[0]] + [w.shape[1] for w in ew]
    nd = [ed[-1] + fv] + [w.shape[1] for w in nw]
    for name, ws, bs, dims in (("edge", ew, eb, ed), ("node", nw, nb, nd)):
        for i, (w, b) in enumerate(zip(ws, bs)):
            if tuple(w.shape) != (dims[i], dims[i + 1]) or \
                    tuple(b.shape) != (dims[i + 1],):
                raise ValueError(f"{name} layer {i}: weight "
                                 f"{tuple(w.shape)}, bias {tuple(b.shape)} "
                                 f"do not chain from {dims[i]} features")
    if vs.dim() != 2 or vs.shape[0] < 1 or vs.shape[1] != ed[1]:
        raise ValueError(f"vs must be [S >= 1, {ed[1]}], got "
                         f"{tuple(vs.shape)}")
    lns = [t for ln in (eln, nln) if ln is not None for t in ln]
    for ln, width in ((eln, ed[-1]), (nln, nd[-1])):
        if ln is not None and any(tuple(t.shape) != (width,) for t in ln):
            raise ValueError(f"LayerNorm params do not match width {width}")
    if max([fe] + ed[1:] + nd[1:]) > MAX_WIDTH:
        raise ValueError(f"gn_block kernel takes widths up to {MAX_WIDTH}")
    if fv > MAX_NODE_WIDTH:
        raise ValueError(f"gn_block kernel takes a node input up to "
                         f"{MAX_NODE_WIDTH} wide, got {fv}")
    floats = [e, vs, v, *ew, *eb, *nw, *nb, *lns]
    for t in floats + [senders]:
        want = torch.int32 if t is senders else torch.float32
        if t.device != v.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"gn_block kernel takes contiguous {want} on "
                             f"{v.device}; got {t.dtype} on {t.device}, "
                             f"contiguous={t.is_contiguous()}")
    return ed, nd


def gn_block(e: torch.Tensor, vs: torch.Tensor, v: torch.Tensor,
             senders: torch.Tensor, k: int, edge: Chain, node: Chain, *,
             out_selu: bool = False, skip_e_out: bool = False,
             sender_sort=None):
    """Run the GN block: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (or an error if the kernel does not take them).
    Returns ``(v', e')``, ``e'`` None when ``skip_e_out``.  When a gradient
    is needed it goes through ``GnBlockFn``, whose backward is
    ``gn_block_bwd``; ``sender_sort = (perm, sorted senders)`` (int32) is
    the sender order its ``dvs`` sums walk (sorted here if not given)."""
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gn_block: unsupported device {v.device}")
    (ew, eb, eln), (nw, nb, nln) = edge, node
    flat = [*ew, *eb, *(eln or ()), *nw, *nb, *(nln or ())]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [e, vs, v, *flat]):
        perm, srt = sender_sort if sender_sort is not None else (None, None)
        out = GnBlockFn.apply(e, vs, v, senders, perm, srt, k, out_selu,
                              skip_e_out, len(ew), len(nw), bool(eln),
                              bool(nln), *flat)
        return (out, None) if skip_e_out else out
    if v.device.type == "cpu":
        return gn_block_plain(e, vs, v, senders, k, edge, node,
                              out_selu=out_selu, skip_e_out=skip_e_out)
    return _launch_fwd(e, vs, v, senders, k, edge, node, out_selu,
                       skip_e_out)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch_fwd(e, vs, v, senders, k, edge, node, out_selu, skip_e_out):
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
            _ptr(e_out), v_out.data_ptr(), V, vs.shape[0], k, fe,
            ed[0] - fe - fv, fv, len(ew), _build.ptr_array(ew),
            _build.ptr_array(eb), c_ed,
            *map(_ptr, eln),
            len(nw), _build.ptr_array(nw), _build.ptr_array(nb), c_nd,
            *map(_ptr, nln),
            int(out_selu), torch.cuda.current_stream().cuda_stream)
    _build.check(err)
    gn_block.launches += 1
    return v_out, e_out


#: kernel launches since the count was last set to 0
gn_block.launches = 0


def _chain_sizes(dims, has_ln):
    """Parameter shapes of a chain in the flat gradient order W0, b0, W1,
    b1, ..., LN scale, LN bias."""
    out = []
    for a, b in zip(dims[:-1], dims[1:]):
        out += [(a, b), (b,)]
    return out + ([(dims[-1],), (dims[-1],)] if has_ln else [])


def gn_block_bwd(e, vs, v, senders, sender_sort, k: int, edge: Chain,
                 node: Chain, gv, ge, *, out_selu: bool = False):
    """The GN block's backward: the plain version for CPU tensors, the CUDA
    kernel (then ``sorted_segment_sum`` for ``dvs``) for CUDA tensors, or
    an error if the kernel does not take them.  Returns what
    ``gn_block_bwd_plain`` returns."""
    if v.device.type == "cpu":
        return gn_block_bwd_plain(e, vs, v, senders, sender_sort, k, edge,
                                  node, gv, ge, out_selu=out_selu)
    if v.device.type != "cuda":
        raise ValueError(f"gn_block_bwd: unsupported device {v.device}")
    return _launch_bwd(e, vs, v, senders, sender_sort, k, edge, node, gv, ge,
                       out_selu)


def _launch_bwd(e, vs, v, senders, sender_sort, k, edge, node, gv, ge,
                out_selu):
    ed, nd = _check(e, vs, v, senders, k, edge, node)
    (ew, eb, eln), (nw, nb, nln) = edge, node
    V, fv = v.shape
    fe, E = e.shape[1], e.shape[0]
    for name, t, width in (("gv", gv, nd[-1]), ("ge", ge, ed[-1])):
        if t is not None and (tuple(t.shape) != (t.shape[0], width)
                              or t.shape[0] != (V if name == "gv" else E)
                              or t.dtype != torch.float32
                              or t.device != v.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 with "
                             f"{width} columns, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    perm, srt = _sender_sort(senders, sender_sort)
    lib = _build.load()
    c_ed, c_nd = _build.int_array(ed), _build.int_array(nd)
    smem = lib.g4c_gn_block_bwd_smem(k, fe, fv, len(ew), c_ed, len(nw), c_nd)
    if smem == 0 or smem > _build.MAX_SMEM:
        raise ValueError(f"gn_block_bwd kernel cannot hold these widths in "
                         f"shared memory ({smem} bytes)")
    sizes = _chain_sizes(ed, eln is not None) + _chain_sizes(nd,
                                                             nln is not None)
    numel = sum(math.prod(sz) for sz in sizes)
    flat = torch.empty(numel, device=v.device, dtype=torch.float32)
    de = torch.empty(E, fe, device=v.device, dtype=torch.float32)
    dv = torch.empty(V, fv, device=v.device, dtype=torch.float32)
    dh1 = torch.empty(E, ed[1], device=v.device, dtype=torch.float32)
    grid = lib.g4c_gn_block_bwd_grid(k, fe, fv, len(ew), c_ed, len(nw), c_nd,
                                     V)
    if grid < 1:
        raise RuntimeError("gn_block_bwd: no grid size for this card")
    work = torch.empty(max(grid, 1) * numel, device=v.device,
                       dtype=torch.float32)
    eln_, nln_ = eln or (None, None), nln or (None, None)
    with torch.cuda.device(v.device):
        err = lib.g4c_gn_block_bwd(
            e.data_ptr(), vs.data_ptr(), v.data_ptr(), senders.data_ptr(),
            _ptr(ge), gv.data_ptr(), de.data_ptr(), dv.data_ptr(),
            dh1.data_ptr(), V, vs.shape[0], k, fe, ed[0] - fe - fv, fv,
            len(ew), _build.ptr_array(ew), _build.ptr_array(eb), c_ed,
            *map(_ptr, eln_),
            len(nw), _build.ptr_array(nw), _build.ptr_array(nb), c_nd,
            *map(_ptr, nln_),
            int(out_selu), work.data_ptr(), grid, flat.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err)
    gn_block_bwd.launches += 1
    dvs = sorted_segment_sum(dh1, perm, srt, vs.shape[0])
    grads, off = [], 0
    for sz in sizes:
        grads.append(flat[off:off + math.prod(sz)].view(sz))
        off += math.prod(sz)
    ne, nn = len(ew), len(nw)
    dedge = (grads[0:2 * ne:2], grads[1:2 * ne:2],
             tuple(grads[2 * ne:2 * ne + 2]) if eln else None)
    rest = grads[2 * ne + (2 if eln else 0):]
    dnode = (rest[0:2 * nn:2], rest[1:2 * nn:2],
             tuple(rest[2 * nn:]) if nln else None)
    return de, dv, dvs, dedge, dnode


#: kernel launches since the count was last set to 0
gn_block_bwd.launches = 0


class GnBlockFn(torch.autograd.Function):
    """``gn_block`` with ``gn_block_bwd`` as its backward.  Arguments come
    flattened: ``e, vs, v, senders, perm, sorted, k, out_selu, skip_e_out,
    ne, nn, has_eln, has_nln, *ew, *eb, *eln, *nw, *nb, *nln``; the output
    is ``(v', e')``, or ``v'`` alone under ``skip_e_out``.  Only the inputs
    are saved: the backward recomputes the forward."""

    @staticmethod
    def forward(ctx, e, vs, v, senders, perm, srt, k, out_selu, skip_e_out,
                ne, nn, has_eln, has_nln, *flat):
        ctx.statics = (k, out_selu, skip_e_out, ne, nn, has_eln, has_nln)
        ctx.save_for_backward(e, vs, v, senders, perm, srt, *flat)
        edge, node = _unflatten(flat, ne, nn, has_eln, has_nln)
        v_new, e_new = gn_block(e, vs, v, senders, k, edge, node,
                                out_selu=out_selu, skip_e_out=skip_e_out)
        return v_new if skip_e_out else (v_new, e_new)

    @staticmethod
    def backward(ctx, gv, ge=None):
        k, out_selu, skip_e_out, ne, nn, has_eln, has_nln = ctx.statics
        e, vs, v, senders, perm, srt, *flat = ctx.saved_tensors
        edge, node = _unflatten(flat, ne, nn, has_eln, has_nln)
        sort = (perm, srt) if perm is not None else None
        de, dv, dvs, dedge, dnode = gn_block_bwd(
            e, vs, v, senders, sort, k, edge, node, gv.contiguous(),
            None if skip_e_out else ge.contiguous(), out_selu=out_selu)
        dflat = [*dedge[0], *dedge[1], *(dedge[2] or ()), *dnode[0],
                 *dnode[1], *(dnode[2] or ())]
        return (de, dvs, dv, *([None] * 10), *dflat)


def _unflatten(flat, ne, nn, has_eln, has_nln):
    i = 0
    ew, eb = flat[i:i + ne], flat[i + ne:i + 2 * ne]
    i += 2 * ne
    eln = tuple(flat[i:i + 2]) if has_eln else None
    i += 2 if has_eln else 0
    nw, nb = flat[i:i + nn], flat[i + nn:i + 2 * nn]
    i += 2 * nn
    nln = tuple(flat[i:i + 2]) if has_nln else None
    return (list(ew), list(eb), eln), (list(nw), list(nb), nln)
