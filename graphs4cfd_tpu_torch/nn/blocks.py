"""MuS and REMuS blocks (port of ``graphs4cfd_tpu/nn/blocks.py``).

* ``gn_block``: the GN block.  A fixed-k level without a mask (level 1)
  runs the fused kernel ``ops.gn_block``; a coarse level runs the masked
  segment path with its MLP tails through ``ops.fused_mlp``.
* ``down_mp``, ``pool_edges``, ``up_mp``: MuS pooling and unpooling.
* ``edge_mp``, ``down_edge_mp``: REMuS message passing on the line graph
  and pooling over inter-level angles.  Both are GN blocks whose "edges"
  are angles and whose "nodes" are edges, so both run the fused kernel
  ``ops.gn_block`` with the angle sources as its sender map.
* ``up_edge_mp``, ``edge_scalar_to_node_vector``,
  ``project_node_vectors_to_edges``: REMuS unpooling through node vectors.
* ``restriction``, ``lstsq``, ``pool_edge``: the reference's one-call
  helpers (``graphs4cfd_tpu/nn/blocks.py:685-730``), in plain PyTorch, for
  users porting reference-style code; no model calls them.

Angles are ``[E*k, F]`` tensors: the k angles of edge ``i`` are rows
``[i*k, (i+1)*k)``, and ``angle_src [E, k]`` lists their sender edges.

Gradients: the kernels' backwards come with ``ops.fused_mlp`` and
``ops.gn_block``; the rest goes through autograd.  No op here goes back
through float atomics on CUDA, nor through threads that add in no fixed
order on the CPU: a gather goes through ``ops.segment.take_rows`` (on
CUDA back through ``index_put_(accumulate=True)``, a stable sort, then
each row's sum in order), the level-1 sender gather and the REMuS angle-source gathers
through ``ops.gn_block``'s sorted per-sender sums (over the graph's
``sender_perm``/``sender_sorted`` and the ``loader.attach_angle_sorts``
arrays), and the segment means' backward is a gather.

The bf16 policy (``cd = torch.bfloat16``, ``graphs4cfd_tpu/nn/blocks.py``
under ``compute_dtype=jnp.bfloat16``): activations between blocks are
bf16, parameters f32.  The kernels (``ops.gn_block``, ``ops.fused_mlp``)
take bf16 activations and follow the Pallas kernels' rounding points.
The plain sites follow the JAX package's plain code: each product takes
both operands rounded to bf16 and is rounded to bf16 (``mm``), and each
bias add and sum of products is a bf16 add (the first layers of the
coarse GN blocks, of the node MLPs there and of ``up_edge_mp``; the
tables ``vs = v @ Ws`` and ``es = e @ Ws``), as in
``graphs4cfd_tpu/nn/blocks.py:160-177, 301-306, 442-526``.  Where they
differ: the segment means (coarse aggregation, pooling) sum bf16 rows in
f32 and round the mean once, where JAX sums in bf16; a SELU or tanh of
bf16 rounds once; and the coarse levels' MLP tails run through
``mlp_chain`` (see ``nn.mlp``).  The REMuS pinverse solves, k-NN
interpolation and projections run in f32, as JAX's type promotion does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops import gn_block as gn_op
from ..ops.coarsen import pool_edge_structure
from ..ops.fused_mlp import round_bf16, selu, widen
from ..ops.interp import knn_interpolate
from ..ops.linalg import pinv_k2
from ..ops.segment import segment_mean, segment_sum, take_rows
from .mlp import MLP, apply_mlp, apply_mlp_tail, chain_of

F32 = torch.float32


def mm(a: torch.Tensor, w: torch.Tensor, cd: torch.dtype = F32
       ) -> torch.Tensor:
    """A product at a plain site: ``a @ w``; under the bf16 policy both
    operands rounded to bf16, the product summed in f32 and rounded to
    bf16 (the JAX package's ``(a.astype(bf16) @ w.astype(bf16))``)."""
    if cd == F32:
        return a @ w
    return (round_bf16(a) @ round_bf16(w)).to(cd)


def bias(b: torch.Tensor, cd: torch.dtype = F32) -> torch.Tensor:
    """A bias at a plain site, in the activations' type."""
    return b if cd == F32 else b.to(cd)


def act_mean(src: torch.Tensor, index: torch.Tensor, num_segments: int, *,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``segment_mean`` of activations: a bf16 ``src`` summed in f32, the
    mean rounded to bf16 once."""
    return segment_mean(widen(src), index, num_segments,
                        mask=mask).to(src.dtype)


class GNBlock(nn.Module):
    """Parameters of one GN block: an edge MLP and a node MLP."""

    def __init__(self, edge_arch, node_arch, device=None):
        super().__init__()
        self.edge_mlp = MLP(*edge_arch, device=device)
        self.node_mlp = MLP(*node_arch, device=device)


def gn_block(block: GNBlock, v: torch.Tensor, e: torch.Tensor,
             senders: torch.Tensor, receivers: torch.Tensor, *,
             fixed_k: Optional[int] = None,
             edge_mask: Optional[torch.Tensor] = None,
             out_selu: bool = False, skip_e_out: bool = False,
             sender_sort=None, sender_table=None, cd: torch.dtype = F32):
    """One message-passing step: edge update, mean aggregation onto
    receivers, node update.  Returns ``(v', e')``.

    The edge MLP sees ``[e, v_sender, v_receiver]`` and the node MLP
    ``[aggr, v]``; both first layers are split by input so that no concat
    is built.  Aggregation reads the edge state before ``out_selu``.
    ``skip_e_out``: the caller asserts e' has no consumer, and ``e'`` is
    None on every path.  ``sender_sort = (sender_perm, sender_sorted)``
    gives the fixed-k path's sender gather its sorted backward.
    ``sender_table`` (fixed-k path, graph parallel): a function that turns
    the local ``vs = v @ Ws`` into the table that ``senders`` index (the
    halo exchange of ``parallel.graph_parallel``); ``sender_sort`` is
    then the sort of that map.  ``cd``: the compute dtype.
    """
    em, nm = block.edge_mlp, block.node_mlp
    fe, fv = e.shape[1], v.shape[1]
    w1 = em.weights[0]
    if cd != F32:
        v, e = v.to(cd), e.to(cd)
    if fixed_k is not None:
        if edge_mask is not None:
            raise ValueError("the fixed-k path takes no edge mask")
        vs = mm(v, w1[fe:fe + fv], cd)
        if sender_table is not None:
            vs = sender_table(vs)
        return gn_op.gn_block(e, vs, v, senders, fixed_k, chain_of(em),
                              chain_of(nm), out_selu=out_selu,
                              skip_e_out=skip_e_out, sender_sort=sender_sort)
    h = (mm(e, w1[:fe], cd) + take_rows(mm(v, w1[fe:fe + fv], cd), senders)
         + take_rows(mm(v, w1[fe + fv:], cd), receivers)
         + bias(em.biases[0], cd))
    e_new = apply_mlp_tail(em, h, start=1, cd=cd)
    aggr = act_mean(e_new, receivers, v.shape[0], mask=edge_mask)
    nw1 = nm.weights[0]
    fa = aggr.shape[1]
    hn = mm(aggr, nw1[:fa], cd) + mm(v, nw1[fa:], cd) + bias(nm.biases[0], cd)
    v_new = apply_mlp_tail(nm, hn, start=1, cd=cd)
    if out_selu:
        v_new, e_new = selu(v_new), selu(e_new)
    return v_new, (None if skip_e_out else e_new)


def down_mp(mlp: MLP, field: torch.Tensor, e_rel: torch.Tensor,
            parent: torch.Tensor, num_coarse: int, *,
            node_mask: Optional[torch.Tensor] = None,
            cd: torch.dtype = F32) -> torch.Tensor:
    """MuS pooling: the MLP over ``[e_rel, field]`` of every fine node,
    mean per coarse parent, then tanh."""
    e = apply_mlp(mlp, torch.cat([e_rel, widen(field)], dim=-1), cd)
    return torch.tanh(act_mean(e, parent, num_coarse, mask=node_mask))


def pool_edges(edge_attr: torch.Tensor, fine_to_coarse: torch.Tensor,
               num_coarse_edges: int) -> torch.Tensor:
    """Mean of fine edge features per coarse edge; ``fine_to_coarse`` is -1
    for dropped self-loops and pad edges."""
    return act_mean(edge_attr, fine_to_coarse, num_coarse_edges,
                    mask=fine_to_coarse >= 0)


def up_mp(mlp: MLP, field_coarse: torch.Tensor, e_rel: torch.Tensor,
          parent: torch.Tensor, field_fine_skip: torch.Tensor, *,
          cd: torch.dtype = F32) -> torch.Tensor:
    """MuS unpooling: the MLP over ``[-e_rel, field_coarse[parent], skip]``,
    then tanh."""
    x = torch.cat([-e_rel, widen(take_rows(field_coarse, parent)),
                   widen(field_fine_skip)], dim=-1)
    return torch.tanh(apply_mlp(mlp, x, cd))


# --------------------------------------------------------------------- REMuS
class EdgeMPBlock(nn.Module):
    """Parameters of one REMuS EdgeMP or DownEdgeMP block: an angle MLP
    and an edge MLP."""

    def __init__(self, angle_arch, edge_arch, device=None):
        super().__init__()
        self.angle_mlp = MLP(*angle_arch, device=device)
        self.edge_mlp = MLP(*edge_arch, device=device)


def _line_graph_gn(block: EdgeMPBlock, src: torch.Tensor, e: torch.Tensor,
                   a: torch.Tensor, angle_src: torch.Tensor, out_selu: bool,
                   skip_a_out: bool, angle_sort, cd: torch.dtype,
                   sender_table=None):
    """The GN block on (angle, edge) states whose angle sources are rows of
    ``src``: ``(e', a')`` through ``ops.gn_block``, the table being
    ``src @ Ws`` (or ``sender_table`` of it)."""
    am = block.angle_mlp
    fa = a.shape[1]
    if cd != F32:
        e, a = e.to(cd), a.to(cd)
    es = mm(src, am.weights[0][fa:fa + src.shape[1]], cd)
    if sender_table is not None:
        es = sender_table(es)
    return gn_op.gn_block(a, es, e, angle_src.reshape(-1),
                          angle_src.shape[1], chain_of(am),
                          chain_of(block.edge_mlp), out_selu=out_selu,
                          skip_e_out=skip_a_out, sender_sort=angle_sort)


def edge_mp(block: EdgeMPBlock, e: torch.Tensor, a: torch.Tensor,
            angle_src: torch.Tensor, *, out_selu: bool = False,
            skip_a_out: bool = False, angle_sort=None,
            cd: torch.dtype = F32, sender_table=None):
    """REMuS message passing on the line graph (``_edge_mp_impl``,
    ``graphs4cfd_tpu/nn/blocks.py:405``).  The angle MLP sees
    ``[a, e[angle_src], e_receiver]``, angles aggregate onto their
    receiving edge by the mean over k (before ``out_selu``), and the edge
    MLP sees ``[aggr, e]``.  ``a`` is ``[E*k, fa]``, ``angle_src`` ``[E,
    k]``.  Returns ``(e', a')``; ``a'`` is None under ``skip_a_out`` (the
    caller asserts it has no consumer, and the kernel does not store it).
    ``angle_sort = (perm, sorted)`` of the flattened ``angle_src``
    (``loader.attach_angle_sorts``) is the order in which the backward sums
    the angle-source cotangents (sorted on the device if not given).
    ``sender_table`` (graph parallel): a function that turns the local
    ``es = e @ Ws [E, H]`` into the table that ``angle_src`` indexes (the
    folded halo exchange of ``parallel.graph_parallel``); ``angle_src``
    and ``angle_sort`` are then that table's map and its sort.
    """
    return _line_graph_gn(block, e, e, a, angle_src, out_selu, skip_a_out,
                          angle_sort, cd, sender_table)


def down_edge_mp(block: EdgeMPBlock, e_fine: torch.Tensor,
                 e_coarse: torch.Tensor, a12: torch.Tensor,
                 angle_src12: torch.Tensor, *, out_selu: bool = False,
                 angle_sort=None, cd: torch.dtype = F32,
                 sender_table=None) -> torch.Tensor:
    """REMuS pooling over inter-level angles (``down_edge_mp``,
    ``graphs4cfd_tpu/nn/blocks.py:536``): the GN block on (inter-level
    angle, coarse edge) states whose sources are the fine edges, so the
    table ``e_fine @ Ws`` has more rows than there are coarse edges.
    ``a12`` is ``[Ec*k, fa]``, ``angle_src12`` ``[Ec, k]`` fine edge ids;
    ``angle_sort`` and ``sender_table`` (graph parallel: the halo exchange
    of the fine-edge rows) as in ``edge_mp``.  Returns the new coarse edge
    states; the updated angles have no consumer and are not stored."""
    return _line_graph_gn(block, e_fine, e_coarse, a12, angle_src12,
                          out_selu, True, angle_sort, cd, sender_table)[0]


def edge_scalar_to_node_vector(edge_attr: torch.Tensor,
                               unit_vec_pinv: torch.Tensor) -> torch.Tensor:
    """Solve each node's ``[e_ij][u_j] = [u_ij]`` through the precomputed
    pinverses (``graphs4cfd_tpu/nn/blocks.py:608``): ``edge_attr [V*k,
    F]`` receiver-sorted and ``unit_vec_pinv [V, 2, k]`` give node vectors
    ``[V, F, 2]`` (f32 from bf16 ``edge_attr``, as JAX promotes)."""
    V, _, k = unit_vec_pinv.shape
    return (unit_vec_pinv @ widen(edge_attr).reshape(V, k, -1)).transpose(
        1, 2)


# the reference's camelCase name
edgeScalarToNodeVector = edge_scalar_to_node_vector


def project_node_vectors_to_edges(node_vec: torch.Tensor,
                                  unit_vec: torch.Tensor) -> torch.Tensor:
    """Project node vectors ``[V, F, 2]`` onto their receiving edges' unit
    vectors ``[E, 2]``: edge scalars ``[E, F]``
    (``graphs4cfd_tpu/nn/blocks.py:623``).  Every REMuS level has the
    fixed-k layout (``E = k*V``, receivers ``repeat(arange(V), k)``), so
    the receiver gather is a broadcast."""
    E = unit_vec.shape[0]
    V, F, _ = node_vec.shape
    if E % V:
        raise ValueError(f"{E} edges are not a fixed-k layout of {V} nodes")
    g = node_vec[:, None].expand(V, E // V, F, 2).reshape(E, F, 2)
    return (g * unit_vec[:, None, :]).sum(dim=-1)


def up_edge_mp(mlp: MLP, e_coarse: torch.Tensor,
               unit_pinv_coarse: torch.Tensor, interp_idx: torch.Tensor,
               interp_w: torch.Tensor, unit_vec_fine: torch.Tensor,
               e_fine_skip: torch.Tensor, *,
               cd: torch.dtype = F32, interp_exchange=None,
               take=take_rows) -> torch.Tensor:
    """REMuS unpooling (``up_edge_mp``, ``graphs4cfd_tpu/nn/blocks.py:643``):
    coarse edge scalars -> coarse node vectors (pinverse) -> k-NN
    interpolated fine node vectors -> fine edge scalars -> the MLP over
    ``[e1, skip]``, whose first layer is split by input so that no concat
    is built and whose tail runs through ``ops.fused_mlp``.  Graph
    parallel: ``interp_exchange`` extends the coarse node vectors with the
    halo rows before the interpolation (``interp_idx`` is then the map into
    that table), and ``take`` is the interpolation's gather
    (``ops.interp.knn_interpolate``)."""
    v_coarse = edge_scalar_to_node_vector(e_coarse, unit_pinv_coarse)
    Vc, F, _ = v_coarse.shape
    src = v_coarse.reshape(Vc, F * 2)
    if interp_exchange is not None:
        src = interp_exchange(src)
    v_fine = knn_interpolate(src, interp_idx, interp_w,
                             take).reshape(-1, F, 2)
    e1 = project_node_vectors_to_edges(v_fine, unit_vec_fine)
    w1 = mlp.weights[0]
    h = mm(e1, w1[:F], cd) + mm(e_fine_skip, w1[F:], cd) + bias(mlp.biases[0],
                                                               cd)
    return apply_mlp_tail(mlp, h, start=1, cd=cd)


# ------------------------------------------ the reference's one-call helpers
def _host(x) -> np.ndarray:
    """``x`` as a numpy array (a tensor from any device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def restriction(graph, coarse_mask, edge_attr, edge_index, num_nodes,
                device=None):
    """The reference's ``restriction`` (``graphs4cfd_tpu/nn/blocks.py:685``):
    renumber a fine-indexed coarse edge set ``edge_index [2, E]`` into the
    compacted indices of the nodes ``coarse_mask`` keeps, and set the
    graph's ``senders``, ``receivers`` (int32) and ``edge_attr``.  The
    indices go to ``device``, or to ``coarse_mask``'s device if it is a
    tensor, else to the card.  The models never call it: their coarse
    levels are built in local numbering by the transforms.  For users
    porting reference-style code."""
    if device is None:
        device = (coarse_mask.device if isinstance(coarse_mask, torch.Tensor)
                  else "cuda")
    mask = torch.as_tensor(coarse_mask, device=device)
    mask2idx = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    edge_index = torch.as_tensor(edge_index, device=device).long()
    graph.senders = mask2idx[edge_index[0]]
    graph.receivers = mask2idx[edge_index[1]]
    graph.edge_attr = edge_attr
    return graph


def lstsq(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched least squares ``AX = B`` (``graphs4cfd_tpu/nn/blocks.py:
    702``): through ``ops.pinv_k2`` for a ``[N, k, 2]`` stack, else
    ``torch.linalg.lstsq``."""
    if A.dim() == 3 and A.shape[-1] == 2:
        return pinv_k2(A) @ B
    return torch.linalg.lstsq(A, B).solution


def pool_edge(idxHR_to_idxLR, senders, receivers, edge_attr, aggr="mean",
              device=None):
    """The reference's one-call ``pool_edge`` (``graphs4cfd_tpu/nn/blocks.py:
    711``): the host structure (``ops.pool_edge_structure``), then the mean
    of the fine edge features per coarse edge (``pool_edges``) for
    ``aggr="mean"``, else their sum.  Returns ``((coarse_senders,
    coarse_receivers) as numpy, features)``; the features are pooled on
    ``device``, or on ``edge_attr``'s device if it is a tensor, else on the
    card.  The models build the structure once and pool with
    ``pool_edges``."""
    cs, cr, f2c, _ = pool_edge_structure(_host(idxHR_to_idxLR),
                                         _host(senders), _host(receivers))
    if device is None:
        device = (edge_attr.device if isinstance(edge_attr, torch.Tensor)
                  else "cuda")
    edge_attr = torch.as_tensor(edge_attr, device=device)
    f2c = torch.from_numpy(f2c).to(edge_attr.device)
    if aggr == "mean":
        attr = pool_edges(edge_attr, f2c, len(cs))
    else:
        attr = segment_sum(edge_attr, f2c, len(cs), mask=f2c >= 0)
    return (cs, cr), attr
