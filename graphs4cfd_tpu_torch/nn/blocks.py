"""MuS blocks (port of ``graphs4cfd_tpu/nn/blocks.py:141-403``).

* ``gn_block``: the GN block.  A fixed-k level without a mask (level 1)
  runs the fused kernel ``ops.gn_block``; a coarse level runs the masked
  segment path with its MLP tails through ``ops.fused_mlp``.
* ``down_mp``, ``pool_edges``, ``up_mp``: MuS pooling and unpooling.

Gradients: the kernels' backwards come with ``ops.fused_mlp`` and
``ops.gn_block``; the rest goes through autograd.  No op here goes back
through float atomics on CUDA: a gather ``x[idx]`` goes back through
``index_put_(accumulate=True)`` (a stable sort, then each row's sum in
order), the level-1 sender gather through ``ops.gn_block``'s sorted
per-sender sums (over the graph's ``sender_perm``/``sender_sorted``), and
the segment means' backward is a gather.  ``index_select`` and
``repeat_interleave``, whose backward is ``index_add_``, are not used.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import gn_block as gn_op
from ..ops.fused_mlp import selu
from ..ops.segment import segment_mean
from .mlp import MLP, apply_mlp, apply_mlp_tail, chain_of


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
             sender_sort=None):
    """One message-passing step: edge update, mean aggregation onto
    receivers, node update.  Returns ``(v', e')``.

    The edge MLP sees ``[e, v_sender, v_receiver]`` and the node MLP
    ``[aggr, v]``; both first layers are split by input so that no concat
    is built.  Aggregation reads the edge state before ``out_selu``.
    ``skip_e_out``: the caller asserts e' has no consumer, and ``e'`` is
    None on every path.  ``sender_sort = (sender_perm, sender_sorted)``
    gives the fixed-k path's sender gather its sorted backward.
    """
    em, nm = block.edge_mlp, block.node_mlp
    fe, fv = e.shape[1], v.shape[1]
    w1 = em.weights[0]
    if fixed_k is not None:
        if edge_mask is not None:
            raise ValueError("the fixed-k path takes no edge mask")
        vs = v @ w1[fe:fe + fv]
        return gn_op.gn_block(e, vs, v, senders, fixed_k, chain_of(em),
                              chain_of(nm), out_selu=out_selu,
                              skip_e_out=skip_e_out, sender_sort=sender_sort)
    h = (e @ w1[:fe] + (v @ w1[fe:fe + fv])[senders.long()]
         + (v @ w1[fe + fv:])[receivers.long()] + em.biases[0])
    e_new = apply_mlp_tail(em, h, start=1)
    aggr = segment_mean(e_new, receivers, v.shape[0], mask=edge_mask)
    nw1 = nm.weights[0]
    fa = aggr.shape[1]
    hn = aggr @ nw1[:fa] + v @ nw1[fa:] + nm.biases[0]
    v_new = apply_mlp_tail(nm, hn, start=1)
    if out_selu:
        v_new, e_new = selu(v_new), selu(e_new)
    return v_new, (None if skip_e_out else e_new)


def down_mp(mlp: MLP, field: torch.Tensor, e_rel: torch.Tensor,
            parent: torch.Tensor, num_coarse: int, *,
            node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MuS pooling: the MLP over ``[e_rel, field]`` of every fine node,
    mean per coarse parent, then tanh."""
    e = apply_mlp(mlp, torch.cat([e_rel, field], dim=-1))
    return torch.tanh(segment_mean(e, parent, num_coarse, mask=node_mask))


def pool_edges(edge_attr: torch.Tensor, fine_to_coarse: torch.Tensor,
               num_coarse_edges: int) -> torch.Tensor:
    """Mean of fine edge features per coarse edge; ``fine_to_coarse`` is -1
    for dropped self-loops and pad edges."""
    return segment_mean(edge_attr, fine_to_coarse, num_coarse_edges,
                        mask=fine_to_coarse >= 0)


def up_mp(mlp: MLP, field_coarse: torch.Tensor, e_rel: torch.Tensor,
          parent: torch.Tensor, field_fine_skip: torch.Tensor
          ) -> torch.Tensor:
    """MuS unpooling: the MLP over ``[-e_rel, field_coarse[parent], skip]``,
    then tanh."""
    x = torch.cat([-e_rel, field_coarse[parent.long()], field_fine_skip],
                  dim=-1)
    return torch.tanh(apply_mlp(mlp, x))
