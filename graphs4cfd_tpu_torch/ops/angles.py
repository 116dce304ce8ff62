"""Angle indices and features of REMuS-GNN's line graphs (numpy).

Port of ``graphs4cfd_tpu/ops/angles.py:27-97``.  In the canonical
receiver-sorted exact-k layout the incoming edges of node ``v`` are rows
``[v*k, (v+1)*k)``, so the k angles that feed an edge are found by index
arithmetic and come out grouped by receiving edge: ``angle_src [A, k]``
lists, for edge ``a``, the k sender edges of its angles.  Aggregation on
the device is then a mean over the k axis.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _unit_and_size(edge_attr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    size = np.linalg.norm(edge_attr, axis=1, keepdims=True)
    return edge_attr / size, size


def _angle_attr(u_in, s_in, u_out, s_out, k):
    """``[|e_in|, |e_out|, cos, sin]`` of each (incoming, outgoing) pair."""
    u_out = u_out[:, None, :]
    cos = (u_in * u_out).sum(axis=-1)
    sin = u_in[..., 0] * u_out[..., 1] - u_in[..., 1] * u_out[..., 0]
    n = u_out.shape[0]
    return np.concatenate([
        s_in, np.broadcast_to(s_out[:, None, :], (n, k, 1)),
        cos[..., None], sin[..., None]], axis=-1).astype(np.float32)


def extend_graph(senders: np.ndarray, edge_attr: np.ndarray, k: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unit vectors and intra-level angles of one level.

    Returns ``unit_vec`` f32 ``[E, 2]``; ``angle_src`` int32 ``[E, k]``, for
    edge ``i -> j`` the incoming edges of ``i`` (rows ``i*k + 0..k-1``);
    ``angle_attr`` f32 ``[E, k, 4]``.
    """
    senders = np.asarray(senders)
    unit_vec, size = _unit_and_size(np.asarray(edge_attr, dtype=np.float32))
    angle_src = (senders.astype(np.int64)[:, None] * k
                 + np.arange(k)[None, :]).astype(np.int32)
    angle_attr = _angle_attr(unit_vec[angle_src], size[angle_src], unit_vec,
                             size, k)
    return unit_vec.astype(np.float32), angle_src, angle_attr


def inter_level_angles(fine_edge_attr: np.ndarray,
                       coarse_local_senders: np.ndarray,
                       coarse_edge_attr: np.ndarray,
                       coarse_to_fine_node: np.ndarray, k: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Angles from a fine level into the next coarser one.

    For each coarse edge ``j -> m`` the k angles come from the k fine edges
    entering ``j`` as a fine node (``coarse_to_fine_node[j]``).  Returns
    ``angle_src`` int32 ``[Ec, k]`` (fine edge ids) and ``angle_attr`` f32
    ``[Ec, k, 4]``.  (The JAX function's unused first argument is left
    out.)
    """
    coarse_local_senders = np.asarray(coarse_local_senders)
    fine_sender_node = np.asarray(coarse_to_fine_node)[coarse_local_senders]
    angle_src = (fine_sender_node.astype(np.int64)[:, None] * k
                 + np.arange(k)[None, :]).astype(np.int32)
    u1, s1 = _unit_and_size(np.asarray(fine_edge_attr, dtype=np.float32))
    u2, s2 = _unit_and_size(np.asarray(coarse_edge_attr, dtype=np.float32))
    return angle_src, _angle_attr(u1[angle_src], s1[angle_src], u2, s2, k)
