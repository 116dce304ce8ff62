"""Static structure of MuS edge pooling (numpy).

Port of ``pool_edge_structure`` (``graphs4cfd_tpu/ops/coarsen.py:43-80``):
which coarse edge each fine edge lands in after endpoint remapping,
self-loop removal and coalescing.  The forward pass then needs only one
segment-mean over fine edge features (``nn.blocks.pool_edges``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def pool_edge_structure(parent: np.ndarray,
                        senders: np.ndarray,
                        receivers: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Map each fine edge ``(s, r)`` to ``(parent[s], parent[r])``, drop
    self-loops and coalesce duplicates.  Coarse edges are ordered by
    ``(receiver, sender)`` ascending, i.e. receiver-sorted.

    Returns ``(coarse_senders [Ec], coarse_receivers [Ec],
    fine_to_coarse [Ef] (-1 for dropped self-loops), coarse_count [Ec])``,
    all int32.
    """
    cs = parent[np.asarray(senders)]
    cr = parent[np.asarray(receivers)]
    keep = cs != cr
    key = cr.astype(np.int64) * (parent.max() + 1 if parent.size else 1) + cs
    key = np.where(keep, key, -1)
    uniq, inverse = np.unique(key, return_inverse=True)
    if uniq.size > 0 and uniq[0] == -1:
        fine_to_coarse = (inverse - 1).astype(np.int32)
        uniq = uniq[1:]
    else:
        fine_to_coarse = inverse.astype(np.int32)
    denom = int(parent.max()) + 1 if parent.size else 1
    coarse_receivers = (uniq // denom).astype(np.int32)
    coarse_senders = (uniq % denom).astype(np.int32)
    coarse_count = np.bincount(fine_to_coarse[fine_to_coarse >= 0],
                               minlength=uniq.shape[0]).astype(np.int32)
    return coarse_senders, coarse_receivers, fine_to_coarse, coarse_count
