"""Graph container: a padded, multi-level graph as a dict of arrays.

Port of ``graphs4cfd_tpu/graph.py``.  The same ``data`` keys hold numpy
arrays while the host pipeline (``transforms``, ``loader.collate``) builds
the graph, and torch tensors once ``Graph.from_numpy`` or ``.to`` has
moved it to a device.  Non-array values (``fixed_k``, ``num_levels``,
``num_graphs``) are plain attributes of the same dict.

Conventions (as in the JAX package): edges are receiver-sorted; a k-NN
level has exact indegree k, so receiver ``v`` owns edge rows
``[v*k, (v+1)*k)``; node and edge arrays are padded and ``node_mask`` /
``edge_mask`` flag the valid rows.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


class Graph:
    """A batch of (possibly multi-level) graphs as one padded super-graph."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "data", dict(data or {}))

    def __getattr__(self, name):
        if name.startswith("__") or name == "data":
            raise AttributeError(name)
        try:
            return self.data[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self.data[name] = value

    def get(self, name, default=None):
        return self.data.get(name, default)

    def has(self, name: str) -> bool:
        return self.data.get(name) is not None

    def replace(self, **updates) -> "Graph":
        return Graph({**self.data, **updates})

    @property
    def num_nodes(self) -> int:
        return int(self.data["pos"].shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.data["senders"].shape[0])

    @classmethod
    def from_numpy(cls, graph, device="cuda") -> "Graph":
        """Torch copy on ``device`` of a graph (or dict) of numpy arrays."""
        data = graph.data if isinstance(graph, Graph) else graph
        return cls(data).to(device)

    def to(self, device) -> "Graph":
        """Every array as a torch tensor on ``device``; dtypes are kept
        (int32 indices stay int32, as the kernels take them)."""
        def put(x):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(np.ascontiguousarray(x))
            return x.to(device) if isinstance(x, torch.Tensor) else x
        return Graph({k: put(v) for k, v in self.data.items()})

    def numpy(self) -> "Graph":
        conv = lambda x: (x.detach().cpu().numpy()
                          if isinstance(x, torch.Tensor) else x)
        return Graph({k: conv(v) for k, v in self.data.items()})

    def __repr__(self):
        parts = []
        for k in sorted(self.data):
            v = self.data[k]
            parts.append(f"{k}={tuple(v.shape)}:{v.dtype}" if _is_array(v)
                         else f"{k}={v!r}")
        return "Graph(" + ", ".join(parts) + ")"
