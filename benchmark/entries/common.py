"""What both window loops take from the program: its graphs, its model,
its launch counters and kernel names, and the sizes that the work counts
read."""
from __future__ import annotations

import numpy as np


def program_graphs(raws, config: dict) -> list:
    """Each raw cloud through the program's host pipeline: the
    configuration's ``[[name, kwargs], ...]`` of
    ``graphs4cfd_tpu_torch.transforms``."""
    from graphs4cfd_tpu_torch import transforms as T
    from graphs4cfd_tpu_torch.graph import Graph
    chain = [getattr(T, name)(**kwargs) for name, kwargs in
             config["transforms"]]
    out = []
    for raw in raws:
        g = Graph({k: np.array(v) for k, v in raw.items()})
        for t in chain:
            g = t(g)
        out.append(g)
    return out


def program_model(config: dict, W: dict, device, precision: str):
    """The configuration's model class at its arch, holding the weights
    ``W``, in ``precision``'s compute dtype."""
    import torch
    from graphs4cfd_tpu_torch import nn as PN
    model = getattr(PN, config["class"])(arch=config["arch"], device=device)
    model.load_state_dict(W)
    model.compute_dtype = (torch.bfloat16 if precision == "bf16"
                           else torch.float32)
    return model


def launches() -> int:
    """Every kernel launch the program has counted so far."""
    from graphs4cfd_tpu_torch import ops
    return sum(ops.launch_counts().values())


def kernel_names() -> list:
    """The ``__global__`` names of the program's kernels."""
    from graphs4cfd_tpu_torch import ops
    return sorted(set(ops.kernel_names().values()))


def sizes(graphs) -> dict:
    """Valid nodes ``V<l>`` and edges ``E<l>`` of each level, and ``k``,
    of a list of sample graphs or of one collated batch (its masks)."""
    if not isinstance(graphs, (list, tuple)):
        g = graphs
        out = {"V1": int(np.asarray(g.node_mask).sum()),
               "E1": int(np.asarray(g.edge_mask).sum()), "k": g.fixed_k}
        l = 2
        while g.has(f"node_mask_{l}"):
            out[f"V{l}"] = int(np.asarray(g.data[f"node_mask_{l}"]).sum())
            out[f"E{l}"] = int(np.asarray(g.data[f"edge_mask_{l}"]).sum())
            l += 1
        return out
    out = {"V1": sum(g.pos.shape[0] for g in graphs),
           "E1": sum(g.senders.shape[0] for g in graphs),
           "k": graphs[0].fixed_k}
    l = 2
    while graphs[0].has(f"pos_{l}"):
        out[f"V{l}"] = sum(g.data[f"pos_{l}"].shape[0] for g in graphs)
        out[f"E{l}"] = sum(g.data[f"senders_{l}"].shape[0] for g in graphs)
        l += 1
    return out

