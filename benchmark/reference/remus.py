"""Plain reference of REMuS-GNN (Lino et al. 2022, rotation-equivariant
multi-scale message passing on edges and edge-edge angles), a block of
samples joined as one unpadded graph.

One residual time step.  Each level ``l`` encodes its edges from the
field of each edge's receiver projected onto the edge's unit vector,
joined with the receiver's ``glob`` and ``omega`` (a coarse node reads
the fine node it was), its angles from ``[|e_in|, |e_out|, cos, sin]``,
and above level 1 its inter-level angles; each encoder is followed by
SELU.  Then the arch's entries in order: ``mp{l}*`` a GN block on level
``l``'s line graph (edges as nodes, angles as edges; SELU on both
outputs), ``down_mp{h}{l}`` the same block from the fine edges to the
coarse ones over the inter-level angles (its new coarse edges kept),
``up_mp{l}{h}`` the coarse edges solved into node vectors (pinverse),
interpolated onto the fine nodes (inverse square distances), projected
onto the fine edges and passed with the fine edges' own states through
the MLP and SELU.  Last the decoder's edge scalars are solved into one
vector a node and added to the newest fields.
"""
from __future__ import annotations

import torch

from .nn import Numerics, concat, gn, mlp, selu

GN_PARTS = ("angle_mlp", "edge_mlp")
NUM_FIELDS = 2


def tensors(samples, device) -> dict:
    """The arrays that a step reads, of the samples joined into one graph
    (each sample's indices offset by the sizes of the samples before it),
    on ``device``."""
    L = samples[0]["levels"]
    V = {l: [len(g[f"pinv_{l}"]) for g in samples] for l in range(1, L + 1)}
    E = {l: [len(g[f"unit_{l}"]) for g in samples] for l in range(1, L + 1)}
    t = {"glob": concat([g["glob"] for g in samples]),
         "omega": concat([g["omega"] for g in samples])}
    for l in range(1, L + 1):
        for key in ("unit", "pinv", "aattr"):
            t[f"{key}_{l}"] = concat([g[f"{key}_{l}"] for g in samples])
        t[f"asrc_{l}"] = concat([g[f"asrc_{l}"] for g in samples], E[l])
        t[f"origin_{l}"] = concat([g[f"origin_{l}"] for g in samples], V[1])
        if l > 1:
            t[f"xattr_{l}"] = concat([g[f"xattr_{l}"] for g in samples])
            t[f"up_w_{l}"] = concat([g[f"up_w_{l}"] for g in samples])
            t[f"xsrc_{l}"] = concat([g[f"xsrc_{l}"] for g in samples],
                                    E[l - 1])
            t[f"up_idx_{l}"] = concat([g[f"up_idx_{l}"] for g in samples],
                                      V[l])
    out = {k: torch.as_tensor(v, device=device) for k, v in t.items()}
    out.update(k=samples[0]["k"], levels=L)
    return out


def _rep(x: torch.Tensor, k: int) -> torch.Tensor:
    """Node rows to the rows of their k incoming edges."""
    return x.repeat_interleave(k, dim=0)


def _receivers(num_edges: int, k: int, device) -> torch.Tensor:
    return torch.arange(num_edges, device=device).repeat_interleave(k)


def step(W: dict, arch: dict, t: dict, field: torch.Tensor,
         num: Numerics) -> torch.Tensor:
    """One residual time step of sample ``t`` (``tensors``) from the field
    window ``field [V, 2 n_in]``; returns the new fields ``[V, 2]``."""
    k, L = t["k"], t["levels"]

    def mean(x):
        # the k angles of an edge are consecutive rows
        return x.reshape(-1, k, x.shape[1]).mean(dim=1)
    e, a, xa = {}, {}, {}
    for l in range(1, L + 1):
        s = "" if l == 1 else str(l)
        o = t[f"origin_{l}"]
        unit = t[f"unit_{l}"]
        proj = (_rep(field[o], k).reshape(unit.shape[0], -1, 2)
                * unit[:, None, :]).sum(dim=-1)
        x = torch.cat([proj, _rep(t["glob"][o], k), _rep(t["omega"][o], k)],
                      dim=1)
        e[l] = selu(mlp(W, f"layers.edge_encoder{s}", x, num))
        a[l] = selu(mlp(W, f"layers.angle_encoder{s}",
                        t[f"aattr_{l}"].reshape(-1, 4), num))
        if l > 1:
            xa[l] = selu(mlp(W, f"layers.angle_encoder{l - 1}{l}",
                             t[f"xattr_{l}"].reshape(-1, 4), num))
    for name in arch:
        if name.startswith(("angle_encoder", "edge_encoder")) \
                or name == "decoder":
            continue
        if name.startswith("down_mp"):
            tgt = int(name[-1])
            E = e[tgt].shape[0]
            e[tgt], _ = gn(W, f"layers.{name}", GN_PARTS, e[tgt - 1], e[tgt],
                           xa[tgt], t[f"xsrc_{tgt}"].reshape(-1),
                           _receivers(E, k, field.device), mean, num)
        elif name.startswith("up_mp"):
            src = int(name[len("up_mp")])
            tgt = src - 1
            Vc = t[f"pinv_{src}"].shape[0]
            vec = (t[f"pinv_{src}"] @ e[src].reshape(Vc, k, -1)).transpose(
                1, 2).reshape(Vc, -1)
            w = t[f"up_w_{src}"][..., None]
            fine = ((vec[t[f"up_idx_{src}"]] * w).sum(dim=1)
                    / w.sum(dim=1)).reshape(-1, vec.shape[1] // 2, 2)
            e1 = (_rep(fine, k) * t[f"unit_{tgt}"][:, None, :]).sum(dim=-1)
            e[tgt] = selu(mlp(W, f"layers.{name}",
                              torch.cat([e1, e[tgt]], dim=1), num))
        else:
            l = int(name[2])
            E = e[l].shape[0]
            e[l], a[l] = gn(W, f"layers.{name}", GN_PARTS, e[l], e[l], a[l],
                            t[f"asrc_{l}"].reshape(-1),
                            _receivers(E, k, field.device), mean, num)
    dec = mlp(W, "layers.decoder", e[1], num)
    V = t["pinv_1"].shape[0]
    out = (t["pinv_1"] @ dec.reshape(V, k, 1)).reshape(V, 2)
    return field[:, -NUM_FIELDS:] + out
