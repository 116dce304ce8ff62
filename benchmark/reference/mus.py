"""Plain reference of MuS-GNN (Lino et al. 2022, multi-scale GNN with grid
clustering), on a block of samples joined as one unpadded graph.

One residual time step: the node encoder over ``[field, glob, omega]``
and the edge encoder over the edge vectors, each followed by SELU; then
the arch's entries in order: ``mp*`` a GN block at the current level,
``down_mp{h}{l}`` the MLP over ``[e_rel, v]`` of every fine node averaged
per cluster and passed through tanh (the edge states averaged per coarse
edge), ``up_mp{l}{h}`` the MLP over ``[-e_rel, v_coarse[parent],
v_skip]`` through tanh (the edge states restored from before the pool);
last the decoder, added to the newest fields.
"""
from __future__ import annotations

import torch

from .nn import Numerics, Segments, concat, gn, mlp, selu

GN_PARTS = ("edge_mlp", "node_mlp")


def tensors(samples, device) -> dict:
    """The arrays that a step reads, of the samples joined into one graph
    (each sample's indices offset by the sizes of the samples before it),
    on ``device``, with the segment means worked out."""
    t = {}

    def join(key, space=None):
        t[key] = concat([g[key] for g in samples],
                        None if space is None else sizes[space])

    levels = 1
    while f"parent_{levels + 1}" in samples[0]:
        levels += 1
    sizes = {("V", 1): [len(g["pos"]) for g in samples],
             ("E", 1): [len(g["senders"]) for g in samples]}
    for l in range(2, levels + 1):
        sizes[("V", l)] = [g[f"V_{l}"] for g in samples]
        sizes[("E", l)] = [len(g[f"senders_{l}"]) for g in samples]
    for key in ("edge_attr", "glob", "omega"):
        join(key)
    t["senders_1"] = concat([g["senders"] for g in samples], sizes[("V", 1)])
    t["receivers_1"] = concat([g["receivers"] for g in samples],
                              sizes[("V", 1)])
    for l in range(2, levels + 1):
        join(f"parent_{l}", ("V", l))
        join(f"e_rel_{l}")
        join(f"senders_{l}", ("V", l))
        join(f"receivers_{l}", ("V", l))
        join(f"f2c_{l}", ("E", l))
    out = {k: torch.as_tensor(v, device=device) for k, v in t.items()}
    for l in range(1, levels + 1):
        V, E = sum(sizes[("V", l)]), sum(sizes[("E", l)])
        out[f"agg_{l}"] = Segments(t[f"receivers_{l}"], V, device)
        if l > 1:
            out[f"pool_{l}"] = Segments(t[f"parent_{l}"], V, device)
            out[f"epool_{l}"] = Segments(t[f"f2c_{l}"], E, device)
    return out


def step(W: dict, arch: dict, t: dict, field: torch.Tensor,
         num: Numerics) -> torch.Tensor:
    """One residual time step of a block ``t`` (``tensors``) from the field
    window ``field [V, n_in * nf]``; returns the new fields ``[V, nf]``."""
    nf = int(arch["decoder"][1][-1])
    v = selu(mlp(W, "layers.node_encoder",
                 torch.cat([field, t["glob"], t["omega"]], dim=1), num))
    e = selu(mlp(W, "layers.edge_encoder", t["edge_attr"], num))
    level, skips = 1, []
    for name in arch:
        if name in ("node_encoder", "edge_encoder", "decoder"):
            continue
        if name.startswith("down_mp"):
            tgt = int(name[-1])
            skips.append((v, e))
            h = mlp(W, f"layers.{name}",
                    torch.cat([t[f"e_rel_{tgt}"], v], dim=1), num)
            v = torch.tanh(t[f"pool_{tgt}"].mean(h))
            e = t[f"epool_{tgt}"].mean(e)
            level = tgt
        elif name.startswith("up_mp"):
            src = int(name[len("up_mp")])
            v_skip, e = skips.pop()
            x = torch.cat([-t[f"e_rel_{src}"], v[t[f"parent_{src}"]],
                           v_skip], dim=1)
            v = torch.tanh(mlp(W, f"layers.{name}", x, num))
            level = src - 1
        else:
            v, e = gn(W, f"layers.{name}", GN_PARTS, v, v, e,
                      t[f"senders_{level}"], t[f"receivers_{level}"],
                      t[f"agg_{level}"].mean, num)
    return field[:, -nf:] + mlp(W, "layers.decoder", v, num)
