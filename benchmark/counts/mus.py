"""One MuS-GNN step's kernels and products, from the arch and the batch's
valid sizes ``V1, E1, V2, E2, ...`` (nodes and edges of each level).

Kernels of a step: the encoders and the decoder as chain kernels; each
level-1 MP layer as one GN-block kernel (its e' not stored when an up
step or the decoder follows); each coarse MP layer's edge and node MLP
tails as chain kernels (their first layers are plain products); each
down and up MLP as a chain kernel.  In training each has its backward
(the encoders' without ``dx``).
"""
from __future__ import annotations

from . import (chain_bwd, chain_flops, chain_fwd, gn_bwd, gn_flops, gn_fwd)


def _dims(spec):
    return [int(spec[0])] + [int(w) for w in spec[1]]


def _walk(arch):
    """``(kind, name, level, spec, e_out)`` for every entry, in order."""
    level, out = 1, []
    names = list(arch)
    for i, name in enumerate(names):
        spec = arch[name]
        if name in ("node_encoder", "edge_encoder", "decoder"):
            out.append((name, name, 1, spec, True))
        elif name.startswith("down_mp"):
            out.append(("down", name, level, spec, True))
            level = int(name[-1])
        elif name.startswith("up_mp"):
            level = int(name[len("up_mp")]) - 1
            out.append(("up", name, level, spec, True))
        else:
            nxt = names[i + 1] if i + 1 < len(names) else "decoder"
            e_out = not (level == 1 and nxt.startswith(("up_mp", "decoder")))
            out.append(("mp", name, level, spec, e_out))
    return out


def _gn_shape(spec):
    ed, nd = _dims(spec[0]), _dims(spec[1])
    fv = nd[0] - ed[-1]
    return ed, nd, ed[0] - 2 * fv, fv, bool(spec[0][2])


def kernels(arch, sz, train, act):
    out = []
    V, E = (lambda l: sz[f"V{l}"]), (lambda l: sz[f"E{l}"])
    for kind, name, l, spec, e_out in _walk(arch):
        if kind == "mp" and l == 1:
            ed, nd, fe, fv, ln = _gn_shape(spec)
            args = (E(1), V(1), V(1), fe, fv, ed, nd, ln, e_out, act)
            out.append(gn_fwd(name, *args))
            if train:
                out.append(gn_bwd(name, *args))
            continue
        if kind == "mp":
            ed, nd, _, _, ln = _gn_shape(spec)
            chains = [(E(l), ed[1:], ln, True), (V(l), nd[1:], ln, True)]
        else:
            rows = {"node_encoder": V(1), "edge_encoder": E(1),
                    "decoder": V(1), "down": V(l), "up": V(l)}[kind]
            chains = [(rows, _dims(spec), bool(spec[2]),
                       kind not in ("node_encoder", "edge_encoder"))]
        for rows, dims, ln, need_dx in chains:
            out.append(chain_fwd(name, rows, dims, ln, act))
            if train:
                out.append(chain_bwd(name, rows, dims, ln, need_dx, act))
    return out


def model_flops(arch, sz):
    """Every MLP product of one forward step, the GN blocks' first layers
    split by input (the sender table over the nodes)."""
    total = 0
    V, E = (lambda l: sz[f"V{l}"]), (lambda l: sz[f"E{l}"])
    for kind, name, l, spec, _ in _walk(arch):
        if kind == "mp":
            ed, nd, fe, fv, _ = _gn_shape(spec)
            total += gn_flops(E(l), V(l), fe, fv, ed, nd) + 2 * V(l) * fv * ed[1]
        else:
            rows = {"node_encoder": V(1), "edge_encoder": E(1),
                    "decoder": V(1), "down": V(l), "up": V(l)}[kind]
            total += chain_flops(rows, _dims(spec))
    return total
