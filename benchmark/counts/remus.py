"""One REMuS-GNN step's kernels and products, from the arch and the
batch's valid sizes ``V1, E1, ...`` and ``k`` (level ``l`` has ``k E_l``
angles, and above level 1 ``k E_l`` inter-level angles).

Kernels of a step: every encoder and the decoder as chain kernels; each
EdgeMP layer as one GN-block kernel on its level's line graph (its angles
not stored after a level's last layer); each down layer as one GN-block
kernel over the inter-level angles, its table the fine edges (angles not
stored); each up MLP's tail as a chain kernel (its first layer is a plain
product).  In training each has its backward (the encoders' without
``dx``).
"""
from __future__ import annotations

from . import (chain_bwd, chain_flops, chain_fwd, gn_bwd, gn_flops, gn_fwd)


def _dims(spec):
    return [int(spec[0])] + [int(w) for w in spec[1]]


def _gn_shape(spec):
    ed, nd = _dims(spec[0]), _dims(spec[1])
    fv = nd[0] - ed[-1]
    return ed, nd, ed[0] - 2 * fv, fv, bool(spec[0][2])


def _walk(arch, sz):
    """``(kind, name, spec, rows...)`` for every entry, in order."""
    k = sz["k"]
    E = lambda l: sz[f"E{l}"]
    last = {}
    for name in arch:
        if name.startswith("mp"):
            last[int(name[2])] = name
    out = []
    for name, spec in arch.items():
        if name.startswith("edge_encoder"):
            out.append(("chain", name, spec, E(int(name[12:] or 1)), False))
        elif name.startswith("angle_encoder"):
            tag = name[13:]
            l = int(tag[-1]) if tag else 1
            out.append(("chain", name, spec, k * E(l), False))
        elif name == "decoder":
            out.append(("chain", name, spec, E(1), True))
        elif name.startswith("down_mp"):
            l = int(name[-1])
            out.append(("gn", name, spec, (k * E(l), E(l), E(l - 1)), False))
        elif name.startswith("up_mp"):
            out.append(("up", name, spec, E(int(name[len("up_mp")]) - 1),
                        True))
        else:
            l = int(name[2])
            out.append(("gn", name, spec, (k * E(l), E(l), E(l)),
                        last[l] != name))
    return out


def kernels(arch, sz, train, act):
    out = []
    for kind, name, spec, rows, flag in _walk(arch, sz):
        if kind == "gn":
            ed, nd, fe, fv, ln = _gn_shape(spec)
            args = (*rows, fe, fv, ed, nd, ln, flag, act)
            out.append(gn_fwd(name, *args))
            if train:
                out.append(gn_bwd(name, *args))
            continue
        dims, ln = _dims(spec), bool(spec[2])
        if kind == "up":
            dims = dims[1:]
        out.append(chain_fwd(name, rows, dims, ln, act))
        if train:
            out.append(chain_bwd(name, rows, dims, ln, flag, act))
    return out


def model_flops(arch, sz):
    """Every MLP product of one forward step (the GN blocks' first layers
    split by input, the sender table over its own rows), and the
    projections: the pinverse solves, the interpolation and the projection
    onto the fine edges of each up step, and the decoder's solve."""
    k, total = sz["k"], 0
    for kind, name, spec, rows, _ in _walk(arch, sz):
        if kind == "gn":
            ed, nd, fe, fv, _ = _gn_shape(spec)
            A, E, S = rows
            total += gn_flops(A, E, fe, fv, ed, nd) + 2 * S * fv * ed[1]
        elif kind == "up":
            F = int(spec[1][-1])
            src = int(name[len("up_mp")])
            Vc, Vf = sz[f"V{src}"], sz[f"V{src - 1}"]
            total += (chain_flops(rows, _dims(spec)) + 2 * Vc * 2 * k * F
                      + 2 * Vf * k * 2 * F + 2 * rows * F * 2)
        else:
            total += chain_flops(rows, _dims(spec))
            if name == "decoder":
                total += 2 * sz["V1"] * 2 * k * int(spec[1][-1])
    return total
