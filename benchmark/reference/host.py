"""The plain reference's graph building, in numpy, per sample.

Each function here works out for one point cloud what the program's host
pipeline (``graphs4cfd_tpu_torch.transforms``) works out for it: the
Morton order, the k-NN edges, the grid clusters and pooled edges of
MuS-GNN, and the levels, angles, pinverses and interpolation weights of
REMuS-GNN.  The algorithms are frozen copies of the JAX package's host
code as the port copied it (``ops/order.py``, ``ops/voxel.py``,
``ops/coarsen.py``, ``ops/angles.py``, ``ops/linalg.py``,
``ops/interp.py``), with the k-NN done by brute force.  Nothing here is
padded: a sample is a dict of unpadded arrays; ``build`` runs the
configuration's transform list over it by name.
"""
from __future__ import annotations

import numpy as np

_NODE_KEYS = ("pos", "field", "omega", "target", "bound", "glob")
_CHUNK = 4096


# ------------------------------------------------------------ Morton order
def _part1by1(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32) & np.uint32(0x0000FFFF)
    x = (x | (x << 8)) & np.uint32(0x00FF00FF)
    x = (x | (x << 4)) & np.uint32(0x0F0F0F0F)
    x = (x | (x << 2)) & np.uint32(0x33333333)
    x = (x | (x << 1)) & np.uint32(0x55555555)
    return x


def morton_perm(pos: np.ndarray) -> np.ndarray:
    """The nodes in Z-order of their min-max normalised 2-D positions (16
    bits an axis), ties kept in index order."""
    pos = np.asarray(pos, dtype=np.float64)
    lo = pos.min(axis=0)
    span = pos.max(axis=0) - lo
    span[span == 0] = 1.0
    q = np.minimum(((pos - lo) / span * 65536.0).astype(np.uint32), 65535)
    code = (_part1by1(q[:, 0]).astype(np.uint64)
            | (_part1by1(q[:, 1]).astype(np.uint64) << np.uint64(1)))
    return np.argsort(code, kind="stable")


# -------------------------------------------------------------------- k-NN
def knn(x: np.ndarray, queries: np.ndarray, k: int,
        exclude_self: bool = False, device="cpu") -> np.ndarray:
    """The k nearest rows of ``x`` for each query, nearest first (ties by
    index), by brute force over exact float64 squared distances, in plain
    PyTorch on ``device``."""
    import torch
    xs = torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)
    qs = torch.as_tensor(np.asarray(queries, dtype=np.float64), device=device)
    out = []
    for s in range(0, qs.shape[0], _CHUNK):
        qc = qs[s:s + _CHUNK]
        d2 = torch.zeros(qc.shape[0], xs.shape[0], dtype=torch.float64,
                         device=device)
        for d in range(xs.shape[1]):
            t = qc[:, d:d + 1] - xs[None, :, d]
            d2 += t * t
        if exclude_self:
            r = torch.arange(qc.shape[0], device=device)
            d2[r, r + s] = float("inf")
        dd, part = torch.topk(d2, k + 1, dim=1, largest=False)
        by_index = torch.argsort(part, dim=1)
        part, dd = part.gather(1, by_index), dd.gather(1, by_index)
        by_distance = torch.argsort(dd, dim=1, stable=True)
        out.append(part.gather(1, by_distance)[:, :k])
    return torch.cat(out).cpu().numpy()


def connect_knn(pos: np.ndarray, k: int, device="cpu"):
    """Receiver-sorted k-NN edges: receiver ``v`` owns rows ``[v*k,
    (v+1)*k)``; ``edge_attr`` is receiver minus sender."""
    pos = np.asarray(pos, dtype=np.float32)
    senders = knn(pos, pos, k, exclude_self=True, device=device).reshape(-1)
    receivers = np.repeat(np.arange(pos.shape[0]), k)
    return senders, receivers, (pos[receivers] - pos[senders]).astype(
        np.float32)


# ------------------------------------------------------- MuS grid clusters
def grid_clustering(pos: np.ndarray, cell):
    """Non-empty cells of a grid anchored at the minimum (first axis
    fastest): centroids, each node's cell, and ``(centroid - pos) /
    cell``."""
    pos = np.asarray(pos, dtype=np.float32)
    p64 = pos.astype(np.float64)
    size = np.full(pos.shape[1], float(cell))
    start, end = p64.min(axis=0), p64.max(axis=0)
    num_cells = np.floor((end - start) / size).astype(np.int64) + 1
    c = np.minimum(np.floor((p64 - start) / size).astype(np.int64),
                   num_cells - 1)
    strides = np.concatenate([[1], np.cumprod(num_cells[:-1])])
    uniq, parent = np.unique((c * strides).sum(axis=1), return_inverse=True)
    sums = np.zeros((uniq.shape[0], pos.shape[1]))
    np.add.at(sums, parent, pos)
    counts = np.bincount(parent, minlength=uniq.shape[0]).astype(np.float64)
    centroid = (sums / counts[:, None]).astype(np.float32)
    e_rel = (centroid[parent] - pos) / np.float32(cell)
    return centroid, parent, e_rel.astype(np.float32)


def pool_edge_structure(parent, senders, receivers):
    """Fine edges mapped to parent pairs, self-loops dropped (-1), the
    rest coalesced into coarse edges ordered by (receiver, sender)."""
    cs, cr = parent[senders], parent[receivers]
    base = int(parent.max()) + 1
    key = np.where(cs != cr, cr.astype(np.int64) * base + cs, -1)
    uniq, inverse = np.unique(key, return_inverse=True)
    if uniq.size and uniq[0] == -1:
        f2c, uniq = inverse - 1, uniq[1:]
    else:
        f2c = inverse
    return uniq % base, uniq // base, f2c


# ------------------------------------------------------------------ REMuS
def guillard(senders: np.ndarray, num_nodes: int, k: int) -> np.ndarray:
    """Guillard's sweep: nodes in index order, each one still kept drops
    its senders."""
    senders = np.asarray(senders).reshape(num_nodes, k)
    keep = np.ones(num_nodes, dtype=bool)
    for v in range(num_nodes):
        if keep[v]:
            keep[senders[v]] = False
    return keep


def _unit_and_size(attr):
    size = np.linalg.norm(attr, axis=1, keepdims=True)
    return attr / size, size


def _angle_attr(u_in, s_in, u_out, s_out, k):
    """``[|e_in|, |e_out|, cos, sin]`` of each (incoming, outgoing) pair."""
    u_out = u_out[:, None, :]
    cos = (u_in * u_out).sum(axis=-1)
    sin = u_in[..., 0] * u_out[..., 1] - u_in[..., 1] * u_out[..., 0]
    n = u_out.shape[0]
    return np.concatenate([
        s_in, np.broadcast_to(s_out[:, None, :], (n, k, 1)),
        cos[..., None], sin[..., None]], axis=-1).astype(np.float32)


def angles(senders, attr, k):
    """Unit vectors of a level's edges, and for edge ``i -> j`` the k
    edges entering ``i`` (its angles' sources) with the angles'
    features."""
    unit, size = _unit_and_size(np.asarray(attr, dtype=np.float32))
    src = senders.astype(np.int64)[:, None] * k + np.arange(k)[None, :]
    return (unit.astype(np.float32), src,
            _angle_attr(unit[src], size[src], unit, size, k))


def cross_angles(fine_attr, coarse_senders, coarse_attr, down_idx, k):
    """For coarse edge ``j -> m``, the k fine edges entering the fine node
    that ``j`` was, with the angles' features."""
    src = down_idx[coarse_senders].astype(np.int64)[:, None] * k \
        + np.arange(k)[None, :]
    u1, s1 = _unit_and_size(np.asarray(fine_attr, dtype=np.float32))
    u2, s2 = _unit_and_size(np.asarray(coarse_attr, dtype=np.float32))
    return src, _angle_attr(u1[src], s1[src], u2, s2, k)


def pinv_k2(a: np.ndarray) -> np.ndarray:
    """``(A^T A)^-1 A^T`` of a ``[..., k, 2]`` stack in float64, rounded to
    float32 once."""
    a = np.asarray(a, dtype=np.float64)
    at = np.swapaxes(a, -1, -2)
    g = at @ a
    det = g[..., 0, 0] * g[..., 1, 1] - g[..., 0, 1] * g[..., 1, 0]
    inv = np.empty_like(g)
    inv[..., 0, 0], inv[..., 1, 1] = g[..., 1, 1], g[..., 0, 0]
    inv[..., 0, 1], inv[..., 1, 0] = -g[..., 0, 1], -g[..., 1, 0]
    inv = inv / np.maximum(det, 1e-30)[..., None, None]
    return (inv @ at).astype(np.float32)


# ----------------------------------------------------------- the transforms
def spatial_sort(g, **_):
    perm = morton_perm(g["pos"])
    for key in _NODE_KEYS:
        if key in g:
            g[key] = np.asarray(g[key])[perm]
    return g


def connect(g, k, device="cpu", **_):
    g["senders"], g["receivers"], g["edge_attr"] = connect_knn(g["pos"], k,
                                                               device)
    g["k"] = k
    return g


def scale_edge_attr(g, r, **_):
    g["edge_attr"] = g["edge_attr"] / (2.0 * r)
    return g


def grid_levels(g, cells_size, **_):
    """MuS levels 2, 3, ...: ``parent_l``, ``e_rel_l``, ``senders_l``,
    ``receivers_l``, ``f2c_l`` and the node count ``V_l``."""
    pos, s, r = g["pos"], g["senders"], g["receivers"]
    for i, cell in enumerate(cells_size):
        l = i + 2
        pos_c, parent, e_rel = grid_clustering(pos, cell)
        cs, cr, f2c = pool_edge_structure(parent, s, r)
        g.update({f"parent_{l}": parent, f"e_rel_{l}": e_rel,
                  f"senders_{l}": cs, f"receivers_{l}": cr,
                  f"f2c_{l}": f2c, f"V_{l}": pos_c.shape[0]})
        pos, s, r = pos_c, cs, cr
    return g


def remus_levels(g, num_levels, k, scale_edge_length=None, device="cpu",
                 **_):
    """REMuS levels ``1..num_levels``: ``unit_l``, ``pinv_l``,
    ``asrc_l``, ``aattr_l``, and for ``l > 1`` ``origin_l``,
    ``xsrc_l``, ``xattr_l``; ``pos_l`` for the interpolation weights."""
    pos = np.asarray(g["pos"], dtype=np.float32)
    origin = np.arange(pos.shape[0])
    prev = None
    for l in range(1, num_levels + 1):
        if l > 1:
            keep = guillard(prev["senders"], prev["pos"].shape[0], k)
            down_idx = np.nonzero(keep)[0]
            pos, origin = prev["pos"][down_idx], prev["origin"][down_idx]
        s, _, attr = connect_knn(pos, k, device)
        if scale_edge_length is not None:
            attr = attr / (2.0 * scale_edge_length[l - 1])
        unit, src, aattr = angles(s, attr, k)
        g.update({f"unit_{l}": unit, f"asrc_{l}": src, f"aattr_{l}": aattr,
                  f"pinv_{l}": pinv_k2(unit.reshape(pos.shape[0], k, 2)),
                  f"pos_{l}": pos, f"origin_{l}": origin})
        if l > 1:
            xsrc, xattr = cross_angles(prev["attr"], s, attr, down_idx, k)
            g.update({f"xsrc_{l}": xsrc, f"xattr_{l}": xattr})
        prev = {"pos": pos, "senders": s, "attr": attr, "origin": origin}
    g["levels"], g["k"] = num_levels, k
    return g


def interp_weights(g, k, device="cpu", **_):
    """``up_idx_l``, ``up_w_l``: the k nearest level-``l`` nodes of each
    level-``l-1`` node and their weights ``1 / max(d^2, 1e-16)``."""
    l = 2
    while f"pos_{l}" in g:
        src, dst = g[f"pos_{l}"], g[f"pos_{l - 1}"]
        idx = knn(src, dst, k, device=device)
        diff = src[idx] - dst[:, None, :]
        g[f"up_idx_{l}"] = idx
        g[f"up_w_{l}"] = (1.0 / np.maximum((diff * diff).sum(axis=-1),
                                           1e-16)).astype(np.float32)
        l += 1
    return g


#: the program's transform names, as the configurations list them
TRANSFORMS = {"SpatialSort": spatial_sort, "ConnectKNN": connect,
              "ScaleEdgeAttr": scale_edge_attr, "GridClustering": grid_levels,
              "BuildRemusGraph": remus_levels,
              "BuildKnnInterpWeights": interp_weights}


def build(raw: dict, transforms, device="cpu") -> dict:
    """One sample's reference graph: a copy of the raw cloud with the
    configuration's ``[[name, kwargs], ...]`` transforms applied (the
    k-NN searches on ``device``)."""
    g = {key: np.array(v) for key, v in raw.items()}
    for name, kwargs in transforms:
        g = TRANSFORMS[name](g, device=device, **kwargs)
    return g
