"""Edge-partitioned graph parallelism for the MuS-, gMuS- and REMuS-GNN
families, in f32 and under the bf16 policy.

Port of ``graphs4cfd_tpu/parallel/graph_parallel.py`` (the partitioner,
``_GpCtx``, ``gp_mus_apply``, ``gp_mugs_apply``, ``gp_remus_apply``,
``gp_apply_fn`` and the forward, rollout, training and validation
wrappers).  One giant mesh is split over the ranks of a
``torch.distributed`` group: at every level the nodes are sorted along a
Z-order curve and cut into equal contiguous blocks, and each rank owns one
block per level plus the edges whose receiver it owns.

Host side (numpy, once per batch): ``partition_graph`` gives every array
a leading part axis, renumbers the index arrays, and builds one halo table
per gather site: the rows each rank sends each other rank (``halo_*``,
``[P, P, pmax]``) and the index maps into the rank's local table
``cat([own block, received rows])`` (``<key>_lidx``).  A table is kept
only where its exchange moves fewer rows than the all-gather it replaces
(``halo_max_frac``).  ``attach_gp_sorts`` adds the host sorts that the
backward's sums walk, and the port's own map of each REMuS level's angle
sources into its folded edge table; ``part_of`` gives a rank its
``Graph``.

Device side, on each rank, the family's single-device body with every
cross-partition access served by its site (``gp_apply_fn``):

* ``gp_mus_apply``: the level-1 MP layers run ``ops.gn_block`` (TPU rows
  3-6) with the halo table as their sender table; the coarse levels gather
  their sender and receiver rows from one shared table; pooling sums
  partial segment means over the ranks; the up step gathers its parents;
* ``gp_mugs_apply``: every level's MP layers on ``ops.gn_block`` over the
  level's sender halo; the down step a select from its table, the up step
  a k-NN interpolation from its table;
* ``gp_remus_apply``: one exchange of the node inputs serves every coarse
  level; each EdgeMP layer runs ``ops.gn_block`` over its level's folded
  edge table ``[T*k, H]`` (the node halo exchange of ``es.reshape(V,
  k*H)``), ``down_edge_mp`` over the fine-edge halo, ``up_edge_mp``
  interpolates from its table.

Every row gather from a halo table (the exchange's send rows too) is
``ops.gather.gather_rows``, the CUDA kernel of TPU row 7 (f32 or bf16
rows), whose backward is ``sorted_segment_sum`` (row 8) over the attached
sorts.  The collectives are ``parallel.collectives``; under the bf16
policy they move bf16 rows and sum bf16 partials in f32.

DP x GP (``make_dp_gp_*``): a ``parallel.mesh.Mesh`` of data groups of
consecutive ranks, each group's graph partitioned over the group
(``partition_batches(regroup_sharded(batch, D), P)``, then a rank takes
``part_of(attach_gp_sorts(shard_of(sharded, d)), g)``); the halo
exchange runs over the rank's graph group, the loss and the gradient sum
over the whole mesh.

Left out, as Mosaic workarounds: ``_tab_rows``' 128-row padding of the
local table and ``_build_gp_window_plans`` (without plans the JAX
``_GpCtx.plan_pad()`` is 0).  ``shard_map``, ``jit`` and ``scan`` have no
counterpart: each rank runs the same Python over its part.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..graph import Graph
from ..loader import _rules
from ..nn.blocks import (F32, bias, down_edge_mp, edge_mp,
                         edge_scalar_to_node_vector, gn_block, mm, up_edge_mp)
from ..nn.mlp import apply_mlp, apply_mlp_tail
from ..nn.mugs_gnn import MuGSGNN, level_groups
from ..nn.mus_gnn import MuSGNN, node_input
from ..nn.remus_gnn import REMuSGNN, _encode, _group
from ..ops import gather as gather_op
from ..ops.fused_mlp import selu, widen
from ..ops.interp import knn_interpolate
from ..ops.order import morton_code
from ..ops.segment import segment_sum
from ..training.trainer import clip_and_update_
from .collectives import (all_gather, all_reduce_grads_, all_reduce_slice,
                          all_to_all)

#: keys whose single-device metadata is stale after renumbering
_DROP_RE = re.compile(r"^(wg_|wgf_|sender_perm|sender_sorted)")


# --------------------------------------------------------------------- host
def _suffix_level(key: str) -> int:
    m = re.search(r"_(\d)$", key)
    return int(m.group(1)) if m else 1


def _suf(l: int) -> str:
    return "" if l == 1 else f"_{l}"


def _gp_rules(key: str):
    """(row_space, value_space) of a graph key: the loader's collate rules
    extended with the arrays collate itself creates."""
    base = re.sub(r"_\d$", "", key)
    l = _suffix_level(key)
    if base == "node_mask":
        return ("node", l), None
    if base == "edge_mask":
        return ("edge", l), None
    if key == "batch":
        return ("node", 1), None
    return _rules(key)


def _sort_perm(pos: np.ndarray) -> np.ndarray:
    """Morton (Z-order) sort: contiguous blocks are compact 2-D tiles, so
    the halo sets stay small."""
    return np.argsort(morton_code(pos), kind="stable").astype(np.int32)


def _levels(data: dict) -> List[int]:
    return [1] + sorted(int(m.group(1)) for k in data
                        for m in [re.match(r"pos_(\d)$", k)] if m)


def _gather_sites(data: dict, levels: Sequence[int]) -> List[Tuple]:
    """The gather sites present on this graph: (table_key, value_space,
    [idx keys indexing that space])."""

    def fixed_k_of(l):
        return data.get("fixed_k") if l == 1 else data.get(f"fixed_k_{l}")

    sites = []
    for l in levels:
        s = _suf(l)
        if f"senders{s}" in data:
            if fixed_k_of(l) is not None:
                # receiver slabs align with node blocks: sender-only halo
                sites.append((f"halo_s{s}", ("node", l), [f"senders{s}"]))
            else:
                # variable-degree levels: even edge slabs cross node
                # blocks, so senders and receivers share a table
                sites.append((f"halo_sr{s}", ("node", l),
                              [f"senders{s}", f"receivers{s}"]))
        if l > 1 and f"parent_{l}" in data:
            sites.append((f"halo_p_{l}", ("node", l), [f"parent_{l}"]))
        if l > 1 and f"down_idx_{l}" in data:
            sites.append((f"halo_d_{l}", ("node", l - 1),
                          [f"down_idx_{l}"]))
        if l > 1 and f"up_idx_{l}" in data:
            sites.append((f"halo_u_{l}", ("node", l), [f"up_idx_{l}"]))
        if l > 1 and f"xangle_src_{l}" in data:
            sites.append((f"halo_x_{l}", ("edge", l - 1),
                          [f"xangle_src_{l}"]))
    origins = [f"node_origin_{l}" for l in levels
               if f"node_origin_{l}" in data]
    if origins:
        # one shared table: every level's field rows ride one exchange
        sites.append(("halo_o", ("node", 1), origins))
    return sites


def _halo_tables(idx_blocks: Sequence[np.ndarray], block: int,
                 num_parts: int):
    """Gather-halo tables for global row indices.

    ``idx_blocks``: ``[D, ...]`` arrays of global row ids into a row space
    cut into contiguous blocks of ``block`` rows (all sharing one table).
    Returns ``(halo_send [D, D, pmax]`` (owner-local rows owner ``o``
    sends to ``d``), ``lidxs, pmax)``; each ``lidx`` maps its index to the
    position in rank d's local table ``cat([own_block, recv])`` (received
    rows owner-major)."""
    D = num_parts
    flat = [np.asarray(b).reshape(D, -1) for b in idx_blocks]
    send_lists = [[[] for _ in range(D)] for _ in range(D)]
    for d in range(D):
        es = np.concatenate([b[d] for b in flat])
        remote = np.unique(es[(es < d * block) | (es >= (d + 1) * block)])
        for s in remote:
            send_lists[s // block][d].append(int(s))
    pmax = max(1, max(len(send_lists[o][d])
                      for o in range(D) for d in range(D)))
    # bucketed, so successive batches keep the same table shapes; pad
    # slots resend owner row 0 (no gather addresses them)
    pmax = 16 * ((pmax + 15) // 16)
    halo_send = np.zeros((D, D, pmax), np.int32)
    for o in range(D):
        for d in range(D):
            rows = send_lists[o][d]
            halo_send[o, d, :len(rows)] = np.asarray(rows, np.int32) \
                - o * block  # owner-local row ids
    lidxs = [np.zeros_like(b, dtype=np.int32) for b in flat]
    for d in range(D):
        lut = {s: block + o * pmax + p
               for o in range(D) for p, s in enumerate(send_lists[o][d])}
        for b, lidx in zip(flat, lidxs):
            es = b[d]
            local = (es >= d * block) & (es < (d + 1) * block)
            lidx[d] = np.where(local, es - d * block,
                               np.asarray([lut.get(int(s), 0)
                                           for s in es.ravel()],
                                          np.int32).reshape(es.shape))
    lidxs = [l.reshape(np.asarray(b).shape)
             for l, b in zip(lidxs, idx_blocks)]
    return halo_send, lidxs, pmax


def partition_graph(graph: Graph, num_parts: int,
                    halo_max_frac: float = 0.5) -> Tuple[Graph, dict]:
    """Partition a collated graph (numpy) into ``num_parts`` blocks with a
    leading part axis.

    Every array's rows are split by their row space (node or edge, per
    level); index arrays are renumbered through the per-level Z-order
    permutations, and each level's edges re-sorted by receiver.  Each
    gather site gets a halo table and local index maps (``<key>_lidx``)
    when ``num_parts * pmax <= halo_max_frac * rows``; otherwise the
    forward falls back to an all-gather of that level.  Every node and
    edge count must divide by ``num_parts``.

    Returns the sharded graph and ``{"perms": {level: node permutation},
    "tables": {table: {"pmax", "lidx_keys", "space"}}, "pmax": {table:
    pmax}}`` (``perms[1]`` puts level-1 results back: ``unpermute``)."""
    g = graph.numpy()
    data = {k: v for k, v in g.data.items() if not _DROP_RE.match(k)}
    statics = {k: v for k, v in data.items()
               if not isinstance(v, np.ndarray)}
    levels = _levels(data)
    rules = {k: _gp_rules(k) for k in data if isinstance(data[k], np.ndarray)}

    rows_of = {}
    for l in levels:
        rows_of[("node", l)] = data[f"pos{_suf(l)}"].shape[0]
        s_key = f"senders{_suf(l)}"
        if s_key in data:
            rows_of[("edge", l)] = data[s_key].shape[0]
    for space, n in rows_of.items():
        if n % num_parts:
            raise ValueError(f"{space} row count {n} not divisible by "
                             f"{num_parts} (choose node/edge buckets "
                             f"divisible by the number of parts)")

    # node permutations (spatial sort per level)
    perms, invs = {}, {}
    for l in levels:
        perm = _sort_perm(data[f"pos{_suf(l)}"])
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm), dtype=np.int32)
        perms[l], invs[l] = perm, inv

    # pass A: permute node-space rows; remap node-space values
    for key, (row_space, val_space) in rules.items():
        if row_space[0] == "node":
            data[key] = data[key][perms[row_space[1]]]
        if val_space is not None and val_space[0] == "node":
            data[key] = invs[val_space[1]][data[key]]

    # pass B: re-sort each level's edges by (new) receiver, which keeps
    # the receiver-sorted slabs (and, on fixed-k levels, each receiver's
    # k edges together: the sort is stable)
    eperm_inv = {}
    for l in levels:
        r_key = f"receivers{_suf(l)}"
        if r_key not in data:
            continue
        order = np.argsort(data[r_key], kind="stable").astype(np.int32)
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order), dtype=np.int32)
        eperm_inv[l] = (order, inv)

    # pass C: permute edge-space rows; remap edge-space values
    for key, (row_space, val_space) in rules.items():
        if row_space[0] == "edge" and row_space[1] in eperm_inv:
            data[key] = data[key][eperm_inv[row_space[1]][0]]
        if val_space is not None and val_space[0] == "edge" \
                and val_space[1] in eperm_inv:
            v = data[key]
            inv = eperm_inv[val_space[1]][1]
            if key.startswith("edge_f2c"):
                data[key] = np.where(v >= 0, inv[np.maximum(v, 0)], -1)
            else:
                data[key] = inv[v]

    # halo tables per gather site
    info_tables: Dict[str, dict] = {}
    extra = {}
    for table_key, (space, l), idx_keys in _gather_sites(data, levels):
        n_rows = rows_of[(space, l)]
        block = n_rows // num_parts
        hs, lidxs, pmax = _halo_tables([data[k] for k in idx_keys],
                                       block, num_parts)
        # kept only when the all-to-all beats the all-gather it replaces
        if num_parts * pmax > halo_max_frac * n_rows:
            continue
        extra[table_key] = hs
        lidx_keys = [f"{k}_lidx" for k in idx_keys]
        extra.update(zip(lidx_keys, lidxs))
        info_tables[table_key] = {"pmax": pmax, "lidx_keys": lidx_keys,
                                  "space": (space, l)}

    # split into blocks with a leading part axis
    out = dict(statics)
    for key, v in data.items():
        if not isinstance(v, np.ndarray):
            continue
        out[key] = v.reshape((num_parts, v.shape[0] // num_parts)
                             + v.shape[1:])
    for key, v in extra.items():
        # halo tables are already [D(part), D, pmax]; lidx arrays get the
        # part axis of their index key's row space
        if key.endswith("_lidx"):
            v = v.reshape((num_parts, v.shape[0] // num_parts) + v.shape[1:])
        out[key] = v
    out["gp_num_parts"] = num_parts
    return Graph(out), {"perms": perms, "tables": info_tables,
                        "pmax": {k: v["pmax"]
                                 for k, v in info_tables.items()}}


def partition_batches(batches: Sequence[Graph], num_parts: int
                      ) -> Tuple[Graph, dict]:
    """Partition several collated batches (the data groups of DP x GP)
    ``num_parts`` ways each and stack them into ``[num_groups, num_parts,
    ...]`` arrays (``graphs4cfd_tpu/parallel/graph_parallel.py:375``).
    Only the halo tables every group kept stay; each is padded to the
    largest ``pmax`` over the groups, and its index maps are renumbered
    to it.  Returns the stacked graph and ``{"perms": [each group's
    node permutations], "pmax": {table: pmax}}``."""
    parts = [partition_graph(b, num_parts) for b in batches]
    table_keys = [k for k in parts[0][1]["tables"]
                  if all(k in info["tables"] for _, info in parts)]
    for p, info in parts:
        for k in list(info["tables"]):
            if k not in table_keys:
                for key in [k] + info["tables"][k]["lidx_keys"]:
                    p.data.pop(key, None)
    pmaxes = {k: max(info["tables"][k]["pmax"] for _, info in parts)
              for k in table_keys}
    out = {}
    for key in parts[0][0].data:
        vals = [p.data[key] for p, _ in parts]
        if not isinstance(vals[0], np.ndarray):
            if any(v != vals[0] for v in vals):
                raise ValueError(f"static key {key} differs across groups")
            out[key] = vals[0]
            continue
        if key in pmaxes:
            vals = [np.pad(v, ((0, 0), (0, 0),
                               (0, pmaxes[key] - v.shape[-1])))
                    for v in vals]
        out[key] = np.stack(vals, axis=0)
    # a halo slot is block + o * pmax + p: renumber to the common pmax
    for gi, (p, info) in enumerate(parts):
        for tk in table_keys:
            old_pmax, new_pmax = info["tables"][tk]["pmax"], pmaxes[tk]
            if old_pmax == new_pmax:
                continue
            space = info["tables"][tk]["space"]
            pos_key = (f"pos{_suf(space[1])}" if space[0] == "node"
                       else f"senders{_suf(space[1])}")
            block = p.data[pos_key].shape[1]
            for lk in info["tables"][tk]["lidx_keys"]:
                lidx = out[lk][gi]
                halo = lidx >= block
                o = (lidx - block) // old_pmax
                r = (lidx - block) % old_pmax
                out[lk][gi] = np.where(halo, block + o * new_pmax + r, lidx)
    return Graph(out), {"perms": [info["perms"] for _, info in parts],
                        "pmax": pmaxes}


def regroup_sharded(graph: Graph, num_groups: int) -> List[Graph]:
    """A ``collate_sharded`` batch back as its ``num_groups`` collated
    groups (``graphs4cfd_tpu/parallel/graph_parallel.py:1032``): the input
    ``partition_batches`` takes to compose DP x GP from one batch."""
    return [Graph({k: (v[g] if isinstance(v, np.ndarray) else v)
                   for k, v in graph.data.items()})
            for g in range(num_groups)]


def _gather_maps(data: dict) -> List[Tuple[str, str]]:
    """``(table, map)`` of every gather of the partitioned forward: the
    map is ``<key>_lidx`` where the table was kept, else the global
    ``<key>`` (the all-gather fallback)."""
    return [(table, f"{k}_lidx" if table in data else k)
            for table, _, idx_keys in _gather_sites(data, _levels(data))
            for k in idx_keys]


def _angle_folds(data: dict) -> Dict[str, np.ndarray]:
    """The map of every REMuS level's angle-source gather into its folded
    edge table (``angle_src{l}_fold [P, E, k]``): the JAX GP EdgeMP gathers
    the k sources of edge ``i`` as the row of its sender node in the
    ``[V, k*H]`` edge table (``graphs4cfd_tpu/nn/blocks.py:449-459``), so
    read as ``[T*k, H]`` they are rows ``s*k + j`` of the local table,
    ``s`` the sender's map (``senders{l}_lidx``, or the global
    ``senders{l}`` over the all-gather).  Raises where a valid edge's
    angle sources are not that canonical layout (``angle_src == senders *
    k + j``); a pad edge, whose collated sources are 0, gathers its own
    pad node's edges, as the JAX GP EdgeMP does (no valid row reads a pad
    edge)."""
    out = {}
    for l in _levels(data):
        s = _suf(l)
        if f"angle_src{s}" not in data:
            continue
        src, senders = data[f"angle_src{s}"], data[f"senders{s}"]
        j = np.arange(src.shape[-1], dtype=np.int32)
        k = src.shape[-1]
        valid = data[f"edge_mask{s}"]
        if not np.array_equal(src[valid], (senders[..., None] * k + j)[valid]):
            raise ValueError(f"angle_src{s} is not the canonical layout "
                             f"senders * k + j that the partitioned EdgeMP "
                             f"gathers by")
        base = (data[f"senders{s}_lidx"] if f"halo_s{s}" in data
                else senders)
        out[f"angle_src{s}_fold"] = (base[..., None] * k + j).astype(np.int32)
    return out


def attach_gp_sorts(sharded: Graph) -> Graph:
    """``sharded`` with, per part, the host sorts that the backward's sums
    walk: for every gather map of the forward (each ``*_lidx``, or the
    global index where a table fell back to the all-gather) and every
    flattened ``halo_*`` send list, ``<key>_perm`` (stable argsort) and
    ``<key>_sorted`` (the values in that order), both int32 ``[P, n]``.
    The sort of ``senders_lidx`` takes the place of the single-device
    ``sender_perm``/``sender_sorted``, which ``partition_graph`` drops.
    REMuS levels also get the port's own map of their angle sources into
    the folded edge table, ``angle_src{l}_fold`` (``_angle_folds``), with
    its sort: the partition itself stays the JAX package's.  The graph
    given is left as it is."""
    data = dict(sharded.data)
    P = data["gp_num_parts"]
    maps = _gather_maps(data)
    folds = _angle_folds(data)
    data.update(folds)
    keys = ([m for _, m in maps] + sorted({t for t, _ in maps if t in data})
            + sorted(folds))
    for key in keys:
        flat = np.asarray(data[key]).reshape(P, -1)
        perm = np.argsort(flat, axis=1, kind="stable")
        data[f"{key}_perm"] = perm.astype(np.int32)
        data[f"{key}_sorted"] = np.take_along_axis(flat, perm, 1).astype(
            np.int32)
    return Graph(data)


def part_of(sharded: Graph, rank: int, device="cuda") -> Graph:
    """Part ``rank`` of a partitioned graph as a ``Graph`` on ``device``:
    the ``[rank]`` slice of every array, the statics, and ``gp_rank``."""
    data = {k: (v[rank] if isinstance(v, np.ndarray) else v)
            for k, v in sharded.data.items()}
    data["gp_rank"] = rank
    return Graph(data).to(device)


def unpermute(out, info: dict) -> np.ndarray:
    """Level-1 rows of a partitioned result in the unpartitioned order:
    ``out`` holds the ranks' rows (numpy) in rank order."""
    rows = np.concatenate(out)
    res = np.empty_like(rows)
    res[info["perms"][1]] = rows
    return res


# ------------------------------------------------------------------- device
class _GpCtx:
    """A rank's gather sites: ``exchange(table)`` is the function that
    turns the rank's rows into its local gather table (the halo all-to-all
    of exactly the boundary rows, or the all-gather where the partitioner
    dropped the table); ``index(table, key)`` is the map into that table,
    in its own shape, with its host sort; ``gather`` gathers through both
    (rows of the map's shape)."""

    def __init__(self, graph: Graph, group):
        self.g, self.group = graph, group
        self.P = graph.data["gp_num_parts"]
        if dist.get_world_size(group) != self.P or \
                dist.get_rank(group) != graph.data["gp_rank"]:
            raise ValueError(
                f"part {graph.data['gp_rank']} of {self.P} given to rank "
                f"{dist.get_rank(group)} of {dist.get_world_size(group)}")

    def sort(self, key: str):
        g = self.g
        return ((g.data[f"{key}_perm"], g.data[f"{key}_sorted"])
                if g.has(f"{key}_perm") else None)

    def exchange(self, table_key: str):
        if not self.g.has(table_key):
            return lambda x: all_gather(x, self.group)
        send = self.g.data[table_key].reshape(-1)        # [P * pmax]
        sort = self.sort(table_key)

        def ex(x):
            rows = gather_op.gather_rows(x, send, sort)
            return torch.cat([x, all_to_all(rows, self.group)])
        return ex

    def index(self, table_key: str, idx_key: str):
        key = f"{idx_key}_lidx" if self.g.has(table_key) else idx_key
        return self.g.data[key], self.sort(key)

    def gather(self, tab: torch.Tensor, table_key: str, idx_key: str):
        idx, sort = self.index(table_key, idx_key)
        return gather_op.gather_rows(tab, idx.reshape(-1), sort).reshape(
            *idx.shape, tab.shape[1])


def _scatter_mean(x: torch.Tensor, idx_global: torch.Tensor, n_total: int,
                  mask, ctx: _GpCtx) -> torch.Tensor:
    """Partial segment means into the full target array, summed over the
    ranks; each rank keeps its own block.  Sums and counts ride one
    collective as a trailing column.  bf16 rows are summed in f32 and the
    mean rounded once (``nn.blocks.act_mean``; the JAX ``_scatter_mean``
    sums them in bf16)."""
    xw = widen(x)
    num = segment_sum(xw, idx_global, n_total, mask=mask)
    cnt = segment_sum(xw.new_ones(x.shape[0]), idx_global, n_total,
                      mask=mask)
    fused = all_reduce_slice(torch.cat([num, cnt[:, None]], dim=-1),
                             ctx.group)
    return (fused[:, :-1] / fused[:, -1:].clamp_min(1)).to(x.dtype)


def _coarse_mp(block, v, e, ctx: _GpCtx, l: int, cd=F32):
    """A variable-degree MP layer: sender and receiver rows from the
    level's shared table, the edge MLP (first layer split by input, as in
    ``nn.blocks.gn_block``, with its products and bias at the bf16
    policy's plain sites), partial means onto the receivers."""
    s = _suf(l)
    em, nm = block.edge_mlp, block.node_mlp
    if cd != F32:
        v, e = v.to(cd), e.to(cd)
    fe, fv = e.shape[1], v.shape[1]
    w1 = em.weights[0]
    table = f"halo_sr{s}"
    tab = ctx.exchange(table)(v)
    h = (mm(e, w1[:fe], cd)
         + ctx.gather(mm(tab, w1[fe:fe + fv], cd), table, f"senders{s}")
         + ctx.gather(mm(tab, w1[fe + fv:], cd), table, f"receivers{s}")
         + bias(em.biases[0], cd))
    e_new = apply_mlp_tail(em, h, start=1, cd=cd)
    aggr = _scatter_mean(e_new, ctx.g.data[f"receivers{s}"],
                         v.shape[0] * ctx.P, ctx.g.data[f"edge_mask{s}"], ctx)
    nw1 = nm.weights[0]
    fa = aggr.shape[1]
    v_new = apply_mlp_tail(nm, mm(aggr, nw1[:fa], cd) + mm(v, nw1[fa:], cd)
                           + bias(nm.biases[0], cd), start=1, cd=cd)
    return selu(v_new), selu(e_new)


def gp_mus_apply(layers, graph: Graph, plan, num_fields: int,
                 group=None, cd=F32) -> torch.Tensor:
    """One residual time step of a MuS-GNN on this rank's part (port of
    ``gp_mus_apply``, ``graphs4cfd_tpu/parallel/graph_parallel.py:518``):
    ``nn.mus_gnn.mus_apply`` with every cross-partition access served by
    its gather site.  ``cd``: the compute dtype.  Returns the rank's
    level-1 rows."""
    ctx = _GpCtx(graph, group)
    P = ctx.P
    v = selu(apply_mlp(layers["node_encoder"], node_input(graph), cd))
    e = selu(apply_mlp(layers["edge_encoder"], graph.edge_attr, cd))
    fixed_k = graph.get("fixed_k")
    level = 1
    skips = []

    def mp(name, v, e, l, e_dead):
        if l == 1 and fixed_k is not None:
            senders, sort = ctx.index("halo_s", "senders")
            return gn_block(layers[name], v, e, senders, graph.receivers,
                            fixed_k=fixed_k, out_selu=True,
                            skip_e_out=e_dead, sender_sort=sort,
                            sender_table=ctx.exchange("halo_s"), cd=cd)
        return _coarse_mp(layers[name], v, e, ctx, l, cd)

    for i, op in enumerate(plan):
        if op[0] == "mp":
            nxt = plan[i + 1][0] if i + 1 < len(plan) else None
            # e' of the last layer before an up or the decoder is dead
            v, e = mp(op[1], v, e, level, nxt in ("up", None))
        elif op[0] == "down":
            _, name, tgt = op
            skips.append((v, e))
            node_mask = (graph.node_mask if level == 1
                         else graph.data[f"node_mask_{level}"])
            nc_local = graph.data[f"node_mask_{tgt}"].shape[0]
            x = apply_mlp(layers[name], torch.cat(
                [graph.data[f"e_rel_{tgt}"], widen(v)], dim=-1), cd)
            v = torch.tanh(_scatter_mean(x, graph.data[f"parent_{tgt}"],
                                         nc_local * P, node_mask, ctx))
            # pool edges: partial means into the full coarse edge array
            f2c = graph.data[f"edge_f2c_{tgt}"]
            ec_local = graph.data[f"senders_{tgt}"].shape[0]
            e = _scatter_mean(e, f2c, ec_local * P, f2c >= 0, ctx)
            level = tgt
        elif op[0] == "up":
            _, name, src = op
            v_skip, e_skip = skips.pop()
            table = f"halo_p_{src}"
            vp = ctx.gather(ctx.exchange(table)(v), table, f"parent_{src}")
            v = torch.tanh(apply_mlp(layers[name], torch.cat(
                [-graph.data[f"e_rel_{src}"], widen(vp), widen(v_skip)],
                dim=-1), cd))
            e = e_skip
            level = src - 1
    return graph.field[:, -num_fields:] + apply_mlp(layers["decoder"], v, cd)


def gp_mugs_apply(layers, graph: Graph, plan, num_fields: int,
                  group=None, cd=F32) -> torch.Tensor:
    """One residual time step of a gMuS-GNN on this rank's part (port of
    ``gp_mugs_apply``, ``graphs4cfd_tpu/parallel/graph_parallel.py:605``):
    ``nn.mugs_gnn.mugs_apply`` with every level's MP layers on the GN
    kernel over the level's sender halo table (``halo_s{l}``), the down
    step the ``halo_d_{l}`` select, and the up step the k-NN
    interpolation from the ``halo_u_{l}`` table, then the skip."""
    ctx = _GpCtx(graph, group)
    v = selu(apply_mlp(layers["node_encoder"], node_input(graph), cd))
    e = {1: selu(apply_mlp(layers["edge_encoder"], graph.edge_attr, cd))}
    for l in range(2, graph.num_levels + 1):
        e[l] = selu(apply_mlp(layers[f"edge_encoder{l}"],
                              graph.data[f"edge_attr_{l}"], cd))
    groups, last_group_of_level = level_groups(plan)
    level, skips = 1, {}
    for gi, (lvl, names) in enumerate(groups):
        while lvl > level:
            level += 1
            skips[level - 1] = v
            table = f"halo_d_{level}"
            v = ctx.gather(ctx.exchange(table)(v), table,
                           f"down_idx_{level}")
        while lvl < level:
            table, key = f"halo_u_{level}", f"up_idx_{level}"
            v = knn_interpolate(
                ctx.exchange(table)(v), ctx.index(table, key)[0],
                graph.data[f"up_w_{level}"],
                lambda x, _, t=table, k=key: ctx.gather(x, t, k))
            v = torch.cat([v, widen(skips.pop(level - 1))], dim=-1)
            level -= 1
        s = _suf(level)
        senders, sort = ctx.index(f"halo_s{s}", f"senders{s}")
        e_dead = last_group_of_level[lvl] == gi
        for j, name in enumerate(names):
            v, e[level] = gn_block(
                layers[name], v, e[level], senders,
                graph.data[f"receivers{s}"],
                fixed_k=graph.get(f"fixed_k{s}"), out_selu=True,
                skip_e_out=e_dead and j == len(names) - 1, sender_sort=sort,
                sender_table=ctx.exchange(f"halo_s{s}"), cd=cd)
    return graph.field[:, -num_fields:] + apply_mlp(layers["decoder"], v, cd)


def gp_remus_apply(layers, graph: Graph, plan, num_fields: int = 2,
                   group=None, cd=F32) -> torch.Tensor:
    """One residual time step of a REMuS-GNN on this rank's part (port of
    ``gp_remus_apply``, ``graphs4cfd_tpu/parallel/graph_parallel.py:677``):
    ``nn.remus_gnn.remus_apply`` with one ``halo_o`` exchange of the
    ``[field | glob | omega]`` rows serving every coarse level's inputs,
    the EdgeMP layers on the GN kernel over the folded edge table of the
    level's node halo (``halo_s{l}``), ``down_edge_mp`` over the fine-edge
    halo (``halo_x_{l}``) and ``up_edge_mp`` interpolating from the
    ``halo_u_{l}`` table.  The pinverse solves and projections are local:
    every receiver's edges lie in its node's part."""
    ctx = _GpCtx(graph, group)
    field, glob = graph.field, graph.glob
    nf, ng = field.shape[1], glob.shape[1]
    tab_o = (ctx.exchange("halo_o")(torch.cat([field, glob, graph.omega],
                                              dim=-1))
             if graph.num_levels > 1 else None)
    e, a, xa = {}, {}, {}
    for l in range(1, graph.num_levels + 1):
        rows = (None if l == 1 else
                ctx.gather(tab_o, "halo_o", f"node_origin_{l}"))
        e[l], a[l], xa[l] = _encode(layers, graph, l, cd, None if rows is None
                                    else (rows[:, :nf], rows[:, nf:nf + ng],
                                          rows[:, nf + ng:]))
    grouped = _group(plan)
    last_group_of_level = {op[2]: i for i, op in enumerate(grouped)
                           if op[0] == "mp_group"}
    for i, op in enumerate(grouped):
        if op[0] == "mp_group":
            _, names, l = op
            s = _suf(l)
            fold = graph.data[f"angle_src{s}_fold"]
            sort = ctx.sort(f"angle_src{s}_fold")
            ex, k = ctx.exchange(f"halo_s{s}"), fold.shape[1]
            table = (lambda es, ex=ex, k=k: ex(es.reshape(
                -1, k * es.shape[1])).reshape(-1, es.shape[1]))
            for j, name in enumerate(names):
                e[l], a[l] = edge_mp(
                    layers[name], e[l], a[l], fold, out_selu=True,
                    skip_a_out=last_group_of_level[l] == i
                    and j == len(names) - 1, angle_sort=sort, cd=cd,
                    sender_table=table)
        elif op[0] == "down":
            _, name, tgt = op
            table = f"halo_x_{tgt}"
            idx, sort = ctx.index(table, f"xangle_src_{tgt}")
            e[tgt] = down_edge_mp(layers[name], e[tgt - 1], e[tgt], xa[tgt],
                                  idx, out_selu=True, angle_sort=sort, cd=cd,
                                  sender_table=ctx.exchange(table))
        elif op[0] == "up":
            _, name, src = op
            tgt = src - 1
            st, ss = _suf(tgt), _suf(src)
            table, key = f"halo_u_{src}", f"up_idx_{src}"
            e[tgt] = selu(up_edge_mp(
                layers[name], e[src], graph.data[f"unit_pinv{ss}"],
                ctx.index(table, key)[0], graph.data[f"up_w_{src}"],
                graph.data[f"unit_vec{st}"], e[tgt], cd=cd,
                interp_exchange=ctx.exchange(table),
                take=lambda x, _, t=table, k=key: ctx.gather(x, t, k)))
    dec = apply_mlp(layers["decoder"], e[1], cd)               # [E1, 1]
    out = edge_scalar_to_node_vector(dec, graph.unit_pinv)     # [V, 1, 2]
    return field[:, -num_fields:] + out.reshape(out.shape[0], -1)


def gp_apply_fn(model):
    """The family's partitioned body (``gp_apply_fn``,
    ``graphs4cfd_tpu/parallel/graph_parallel.py:777``): ``apply(graph,
    group)`` runs the model's time step on this rank's part at the
    model's ``compute_dtype``."""
    for cls, body in ((MuGSGNN, gp_mugs_apply), (REMuSGNN, gp_remus_apply),
                      (MuSGNN, gp_mus_apply)):
        if isinstance(model, cls):
            break
    else:
        raise TypeError(f"graph parallelism runs MuSGNN, MuGSGNN and "
                        f"REMuSGNN, not {type(model).__name__}")
    if model.compute_dtype not in (F32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be torch.float32 or "
                         f"torch.bfloat16, got {model.compute_dtype}")

    def apply(graph: Graph, group=None) -> torch.Tensor:
        return body(model.layers, graph, model.plan, model.num_fields,
                    group, model.compute_dtype)
    return apply


def make_gp_forward(model, group=None):
    """``forward(part) -> [V_local, num_fields]``: the model's time step on
    this rank's part (``part_of``); every rank of ``group`` calls it with
    its own part.  Any of the three families, in f32 or under the bf16
    policy (the model's ``compute_dtype``)."""
    apply = gp_apply_fn(model)
    return lambda graph: apply(graph, group)


def make_gp_rollout(model, n_out: int, group=None):
    """``rollout(part) -> [V_local, num_fields * n_out]``: the partitioned
    ``solve`` (``training.rollout.solve``): each rank rolls its node block
    forward ``n_out`` steps, under ``torch.inference_mode``."""
    if n_out <= 0:
        raise ValueError("n_out must be greater than 0.")
    forward = make_gp_forward(model, group)
    nf = model.num_fields

    @torch.inference_mode()
    def rollout(graph: Graph) -> torch.Tensor:
        field = graph.field
        preds = []
        for _ in range(n_out):
            pred = forward(graph.replace(field=field))
            field = torch.cat([field[:, nf:], pred], dim=1)
            preds.append(pred)
        return torch.cat(preds, dim=1)
    return rollout


def gp_loss_and_grads(model, criterion, graph: Graph, target: torch.Tensor,
                      group=None, loss_group=None):
    """``(global loss, local prediction, gradients)`` of one partitioned
    time step, the halo exchange over ``group``: the exact global loss
    (``criterion.distributed``) and every parameter's gradient summed over
    the ranks (the same on every rank), both over ``loss_group`` (by
    default ``group``; DP x GP: the whole mesh)."""
    loss_group = group if loss_group is None else loss_group
    pred = make_gp_forward(model, group)(graph)
    loss = criterion.distributed(graph, pred, target, loss_group)
    grads = list(torch.autograd.grad(loss, list(model.parameters())))
    all_reduce_grads_(grads, loss_group)
    return loss, pred, grads


def _train_step(model, criterion, n_out, grad_clip_limit, group,
                loss_group):
    gp_apply_fn(model)                  # refuses a model it does not run
    params = list(model.parameters())
    nf = model.num_fields

    def train_step(state, graph: Graph, lr: float, clip_on: bool = True):
        target = graph.target
        field = graph.field
        losses, gnorms = [], []
        for t in range(n_out):
            loss, pred, grads = gp_loss_and_grads(
                model, criterion, graph.replace(field=field),
                target[:, t * nf:(t + 1) * nf], group, loss_group)
            gnorms.append(clip_and_update_(params, grads, state, lr,
                                           grad_clip_limit, clip_on))
            field = torch.cat([field[:, nf:], pred.detach()], dim=1)
            losses.append(loss.detach())
        return torch.stack(losses).mean(), torch.stack(gnorms).mean()
    return train_step


def _val_step(model, criterion, max_n_out, group, loss_group):
    forward = make_gp_forward(model, group)
    nf = model.num_fields

    @torch.no_grad()
    def val_step(graph: Graph):
        target = graph.target
        field = graph.field
        losses = []
        for t in range(max_n_out):
            g = graph.replace(field=field)
            pred = forward(g)
            losses.append(criterion.distributed(
                g, pred, target[:, t * nf:(t + 1) * nf], loss_group))
            field = torch.cat([field[:, nf:], pred], dim=1)
        return torch.stack(losses).mean()
    return val_step


def make_gp_train_step(model, criterion, n_out: int, grad_clip_limit=None,
                       group=None):
    """``train_step(state, part, lr, clip_on=True) -> (mean loss, mean
    gradient norm)``: ``training.make_train_step`` on a partitioned graph.
    Per rollout step: the global loss, the gradients summed over the ranks
    by one all-reduce, then the trainer's norm, clip and Adam step, so the
    parameters stay the same bits on every rank."""
    return _train_step(model, criterion, n_out, grad_clip_limit, group,
                       group)


def make_gp_val_step(model, criterion, max_n_out: int, group=None):
    """``val_step(part) -> mean loss`` of a ``max_n_out``-step partitioned
    rollout (``training.make_val_step``), the global loss at each step."""
    return _val_step(model, criterion, max_n_out, group, group)


def make_dp_gp_forward(model, mesh):
    """``forward(part) -> [V_local, num_fields]`` on a DP x GP ``mesh``
    (``parallel.mesh.make_mesh``): this rank's part of its data group's
    graph, the halo exchange over its graph group
    (``graphs4cfd_tpu/parallel/graph_parallel.py:791``)."""
    return make_gp_forward(model, mesh.graph_group)


def make_dp_gp_train_step(model, criterion, mesh, n_out: int = 1,
                          grad_clip_limit=None):
    """``make_gp_train_step`` on a DP x GP ``mesh``
    (``graphs4cfd_tpu/parallel/graph_parallel.py:906``): the halo exchange
    over the rank's graph group; the exact loss of the whole batch and the
    gradient sum over the whole mesh, so every rank takes the same Adam
    step."""
    return _train_step(model, criterion, n_out, grad_clip_limit,
                       mesh.graph_group, mesh.group)


def make_dp_gp_val_step(model, criterion, mesh, max_n_out: int):
    """``make_gp_val_step`` on a DP x GP ``mesh``
    (``graphs4cfd_tpu/parallel/graph_parallel.py:988``): the loss of the
    whole batch at each step, over the whole mesh."""
    return _val_step(model, criterion, max_n_out, mesh.graph_group,
                     mesh.group)
