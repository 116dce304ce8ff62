"""Batch assembly: concatenation with index offsets, then padding.

Port of ``collate`` (``graphs4cfd_tpu/loader.py:35-82, 228-357``) for the
keys of the MuS, REMuS and gMuS slices.  The window and fold plans of
the JAX package (``wg_*``, ``wg_fold*``) are left out: they exist because a
TPU kernel cannot gather rows by index, and the CUDA GN-block kernel loads
sender and angle-source rows by index.  ``attach_angle_sorts`` (REMuS) and
``attach_sender_sorts`` (gMuS) add, after ``collate``, the host sorts of
the sender maps that the backward's sorted sums walk.

Padding invariants (every consumer in ``nn/`` relies on them):

* level arrays pad with zeros; ``node_mask{_l}`` / ``edge_mask{_l}`` flag
  the valid rows, which form a prefix;
* fixed-k levels keep ``E = k*V``: pad edges are self-loops on pad nodes
  (sender = receiver = row // k), so pad values never reach valid rows;
* ``edge_f2c_{l}`` pads with -1; ``sender_perm`` pads with the identity
  and ``sender_sorted`` with the last pad node, so both stay sorted;
* ``up_w_{l}`` pads with 1, so interpolation never divides by zero;
* every padded index array stays in bounds.
"""
from __future__ import annotations

import math
import re
from typing import Sequence

import numpy as np

from .graph import Graph

#: level-1 node-space arrays that concatenate verbatim
_L1_NODE_KEYS = ("field", "target", "omega", "loc", "glob", "bound")
#: static (non-array) keys that must agree across samples
_STATIC_KEYS_RE = re.compile(r"^(fixed_k(_\d)?|num_levels|interp_k)$")


def _suffix_level(key: str) -> int:
    m = re.search(r"_(\d)$", key)
    return int(m.group(1)) if m else 1


def _rules(key: str):
    """-> (count_space, offset_space); a space is ('node'|'edge', level)."""
    l = _suffix_level(key)
    base = re.sub(r"_\d$", "", key)
    if base == "pos":
        return ("node", l), None
    if key in _L1_NODE_KEYS:
        return ("node", 1), None
    if base in ("senders", "receivers"):
        return ("edge", l), ("node", l)
    if base in ("edge_attr", "angle_attr", "xangle_attr", "unit_vec"):
        return ("edge", l), None
    if base == "parent":
        return ("node", l - 1), ("node", l)
    if base == "e_rel":
        return ("node", l - 1), None
    if base == "edge_f2c":
        return ("edge", l - 1), ("edge", l)
    if base == "down_idx":
        return ("node", l), ("node", l - 1)
    if base == "node_origin":
        return ("node", l), ("node", 1)
    if base == "up_idx":
        return ("node", l - 1), ("node", l)
    if base == "up_w":
        return ("node", l - 1), None
    if base == "unit_pinv":
        return ("node", l), None
    if base == "angle_src":
        return ("edge", l), ("edge", l)
    if base == "xangle_src":
        return ("edge", l), ("edge", l - 1)
    if base == "sender_perm":
        return ("edge", l), ("edge", l)
    if base == "sender_sorted":
        return ("edge", l), ("node", l)
    raise KeyError(f"No collate rule for graph key {key!r}")


def _round_up(n: int, mult: int) -> int:
    return mult * math.ceil(n / mult) if mult > 1 else n


def collate(graphs: Sequence[Graph], node_bucket: int = 64,
            edge_bucket: int = 128) -> Graph:
    """Merge per-sample graphs (numpy) into one padded super-graph."""
    g0 = graphs[0]
    keys = [k for k in g0.data if not _STATIC_KEYS_RE.match(k)]
    static = {k: g0.data[k] for k in g0.data if _STATIC_KEYS_RE.match(k)}
    for g in graphs[1:]:
        for k, v in static.items():
            if g.data.get(k) != v:
                raise ValueError(f"static key {k} differs across batch")

    # per-level valid counts and offsets
    levels = sorted({_suffix_level(k) for k in keys if k.startswith("pos")})
    counts = {}
    for l in levels:
        pos_key = "pos" if l == 1 else f"pos_{l}"
        counts[("node", l)] = [np.asarray(g.data[pos_key]).shape[0]
                               for g in graphs]
        s_key = "senders" if l == 1 else f"senders_{l}"
        if s_key in g0.data:
            counts[("edge", l)] = [np.asarray(g.data[s_key]).shape[0]
                                   for g in graphs]
    offsets = {space: np.concatenate([[0], np.cumsum(c)])
               for space, c in counts.items()}

    def fixed_k_of(level: int):
        return static.get("fixed_k" if level == 1 else f"fixed_k_{level}")

    # padded sizes
    padded = {}
    for (space, l), c in counts.items():
        if space == "node":
            padded[(space, l)] = _round_up(int(sum(c)), node_bucket)
    for (space, l), c in counts.items():
        if space == "edge":
            k = fixed_k_of(l)
            padded[(space, l)] = (k * padded[("node", l)] if k is not None
                                  else _round_up(int(sum(c)), edge_bucket))

    out = {}
    for key in keys:
        count_space, offset_space = _rules(key)
        parts = []
        for i, g in enumerate(graphs):
            arr = np.asarray(g.data[key])
            if offset_space is not None:
                off = int(offsets[offset_space][i])
                if key.startswith("edge_f2c"):
                    arr = np.where(arr >= 0, arr + off, -1)
                else:
                    arr = arr + off
            parts.append(arr)
        merged = np.concatenate(parts, axis=0)
        total_padded = padded[count_space]
        pad_rows = total_padded - merged.shape[0]
        if pad_rows > 0:
            base = re.sub(r"_\d$", "", key)
            if base == "edge_f2c":
                fill = np.full((pad_rows,) + merged.shape[1:], -1,
                               dtype=merged.dtype)
            elif base == "sender_perm":
                fill = np.arange(merged.shape[0], total_padded,
                                 dtype=merged.dtype)
            elif base == "sender_sorted":
                fill = np.full((pad_rows,),
                               padded[("node", count_space[1])] - 1,
                               dtype=merged.dtype)
            elif base == "up_w":
                fill = np.ones((pad_rows,) + merged.shape[1:],
                               dtype=merged.dtype)
            elif (base in ("senders", "receivers")
                  and fixed_k_of(count_space[1]) is not None):
                k = fixed_k_of(count_space[1])
                start = merged.shape[0]
                fill = (np.arange(start, start + pad_rows) // k).astype(
                    merged.dtype)
            else:
                fill = np.zeros((pad_rows,) + merged.shape[1:],
                                dtype=merged.dtype)
            merged = np.concatenate([merged, fill], axis=0)
        out[key] = merged

    # masks and the batch vector
    for (space, l), c in counts.items():
        name = ("node_mask" if space == "node" else "edge_mask")
        name += "" if l == 1 else f"_{l}"
        mask = np.zeros(padded[(space, l)], dtype=bool)
        mask[:int(sum(c))] = True
        out[name] = mask
    batch = np.concatenate([np.full(c, i, dtype=np.int32)
                            for i, c in enumerate(counts[("node", 1)])])
    out["batch"] = np.concatenate([
        batch, np.full(padded[("node", 1)] - len(batch), len(graphs),
                       dtype=np.int32)])
    out["num_graphs"] = len(graphs)
    out.update(static)
    return Graph(out)


def _attach_sorts(graph: Graph, bases, tag) -> Graph:
    """``graph`` with ``(perm, sorted)`` added for every array whose name
    without its level suffix is in ``bases``: the stable argsort of the
    flattened array and the array in that order, both int32, under the
    names ``tag(key)`` gives."""
    out = dict(graph.data)
    for key, value in graph.data.items():
        if re.sub(r"_\d$", "", key) not in bases:
            continue
        src = np.asarray(value).reshape(-1)
        perm = np.argsort(src, kind="stable")
        perm_key, sorted_key = tag(key)
        out[perm_key] = perm.astype(np.int32)
        out[sorted_key] = src[perm].astype(np.int32)
    return Graph(out)


def attach_angle_sorts(graph: Graph) -> Graph:
    """``graph`` with the host sorts of its angle sources added, for the
    ``dvs`` sums of the REMuS backward (``ops.segment.sorted_segment_sum``
    walks them in order, as it walks ``sender_perm``/``sender_sorted`` for
    MuS).  For every ``angle_src{_l}`` and ``xangle_src_{l}`` (flattened)
    it adds ``angle_perm{_l}``/``xangle_perm_{l}``, the stable argsort, and
    ``angle_sorted{_l}``/``xangle_sorted_{l}``, the sources in that order,
    both int32.  Call it on ``collate``'s output; the graph given is left
    as it is."""
    return _attach_sorts(graph, ("angle_src", "xangle_src"), lambda key: (
        key.replace("_src", "_perm"), key.replace("_src", "_sorted")))


def attach_sender_sorts(graph: Graph) -> Graph:
    """``graph`` with the host sorts of every level's senders added, for
    the ``dvs`` sums of the gMuS backward: ``sender_perm``/``sender_sorted``
    for ``senders`` and ``sender_perm_{l}``/``sender_sorted_{l}`` for each
    ``senders_{l}``, the stable argsort and the senders in that order, both
    int32.  (The gMuS transform attaches none, and its output stays
    byte-equal to the JAX package's.)  Call it on ``collate``'s output; the
    graph given is left as it is."""
    return _attach_sorts(graph, ("senders",), lambda key: (
        key.replace("senders", "sender_perm"),
        key.replace("senders", "sender_sorted")))
