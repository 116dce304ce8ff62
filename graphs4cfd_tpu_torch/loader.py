"""Batch assembly: concatenation with index offsets, then padding.

Port of ``collate`` (``graphs4cfd_tpu/loader.py:35-82, 228-357``) for the
keys of the MuS slice.  The window and fold plans of the JAX package are
left out: they exist because a TPU kernel cannot gather rows by index, and
the CUDA GN-block kernel loads sender rows by index.

Padding invariants (every consumer in ``nn/`` relies on them):

* level arrays pad with zeros; ``node_mask{_l}`` / ``edge_mask{_l}`` flag
  the valid rows, which form a prefix;
* fixed-k levels keep ``E = k*V``: pad edges are self-loops on pad nodes
  (sender = receiver = row // k), so pad values never reach valid rows;
* ``edge_f2c_{l}`` pads with -1; ``sender_perm`` pads with the identity
  and ``sender_sorted`` with the last pad node, so both stay sorted.
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
_STATIC_KEYS_RE = re.compile(r"^(fixed_k(_\d)?|num_levels)$")


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
    if base == "edge_attr":
        return ("edge", l), None
    if base == "parent":
        return ("node", l - 1), ("node", l)
    if base == "e_rel":
        return ("node", l - 1), None
    if base == "edge_f2c":
        return ("edge", l - 1), ("edge", l)
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
