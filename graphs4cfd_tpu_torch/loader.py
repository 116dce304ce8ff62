"""Batch assembly: concatenation with index offsets, then padding.

Port of ``collate`` (``graphs4cfd_tpu/loader.py:35-82, 228-357``) for the
keys of the MuS, REMuS and gMuS slices.  The window and fold plans of
the JAX package (``wg_*``, ``wg_fold*``) are left out: they exist because a
TPU kernel cannot gather rows by index, and the CUDA GN-block kernel loads
sender and angle-source rows by index.  ``attach_angle_sorts`` (REMuS) and
``attach_sender_sorts`` (gMuS) add, after ``collate``, the host sorts of
the sender maps that the backward's sorted sums walk.  ``collate_sharded``
(``graphs4cfd_tpu/loader.py:359-470``, without the window plans) stacks
equal-shape shard groups on a leading axis for data parallelism, and
``shard_of`` takes one shard back out.  ``DataLoader`` is the epoch
iterator of ``graphs4cfd_tpu/loader.py:483-587``: it yields numpy
batches, as the JAX loader yields host graphs.

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

import collections
import math
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

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


def _pad_rows(key: str, v: np.ndarray, rows: int, fixed_k, last_node: int
              ) -> np.ndarray:
    """The rows that pad array ``key`` from ``len(v)`` up to ``rows``, by
    the invariants above: ``fixed_k`` is the key's level's (or None),
    ``last_node`` the node that ``sender_sorted`` pads with."""
    base = re.sub(r"_\d$", "", key)
    shape = (rows - v.shape[0],) + v.shape[1:]
    if base == "edge_f2c":
        return np.full(shape, -1, dtype=v.dtype)
    if base == "sender_perm":
        return np.arange(v.shape[0], rows, dtype=v.dtype)
    if base == "sender_sorted":
        return np.full(shape, last_node, dtype=v.dtype)
    if base == "up_w":
        return np.ones(shape, dtype=v.dtype)
    if base in ("senders", "receivers") and fixed_k is not None:
        return (np.arange(v.shape[0], rows) // fixed_k).astype(v.dtype)
    return np.zeros(shape, dtype=v.dtype)


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
        if total_padded > merged.shape[0]:
            merged = np.concatenate([merged, _pad_rows(
                key, merged, total_padded, fixed_k_of(count_space[1]),
                padded[("node", count_space[1])] - 1)], axis=0)
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


def collate_sharded(graphs: Sequence[Graph], num_shards: int,
                    node_bucket: int = 64, edge_bucket: int = 128) -> Graph:
    """``num_shards`` equal-shape shard groups stacked on a leading axis:
    the input of the data-parallel steps (``parallel.dp``).

    Sample ``i`` goes to shard ``i % num_shards``; each shard is
    ``collate``d, then every array is padded to the largest shard's rows
    by ``collate``'s pad rules, so array ``x`` of shard shape ``[N, ...]``
    becomes ``[num_shards, N, ...]`` with shard-local indices (no edge
    crosses shards).  The statics must agree across shards.  Raises
    ``ValueError`` when ``num_shards`` does not divide the number of
    graphs."""
    if len(graphs) % num_shards:
        raise ValueError(f"batch size {len(graphs)} not divisible by "
                         f"{num_shards} shards")
    shards = [collate(list(graphs[i::num_shards]), node_bucket, edge_bucket)
              for i in range(num_shards)]
    out = {}
    for key in shards[0].data:
        vals = [s.data[key] for s in shards]
        if not isinstance(vals[0], np.ndarray):
            if any(v != vals[0] for v in vals):
                raise ValueError(f"static key {key} differs across shards")
            out[key] = vals[0]
            continue
        rows = max(v.shape[0] for v in vals)
        l = _suffix_level(key)
        # sender_sorted pads with the shard's own last level-1 node, as
        # graphs4cfd_tpu/loader.py:411-414 does
        out[key] = np.stack([
            np.concatenate([v, _pad_rows(
                key, v, rows,
                s.data.get("fixed_k" if l == 1 else f"fixed_k_{l}"),
                s.data["node_mask"].shape[0] - 1)])
            if v.shape[0] < rows else v
            for s, v in zip(shards, vals)])
    return Graph(out)


def shard_of(sharded: Graph, i: int) -> Graph:
    """Shard ``i`` of a ``collate_sharded`` batch (or of any graph whose
    arrays carry a leading shard axis) as a graph of its own: the ``[i]``
    slice of every array and the statics."""
    return Graph({k: (v[i] if isinstance(v, np.ndarray) else v)
                  for k, v in sharded.data.items()})


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


class DataLoader:
    """Epoch iterator: samples -> ``transform`` per sample -> ``collate``
    -> ``batch_transform`` on the collated batch.

    ``shuffle`` draws each epoch's order from one
    ``numpy.random.default_rng(seed)``; ``num_workers > 0`` builds batches
    in a thread pool, ``prefetch`` batches a worker ahead.  The batches
    are numpy graphs: ``fit`` moves each to the model's device.
    ``num_shards > 0`` yields ``collate_sharded`` batches of
    ``num_shards`` shards (``fit`` sets it to ``TrainConfig.devices``)
    and drops a last batch that is not full; it refuses a
    ``batch_transform``, whose cells would couple samples of different
    shards (``graphs4cfd_tpu/loader.py:535-549``).
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 transform: Optional[Callable] = None,
                 node_bucket: int = 64, edge_bucket: int = 128,
                 seed: int = 0, drop_last: bool = False,
                 num_workers: int = 0, prefetch: int = 2,
                 num_shards: int = 0,
                 batch_transform: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.transform = transform
        self.node_bucket = node_bucket
        self.edge_bucket = edge_bucket
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.num_shards = num_shards
        self.batch_transform = batch_transform
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        return (n // self.batch_size if self._drop_last()
                else math.ceil(n / self.batch_size))

    def _drop_last(self) -> bool:
        return self.drop_last or self.num_shards > 0

    def _make_batch(self, idx) -> Graph:
        gs = [self.dataset[int(i)] for i in idx]
        if self.transform is not None:
            gs = [self.transform(g) for g in gs]
        if self.num_shards:
            if self.batch_transform is not None:
                raise ValueError(
                    "batch_transform is incompatible with data-parallel "
                    "shards (whole-batch cells would couple samples of "
                    "different shards); move it into the per-sample "
                    "`transform` pipeline")
            return collate_sharded(gs, self.num_shards, self.node_bucket,
                                   self.edge_bucket)
        batch = collate(gs, self.node_bucket, self.edge_bucket)
        if self.batch_transform is not None:
            batch = self.batch_transform(batch)
        return batch

    def _index_batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if self._drop_last() and len(idx) < self.batch_size:
                return
            yield idx

    def __iter__(self):
        if self.num_workers <= 0:
            for idx in self._index_batches():
                yield self._make_batch(idx)
            return
        # host graph building (numpy, which releases the GIL in its heavy
        # parts) overlaps the device's work on the batches before
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = collections.deque()
            it = self._index_batches()
            for idx in it:
                pending.append(pool.submit(self._make_batch, idx))
                if len(pending) >= max(1, self.prefetch) * self.num_workers:
                    break
            while pending:
                batch = pending.popleft().result()
                idx = next(it, None)
                if idx is not None:
                    pending.append(pool.submit(self._make_batch, idx))
                yield batch
