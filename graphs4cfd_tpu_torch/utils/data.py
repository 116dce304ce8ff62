"""Dataset and transform helpers (port of
``graphs4cfd_tpu/utils/data.py:13-60``): ``Compose``, ``Subset``,
``ConcatDataset`` and ``random_split``, which gives the JAX package's
index split for a seed."""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np


class Compose:
    """Chain transforms: ``Compose([t1, t2])(g) == t2(t1(g))``."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, graph):
        for t in self.transforms:
            graph = t(graph)
        return graph


class Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.concatenate(
            [[0], np.cumsum([len(d) for d in self.datasets])])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, i):
        d = int(np.searchsorted(self._offsets, i, side="right") - 1)
        return self.datasets[d][i - int(self._offsets[d])]


def random_split(dataset, lengths: List[int], seed: int = 0):
    """Split a dataset into random, non-overlapping subsets."""
    if sum(lengths) > len(dataset):
        raise ValueError(f"split sizes {lengths} exceed dataset length "
                         f"{len(dataset)}")
    perm = np.random.default_rng(seed).permutation(len(dataset))
    out, start = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[start:start + n].tolist()))
        start += n
    return out
