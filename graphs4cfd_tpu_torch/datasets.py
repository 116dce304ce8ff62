"""HDF5-backed simulation datasets (numpy).

Port of ``graphs4cfd_tpu/datasets.py:19-181``: a base ``Dataset`` that
draws a random temporal window on every access (one
``numpy.random.default_rng(seed)`` per dataset, as the JAX package draws
it), and the three layouts ``Adv``, ``NsCircle`` and ``NsEllipse``.  The
file holds one dataset ``data`` of shape ``[sims, nodes, columns]``;
NaN-padded rows are trimmed.  ``h5py`` is imported only by the functions
that read the file, so a preloaded store (``h5_data``) needs none.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from .graph import Graph


class Dataset:
    """Base HDF5 simulation store.

    Args:
        path: path to the h5 file (one dataset named ``data`` of shape
            ``[sims, nodes, columns]``; NaN-padded rows are trimmed).
        transform: per-sample transform pipeline applied on access.
        training_info: dict with int values for ``n_in``, ``n_out``,
            ``step`` and ``T``.
        idx: load only this simulation (requires ``preload=True``).
        preload: load the whole file into memory up front.
    """

    def __init__(self, path: str, transform: Optional[Callable] = None,
                 training_info: Optional[Dict] = None, idx: int = None,
                 preload: bool = False, seed: Optional[int] = None):
        self.path = path
        self.transform = transform
        self.training_info = training_info
        self.preload = preload
        self._rng = np.random.default_rng(seed)
        if training_info:
            self.training_sequences_length = (
                (training_info["n_in"] + training_info["n_out"])
                * training_info["step"] - (training_info["step"] - 1))
            self.training_sequences_T = training_info["T"]
        if idx is not None:
            if not preload:
                raise ValueError("If idx is not None, preload must be True.")
            import h5py
            with h5py.File(self.path, "r") as f:
                self.h5_data = np.asarray(f["data"][idx], dtype=np.float32)
            if self.h5_data.ndim == 2:
                self.h5_data = self.h5_data[None]
        elif self.preload:
            self.load()
        else:
            self.h5_data = None

    def __len__(self) -> int:
        if self.h5_data is not None:
            return self.h5_data.shape[0]
        import h5py
        with h5py.File(self.path, "r") as f:
            return f["data"].shape[0]

    def __getitem__(self, idx: int) -> Graph:
        start = int(self._rng.integers(
            0, self.training_sequences_T - self.training_sequences_length + 1))
        return self.get_sequence(idx, start,
                                 n_in=self.training_info["n_in"],
                                 n_out=self.training_info["n_out"],
                                 step=self.training_info["step"])

    def get_sequence(self, idx: int, sequence_start: int = 0, n_in: int = 1,
                     n_out: int = 1, step: int = 1) -> Graph:
        if self.preload:
            data = self.h5_data[idx]
        else:
            import h5py
            with h5py.File(self.path, "r") as f:
                data = np.asarray(f["data"][idx], dtype=np.float32)
        sequence_length = (n_in + n_out) * step - (step - 1)
        idx0 = sequence_start
        idx1 = sequence_start + n_in * step
        idx2 = sequence_start + sequence_length
        graph = self.data2graph(data, idx0, idx1, idx2, step)
        if self.transform:
            self.transform(graph)
        return graph

    def load(self):
        import h5py
        with h5py.File(self.path, "r") as f:
            self.h5_data = np.asarray(f["data"], dtype=np.float32)
        self.preload = True

    def data2graph(self, data: np.ndarray, idx0: int, idx1: int, idx2: int,
                   step: int) -> Graph:
        raise NotImplementedError


def _trim_nan(data: np.ndarray) -> np.ndarray:
    """Drop NaN-padded rows."""
    n = int((data[:, 0] == data[:, 0]).sum())
    return data[:n]


class Adv(Dataset):
    """Advection simulations: columns are
    pos(0:2), loc=velocity(2:4), bound(4), scalar field frames(5:).
    bound codes: 0 inner, 1 periodic, 2 inlet, 3 outlet; ω=1 on inlet."""

    def data2graph(self, data, idx0, idx1, idx2, step) -> Graph:
        data = _trim_nan(data)
        n = data.shape[0]
        graph = Graph()
        graph.pos = data[:, :2]
        graph.loc = data[:, 2:4]
        graph.field = data[:, 5 + idx0:5 + idx1:step]
        graph.target = data[:, 5 + idx1:5 + idx2:step]
        graph.bound = data[:, 4].astype(np.uint8)
        omega = np.zeros((n, 1), dtype=np.float32)
        omega[data[:, 4] == 2, 0] = 1.0  # inlet
        graph.omega = omega
        return graph


class NsCircle(Dataset):
    """Incompressible flow past a circular cylinder: pos(0:2),
    glob=Re(2:3), bound(3), interleaved (u,v,p) frames from column 4.
    bound codes: 0 inner, 1 periodic, 2 inlet, 3 outlet, 4 wall; ω=1 on
    inlet+wall."""

    def __init__(self, format: str, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if format not in ("uv", "uvp"):
            raise ValueError(f"Format {format} not supported, use 'uv' or "
                             f"'uvp'")
        self.format = format

    def data2graph(self, data, idx0, idx1, idx2, step) -> Graph:
        data = _trim_nan(data)
        n = data.shape[0]
        graph = Graph()
        graph.pos = data[:, :2]
        graph.glob = data[:, 2:3]
        frames = data[:, 4:].reshape(n, -1, 3)
        sl = slice(None) if self.format == "uvp" else slice(0, 2)
        graph.field = frames[:, idx0:idx1:step, sl].reshape(n, -1)
        graph.target = frames[:, idx1:idx2:step, sl].reshape(n, -1)
        graph.bound = data[:, 3].astype(np.uint8)
        omega = np.zeros((n, 1), dtype=np.float32)
        omega[(data[:, 3] == 2) | (data[:, 3] == 4), 0] = 1.0
        graph.omega = omega
        return graph


class NsEllipse(Dataset):
    """Incompressible flow past elliptical cylinders: like NsCircle but
    6 values per frame, of which the first 2-3 are used."""

    def __init__(self, format: str, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if format not in ("uv", "uvp"):
            raise ValueError(f"Format {format} not supported, use 'uv' or "
                             f"'uvp'")
        self.format = format

    def data2graph(self, data, idx0, idx1, idx2, step) -> Graph:
        data = _trim_nan(data)
        n = data.shape[0]
        num_fields = 3 if self.format == "uvp" else 2
        graph = Graph()
        graph.pos = data[:, :2]
        graph.glob = data[:, 2:3]
        frames = data[:, 4:].reshape(n, -1, 6)
        graph.field = frames[:, idx0:idx1:step, :num_fields].reshape(n, -1)
        graph.target = frames[:, idx1:idx2:step, :num_fields].reshape(n, -1)
        graph.bound = data[:, 3].astype(np.uint8)
        omega = np.zeros((n, 1), dtype=np.float32)
        omega[(data[:, 3] == 2) | (data[:, 3] == 4), 0] = 1.0
        graph.omega = omega
        return graph
