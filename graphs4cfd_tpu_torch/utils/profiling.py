"""Tracing and throughput observability (port of
``graphs4cfd_tpu/utils/profiling.py``).

* ``trace_annotation(name)``: a named range (``torch.profiler.
  record_function``); ``fit`` wraps each batch's copy to the device in
  ``host_to_device`` and each training step in ``train_step``.  An
  exception raised inside a range propagates as itself.
* ``start_trace(log_dir)`` / ``stop_trace()``: one ``torch.profiler``
  session recording the host's activity and, on ``cuda``, the card's
  kernels; ``stop_trace`` writes a Chrome trace (``*.pt.trace.json``,
  read by ``chrome://tracing``, Perfetto and TensorBoard's profiler
  plugin) under ``log_dir`` and returns its path.
* ``sync``, ``Timer``, ``EdgeRateMeter``: a host sync, a wall-clock timer
  that syncs first, and the edges/s meter, with the JAX classes'
  arithmetic.
"""
from __future__ import annotations

import contextlib
import os
import socket
import time

import numpy as np
import torch

_session = None


@contextlib.contextmanager
def trace_annotation(name: str):
    """A range named ``name`` in a ``torch.profiler`` trace (nothing is
    recorded when no session runs)."""
    with torch.profiler.record_function(name):
        yield


def start_trace(log_dir: str, device: str = "cuda") -> None:
    """Start a profiler session: host activity and, for ``device="cuda"``,
    the card's kernels and copies.  Raises without a card for ``cuda``, and
    if a session is already running."""
    global _session
    if _session is not None:
        raise RuntimeError("a trace is already running; call stop_trace()")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("start_trace(device='cuda'): no CUDA device; "
                               "pass device='cpu' to trace the host only")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    elif torch.device(device).type != "cpu":
        raise ValueError(f"start_trace: unsupported device {device!r}")
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _session = (prof, log_dir)


def stop_trace() -> str:
    """End the session of ``start_trace`` and write its trace; returns the
    path of the ``.pt.trace.json`` file."""
    global _session
    if _session is None:
        raise RuntimeError("no trace is running; call start_trace() first")
    prof, log_dir = _session
    _session = None
    prof.stop()
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                        f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def _first_leaf(x):
    """The first leaf of a tree of dicts (keys sorted), lists and tuples."""
    if isinstance(x, dict):
        x = [x[k] for k in sorted(x)]
    if isinstance(x, (list, tuple)):
        for v in x:
            leaf = _first_leaf(v)
            if leaf is not None:
                return leaf
        return None
    return x


def sync(x) -> float:
    """Wait for the device of the first leaf of ``x``; return that leaf's
    first element as a float."""
    leaf = _first_leaf(x)
    if leaf is None:
        raise ValueError("sync: no leaf in the tree")
    if isinstance(leaf, torch.Tensor):
        if leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
        return float(leaf.detach().reshape(-1)[0])
    return float(np.asarray(leaf).ravel()[0])


class Timer:
    """Wall-clock timer that waits for the device before it stops."""

    def __init__(self):
        self.t0 = None
        self.elapsed = 0.0

    def start(self):
        self.t0 = time.time()
        return self

    def stop(self, device_value=None) -> float:
        if device_value is not None:
            sync(device_value)
        self.elapsed = time.time() - self.t0
        return self.elapsed


class EdgeRateMeter:
    """Edges processed over wall time: edges/s."""

    def __init__(self):
        self.edges = 0
        self.seconds = 0.0

    def update(self, num_edges: int, seconds: float):
        self.edges += num_edges
        self.seconds += seconds

    @property
    def rate(self) -> float:
        return self.edges / self.seconds if self.seconds > 0 else 0.0
