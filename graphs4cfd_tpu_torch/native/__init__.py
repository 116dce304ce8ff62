"""The C++ helper of the host pipeline: exact k-NN and Guillard coarsening.

``graph_ops.cpp`` is compiled by one ``g++`` call at first use into
``build/graphs4cfd_tpu_torch/native/<hash>/libgraph_ops.so`` beside the
package, where ``<hash>`` covers the source and the flags, and loaded with
``ctypes`` (which releases the GIL during a call, so ``DataLoader``
threads build graphs in parallel).  A second process with the same source
loads the library without building it.  The flags give the same bits on
every x86-64 or Arm CPU: ``-ffp-contract=off`` and no ``-march``, so no
fused multiply-add rounds a distance differently from the numpy plain
versions.  A failed build raises with the compiler's log; nothing falls
back to numpy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "graph_ops.cpp"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "graphs4cfd_tpu_torch" / "native")
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC")
LIB_NAME = "libgraph_ops.so"

_lib = None
_lock = threading.Lock()
#: how the library was obtained: {"path", "seconds", "built", "log"}
build_info: dict = {}


def find_cxx() -> str:
    """``g++`` from PATH."""
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found on PATH: cannot build the host "
                           "graph helper")
    return cxx


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile ``graph_ops.cpp`` unless a library of the same source and
    flags exists.  Concurrent processes each write a file of their own and
    move it into place."""
    path = library_path()
    t0 = time.perf_counter()
    if path.exists():
        build_info.update(path=str(path), built=False, log="",
                          seconds=time.perf_counter() - t0)
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{LIB_NAME}.{os.getpid()}.{threading.get_ident()}"
                         ".tmp")
    cmd = [find_cxx(), *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    build_info.update(path=str(path), built=True,
                      log=proc.stdout + proc.stderr,
                      seconds=time.perf_counter() - t0)
    return path


def load():
    """The loaded helper library, building it on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        dp, i32p = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(
            ctypes.c_int32)
        i64 = ctypes.c_int64
        knn_sig = [dp, i64, dp, i64, i64, i64, ctypes.c_int32, i32p]
        for fn in (lib.knn_neighbors, lib.knn_neighbors_grid):
            fn.argtypes = knn_sig
            fn.restype = None
        lib.guillard_coarsening.argtypes = [
            i32p, i64, i64, ctypes.POINTER(ctypes.c_uint8)]
        lib.guillard_coarsening.restype = None
        _lib = lib
        return lib


def uses_grid(n: int, dim: int) -> bool:
    """Whether ``knn_neighbors`` takes the grid search: more than 2000
    points of at most 4 coordinates (as the JAX package's helper)."""
    return n > 2000 and dim <= 4


def knn_neighbors(x: np.ndarray, queries: np.ndarray, k: int,
                  exclude_self: bool = False) -> np.ndarray:
    """For each query row, its ``k`` nearest rows of ``x``, int32
    ``[Q, k]``, in ascending (distance, index) order.  ``exclude_self``
    assumes ``queries is x`` and skips row ``i`` for query ``i``."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    q = np.ascontiguousarray(queries, dtype=np.float64)
    if x.ndim != 2 or q.ndim != 2 or x.shape[1] != q.shape[1]:
        raise ValueError(f"points {x.shape} and queries {q.shape} must be "
                         f"[N, dim] and [Q, dim]")
    if k < 1 or (k + 1 if exclude_self else k) > x.shape[0]:
        raise ValueError(f"k={k} too large for {x.shape[0]} points")
    lib = load()
    out = np.empty((q.shape[0], k), dtype=np.int32)
    fn = (lib.knn_neighbors_grid if uses_grid(*x.shape)
          else lib.knn_neighbors)
    fn(x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), x.shape[0],
       q.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), q.shape[0],
       x.shape[1], k, int(exclude_self),
       out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def guillard_coarsening(senders: np.ndarray, num_nodes: int,
                        k: int) -> np.ndarray:
    """Bool ``[V]`` mask of the nodes Guillard's sweep keeps (see
    ``ops.coarsen.guillard_coarsening``)."""
    lib = load()
    s = np.ascontiguousarray(senders, dtype=np.int32).reshape(-1)
    if s.shape[0] != num_nodes * k:
        raise ValueError(f"{s.shape[0]} senders, want {num_nodes} x {k}")
    if s.size and (s.min() < 0 or s.max() >= num_nodes):
        raise ValueError("a sender lies outside [0, num_nodes)")
    out = np.empty(num_nodes, dtype=np.uint8)
    lib.guillard_coarsening(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), num_nodes, k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)
