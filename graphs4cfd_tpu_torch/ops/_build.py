"""Build and load the CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` call, all started
together, and the objects are linked into a plain shared library with a C
interface, loaded with ``ctypes`` (no PyTorch headers, so the build takes
seconds).  The library goes to
``build/graphs4cfd_tpu_torch/<hash>/libg4c_kernels.so`` beside the package,
where ``<hash>`` covers the sources and the flags: a second run with the
same sources loads it without building.  Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "graphs4cfd_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libg4c_kernels.so"

_lib = None
#: how the library was obtained: {"path", "seconds", "built", "log"}
build_info: dict = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, then ``$CUDA_HOME/bin``, then ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    path = library_path()
    t0 = time.perf_counter()
    if path.exists():
        build_info.update(path=str(path), built=False, log="",
                          seconds=time.perf_counter() - t0)
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = find_nvcc()
    cu, _ = _sources()
    objs = [path.with_name(f"{f.stem}.{tag}.o") for f in cu]
    steps = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(f)]
             for f, o in zip(cu, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in steps]
    log = ""
    for cmd, proc in zip(steps, procs):
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    tmp = path.with_name(f"{LIB_NAME}.{tag}")
    cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    for o in objs:
        o.unlink()
    build_info.update(path=str(path), built=True,
                      log=log + proc.stdout + proc.stderr,
                      seconds=time.perf_counter() - t0)
    return path


def load():
    """The loaded kernel library, building it on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.g4c_error_string.argtypes = [i32]
    lib.g4c_error_string.restype = ctypes.c_char_p
    lib.g4c_mlp_chain_smem.argtypes = [i32, p, i64, i32]
    lib.g4c_mlp_chain_smem.restype = ctypes.c_size_t
    lib.g4c_mlp_chain.argtypes = [p, p, i64, i32, p, p, p, p, p, i32, i32,
                                  p]
    lib.g4c_mlp_chain.restype = i32
    lib.g4c_gn_block_smem.argtypes = [i32, i32, i32, i32, p, i32, p, i32]
    lib.g4c_gn_block_smem.restype = ctypes.c_size_t
    lib.g4c_gn_block.argtypes = [p, p, p, p, p, p, i32, i32, i32, i32,
                                 i32, i32, i32, p, p, p, p, p,
                                 i32, p, p, p, p, p, i32, i32, p]
    lib.g4c_gn_block.restype = i32
    lib.g4c_mlp_chain_bwd_smem.argtypes = [i32, p, i32, i32]
    lib.g4c_mlp_chain_bwd_smem.restype = ctypes.c_size_t
    lib.g4c_mlp_chain_bwd_work.argtypes = [i32, p, i64, i32, i32, i32]
    lib.g4c_mlp_chain_bwd_work.restype = ctypes.c_size_t
    lib.g4c_mlp_chain_bwd.argtypes = [p, p, p, i64, i32, p, p, p, p, i32,
                                      p, p, i32, i32, p]
    lib.g4c_mlp_chain_bwd.restype = i32
    lib.g4c_gn_block_bwd_smem.argtypes = [i32, i32, i32, i32, p, i32, p,
                                          i32]
    lib.g4c_gn_block_bwd_smem.restype = ctypes.c_size_t
    lib.g4c_gn_block_bwd_work.argtypes = [i32, i32, i32, i32, p, i32, p,
                                          i32, i32, i32, i32]
    lib.g4c_gn_block_bwd_work.restype = ctypes.c_size_t
    lib.g4c_gn_block_bwd.argtypes = [p, p, p, p, p, p, p, p, p,
                                     i32, i32, i32, i32, i32, i32, i32,
                                     p, p, p, p, p,
                                     i32, p, p, p, p, p, i32, p, p, i32,
                                     i32, p]
    lib.g4c_gn_block_bwd.restype = i32
    lib.g4c_sorted_segment_sum_work.argtypes = [i64, i32, i32]
    lib.g4c_sorted_segment_sum_work.restype = ctypes.c_size_t
    lib.g4c_sorted_segment_sum.argtypes = [p, p, p, i64, i32, i32, i32, p,
                                           p, i32, i32, p]
    lib.g4c_sorted_segment_sum.restype = i32
    lib.g4c_gather_rows.argtypes = [p, p, i64, i32, i32, p, i32, p]
    lib.g4c_gn_bf16_occupancy.argtypes = [i32, ctypes.c_size_t, p, p]
    lib.g4c_gn_bf16_occupancy.restype = i32
    lib.g4c_wgrad.argtypes = [i32, p, p, p, p, p, p, p, p, i32, i32, p]
    lib.g4c_wgrad.restype = i32
    lib.g4c_wgrad_work.argtypes = [i32, p, p, p]
    lib.g4c_wgrad_work.restype = ctypes.c_size_t
    lib.g4c_wgrad_bf16_occupancy.argtypes = [p, p, p]
    lib.g4c_wgrad_bf16_occupancy.restype = i32
    lib.g4c_mlp_chain_bwd_bf16_occupancy.argtypes = [ctypes.c_size_t, p, p]
    lib.g4c_mlp_chain_bwd_bf16_occupancy.restype = i32
    lib.g4c_mlp_chain_fwd_bf16_geometry.argtypes = [i32, p, p, p, p, p, p]
    lib.g4c_mlp_chain_fwd_bf16_geometry.restype = i32
    lib.g4c_gather_rows.restype = i32
    _lib = lib
    return lib


def check(err: int) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = _lib.g4c_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: error {err}: {msg}")


def ptr_array(tensors) -> ctypes.Array:
    """Device pointers of ``tensors`` as a C array (None -> null)."""
    return (ctypes.c_void_p * max(len(tensors), 1))(
        *[t.data_ptr() if t is not None else None for t in tensors])


def int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*[int(v) for v in values])


def int64_array(values) -> ctypes.Array:
    return (ctypes.c_int64 * len(values))(*[int(v) for v in values])


#: shared memory one block may use on an H100 (sm_90), bytes
MAX_SMEM = 232448
