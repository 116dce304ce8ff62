"""Reading the ``.chk`` checkpoints of the JAX package.

A checkpoint pickles ``{arch, weights, optimiser, n_out, lr, epoch}`` with
the weights as the JAX package's tree of numpy arrays.  The unpickler here
refuses every global except the numpy array reconstructors, so reading a
file imports neither jax nor optax and runs no other code.
"""
from __future__ import annotations

import importlib
import pickle

_ALLOWED = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
}


class _NumpyOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) not in _ALLOWED:
            raise pickle.UnpicklingError(
                f"checkpoint refers to {module}.{name}: only numpy arrays "
                "are read")
        try:
            mod = importlib.import_module(module)
        except ImportError:  # numpy 1.x names numpy._core numpy.core
            mod = importlib.import_module(module.replace("_core", "core"))
        return getattr(mod, name)


def load_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return _NumpyOnlyUnpickler(f).load()
