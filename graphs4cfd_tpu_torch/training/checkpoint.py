"""``.chk`` checkpoints, read and written in the JAX package's format.

Port of ``graphs4cfd_tpu/training/checkpoint.py:27-55``.  A checkpoint
pickles ``{arch, weights, optimiser, n_out, lr, epoch[, scheduler]}`` with
the weights as the JAX package's parameter tree of numpy arrays.

Reading: the unpickler here refuses every global except the numpy array
reconstructors and one name of the JAX package's files,
``optax._src.transform.ScaleByAdamState``, which it maps to the local
stub ``ScaleByAdamState`` (a namedtuple pickles as that global and its
fields).  So reading a file imports neither jax nor optax and runs no
other code.

Writing: ``optimiser`` is the plain tuple ``(count, mu, nu)`` (``count``
an int32 array, ``mu`` and ``nu`` parameter trees), whose
``jax.tree_util.tree_leaves`` come in the order of the JAX package's
``ScaleByAdamState``; its ``fit`` resumes by those leaves
(``graphs4cfd_tpu/training/trainer.py:172-176``).

Converting: ``convert_reference_checkpoint`` reads a checkpoint of the
original PyTorch graphs4cfd (``torch.load``, a pickle of torch tensors)
and writes it in this format, which both packages load
(``graphs4cfd_tpu/training/checkpoint.py:131-184``).
"""
from __future__ import annotations

import importlib
import os
import pickle
from typing import Any, NamedTuple, Optional

import numpy as np

_ALLOWED = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
}


class ScaleByAdamState(NamedTuple):
    """Stands in for ``optax.ScaleByAdamState`` when a file is read: the
    steps taken and the first and second moments as parameter trees."""
    count: Any
    mu: Any
    nu: Any


_MAPPED = {("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState}


class _NumpyOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _MAPPED:
            return _MAPPED[(module, name)]
        if (module, name) not in _ALLOWED:
            raise pickle.UnpicklingError(
                f"checkpoint refers to {module}.{name}: only numpy arrays "
                "and the Adam state are read")
        try:
            mod = importlib.import_module(module)
        except ImportError:  # numpy 1.x names numpy._core numpy.core
            mod = importlib.import_module(module.replace("_core", "core"))
        return getattr(mod, name)


def load_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return _NumpyOnlyUnpickler(f).load()


def load_weights(path: str) -> dict:
    """The parameter tree of a weights file: a bare tree, or a checkpoint
    dict with ``"weights"``."""
    weights = load_checkpoint(path)
    if isinstance(weights, dict) and "weights" in weights:
        weights = weights["weights"]
    return weights


def adam_state_from_checkpoint(model, state: dict):
    """The checkpoint's ``optimiser`` (a ``ScaleByAdamState`` of the JAX
    package's files or the ``(count, mu, nu)`` tuple this module writes)
    as an ``AdamState`` of ``model``; None when the file holds none."""
    from .trainer import adam_state_from_jax
    opt = state.get("optimiser")
    if opt is None:
        return None
    count, mu, nu = opt
    return adam_state_from_jax(model, count, mu, nu)


def adam_state_to_numpy(model, opt_state) -> tuple:
    """An ``AdamState`` of ``model`` as ``(count, mu, nu)``: ``count`` an
    int32 array, the moments as parameter trees of numpy arrays."""
    from ..nn.model import params_to_numpy
    return (np.asarray(opt_state.count, np.int32),
            params_to_numpy(model, opt_state.mu),
            params_to_numpy(model, opt_state.nu))


def save_checkpoint(file_name: str, *, arch: dict, weights: dict,
                    opt_state: Optional[tuple] = None, n_out: int = 1,
                    lr: Optional[float] = None, epoch: int = 0,
                    scheduler_state: Optional[dict] = None):
    """Write a checkpoint atomically (a ``.tmp`` file, then
    ``os.replace``).  ``weights`` is a parameter tree of numpy arrays and
    ``opt_state`` a ``(count, mu, nu)`` tuple (``adam_state_to_numpy``)."""
    checkpoint = {"arch": arch, "weights": weights, "optimiser": opt_state,
                  "n_out": n_out, "lr": lr, "epoch": epoch}
    if scheduler_state is not None:
        checkpoint["scheduler"] = scheduler_state
    tmp = file_name + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(checkpoint, f)
    os.replace(tmp, file_name)


def convert_reference_checkpoint(src_chk: str, dst_chk: str) -> dict:
    """Convert a ``.chk`` of the original PyTorch graphs4cfd (``arch``, a
    ``state_dict`` as ``weights``, ``n_out``, ``lr``, ``epoch``) into this
    format.  The optimiser state is not carried over: resuming starts a
    new Adam state.  Returns ``{"arch", "weights"}``.  ``torch.load``
    runs with ``weights_only=False``: convert only files you trust."""
    import torch
    state = torch.load(src_chk, map_location="cpu", weights_only=False)
    weights = import_torch_state_dict(state["weights"])
    save_checkpoint(dst_chk, arch=state["arch"], weights=weights,
                    n_out=state.get("n_out", 1), lr=state.get("lr"),
                    epoch=state.get("epoch", 0))
    return {"arch": state["arch"], "weights": weights}


def import_torch_state_dict(state_dict: dict) -> dict:
    """A ``state_dict`` of the original graphs4cfd as a parameter tree of
    numpy arrays.  Its names are
    ``<block>[.<sub-MLP>].MLP.linear_<i>.{weight,bias}`` and
    ``...MLP.layer_norm.{weight,bias}``; ``down_mlp``/``up_mlp`` sit flat
    in their block, and Linear weights ``[out, in]`` become ``w``
    ``[in, out]``."""
    params: dict = {}
    for name, tensor in state_dict.items():
        arr = np.array(tensor.detach().cpu().numpy() if hasattr(
            tensor, "detach") else tensor, dtype=np.float32)
        parts = name.split(".")
        mlp_idx = parts.index("MLP")
        node = params.setdefault(parts[0], {})
        sub = parts[1:mlp_idx]
        if sub and sub[0] not in ("down_mlp", "up_mlp"):
            node = node.setdefault(sub[0], {})
        layer_name, kind = parts[mlp_idx + 1], parts[mlp_idx + 2]
        if layer_name == "layer_norm":
            ln = node.setdefault("ln", {})
            ln["scale" if kind == "weight" else "bias"] = arr
        else:
            i = int(layer_name.split("_")[1]) - 1
            layers = node.setdefault("layers", [])
            while len(layers) <= i:
                layers.append({})
            layers[i]["w" if kind == "weight" else "b"] = \
                (np.ascontiguousarray(arr.T) if kind == "weight" else arr)
    return params
