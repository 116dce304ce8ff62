"""Model base: modules built from the arch dict, and weights carried across.

Port of ``graphs4cfd_tpu/nn/model.py:28-60, 92-188``.  The arch dict has
the reference's schema: each value is one MLP tuple ``(in, widths,
layer_norm)`` (encoders, down/up models, decoder) or a pair of them (a
message-passing block: edge MLP and node MLP, or, in a REMuS arch, which
has angle encoders, angle MLP and edge MLP).

Weights move between the packages as the JAX package's parameter tree of
numpy arrays, ``{"mp111": {"edge_mlp": {"layers": [{"w", "b"}, ...],
"ln": {"scale", "bias"}}, "node_mlp": ...}, "edge_encoder": ..., ...}``
(a REMuS block holds ``angle_mlp`` and ``edge_mlp``; a gMuS arch names its
blocks ``mp{level}..`` and its coarse edge encoders ``edge_encoder{l}``,
and the blocks after an up step have wider first layers) with ``w`` stored
``[in, out]``: ``params_from_jax`` turns it into the port's state dict and
``params_to_numpy`` goes back.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from .blocks import EdgeMPBlock, GNBlock
from .mlp import MLP


def _is_mlp_tuple(v) -> bool:
    return (isinstance(v, (tuple, list)) and len(v) == 3
            and isinstance(v[0], int))


def _is_block(v) -> bool:
    return (isinstance(v, (tuple, list)) and len(v) == 2
            and _is_mlp_tuple(v[0]) and _is_mlp_tuple(v[1]))


def _is_angle_block(name: str, arch: dict) -> bool:
    """A REMuS arch (recognised by its angle encoders) pairs an angle MLP
    with an edge MLP in its MP blocks (JAX ``nn/model.py:50-60``)."""
    return (name.startswith(("mp", "down_mp"))
            and any(k.startswith("angle_encoder") for k in arch))


def _block_parts(name: str, arch: dict):
    """The sub-MLP names of a block entry, in arch order."""
    return (("angle_mlp", "edge_mlp") if _is_angle_block(name, arch)
            else ("edge_mlp", "node_mlp"))


def build_modules(arch: dict, device=None) -> nn.ModuleDict:
    """One ``MLP``, ``GNBlock`` or ``EdgeMPBlock`` per arch entry, in arch
    order."""
    mods = nn.ModuleDict()
    for name, spec in arch.items():
        if _is_mlp_tuple(spec):
            mods[name] = MLP(*spec, device=device)
        elif _is_block(spec):
            cls = EdgeMPBlock if _is_angle_block(name, arch) else GNBlock
            mods[name] = cls(*spec, device=device)
        else:
            raise ValueError(f"Unrecognised arch entry {name!r}: {spec!r}")
    return mods


def init_params_numpy(arch: dict, seed: int = 0) -> dict:
    """Random parameters as the JAX package's tree of numpy arrays: weights
    and biases from ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` (torch
    ``nn.Linear``'s default), LayerNorm scale 1 and bias 0, drawn from one
    ``numpy.random.default_rng(seed)`` in arch order."""
    rng = np.random.default_rng(seed)

    def mlp(input_size, widths, layer_norm):
        dims = [int(input_size)] + [int(w) for w in widths]
        layers = []
        for a, b in zip(dims[:-1], dims[1:]):
            bound = 1.0 / np.sqrt(a)
            layers.append({
                "w": rng.uniform(-bound, bound, (a, b)).astype(np.float32),
                "b": rng.uniform(-bound, bound, (b,)).astype(np.float32)})
        out = {"layers": layers}
        if layer_norm:
            out["ln"] = {"scale": np.ones(dims[-1], np.float32),
                         "bias": np.zeros(dims[-1], np.float32)}
        return out

    tree = {}
    for name, spec in arch.items():
        if _is_mlp_tuple(spec):
            tree[name] = mlp(*spec)
        elif _is_block(spec):
            first, second = _block_parts(name, arch)
            tree[name] = {first: mlp(*spec[0]), second: mlp(*spec[1])}
        else:
            raise ValueError(f"Unrecognised arch entry {name!r}: {spec!r}")
    return tree


def _mlp_items(prefix: str, p: dict):
    for i, lyr in enumerate(p["layers"]):
        yield f"{prefix}.weights.{i}", lyr["w"]
        yield f"{prefix}.biases.{i}", lyr["b"]
    if "ln" in p:
        yield f"{prefix}.ln_scale", p["ln"]["scale"]
        yield f"{prefix}.ln_bias", p["ln"]["bias"]


def params_from_jax(tree: dict) -> dict:
    """The JAX parameter tree (numpy arrays) as a state dict of ``GNN``."""
    state = {}
    for name, p in tree.items():
        subs = ([(f"layers.{name}", p)] if "layers" in p else
                [(f"layers.{name}.{s}", p[s]) for s in p])
        for prefix, mlp in subs:
            for key, arr in _mlp_items(prefix, mlp):
                state[key] = torch.from_numpy(
                    np.array(arr, dtype=np.float32))  # a writable copy
    return state


def _mlp_to_numpy(mlp: MLP, get) -> dict:
    out = {"layers": [{"w": get(w), "b": get(b)}
                      for w, b in zip(mlp.weights, mlp.biases)]}
    if mlp.ln_scale is not None:
        out["ln"] = {"scale": get(mlp.ln_scale), "bias": get(mlp.ln_bias)}
    return out


def params_to_numpy(model: "GNN", values=None) -> dict:
    """The model's parameters, or ``values`` (one tensor per parameter in
    ``model.parameters()`` order, such as an Adam moment), as the JAX
    package's tree of numpy arrays."""
    if values is None:
        values = model.parameters()
    of = {id(p): v for p, v in zip(model.parameters(), values)}
    get = lambda p: of[id(p)].detach().cpu().numpy().copy()
    tree = {}
    for name, mod in model.layers.items():
        if isinstance(mod, MLP):
            tree[name] = _mlp_to_numpy(mod, get)
        else:
            tree[name] = {s: _mlp_to_numpy(getattr(mod, s), get)
                          for s in _block_parts(name, model.arch)}
    return tree


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples in
    ``jax.tree_util.tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def grad_norm2(grads) -> torch.Tensor:
    """Global L2 norm of a sequence of gradients, in f32 (port of
    ``graphs4cfd_tpu/nn/model.py:grad_norm2``)."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def bundled_checkpoint_path(relpath: str) -> str:
    """Path of a pretrained checkpoint bundled with the JAX package
    (``graphs4cfd_tpu/nn/weights/<relpath>``), read in place as data: the
    path comes from the repository's layout, not from an import."""
    root = Path(__file__).resolve().parents[2]
    return str(root / "graphs4cfd_tpu" / "nn" / "weights" / relpath)


class GNN(nn.Module):
    """Base of the model families: modules from an arch dict, with random
    weights from ``seed`` (or those of a ``weights`` file), from a ``.chk``
    checkpoint, or from the bundled checkpoint of a ``PRETRAINED`` name
    (``model``), as ``graphs4cfd_tpu/nn/model.py:92-126`` builds them.

    ``compute_dtype`` is the JAX ``GNN``'s (``graphs4cfd_tpu/nn/model.py:
    98-104``): ``torch.float32``, or ``torch.bfloat16`` for the bf16 policy
    (bf16 activations and products on the tensor cores, f32 parameters,
    gradients, optimiser state and checkpoints; ``nn.blocks``), read at
    every forward, so that ``fit`` with ``mixed_precision`` can set it.

    Subclasses define ``build_plan(arch)`` and ``forward(graph)`` (one
    residual time step), ``NUM_FIELDS`` where the number of predicted
    fields does not follow from the decoder's width, and
    ``prepare_batch`` where their backward walks host sorts that
    ``collate`` does not attach.
    """

    NUM_FIELDS: Optional[int] = None
    #: name -> checkpoint path under ``bundled_checkpoint_path``; each
    #: class of the reference names its own
    PRETRAINED: dict = {}

    def __init__(self, arch: Optional[dict] = None, *,
                 weights: Optional[str] = None,
                 checkpoint: Optional[str] = None,
                 model: Optional[str] = None, seed: int = 0,
                 device="cuda", compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be torch.float32 or "
                             f"torch.bfloat16, got {compute_dtype}")
        self.compute_dtype = compute_dtype
        if model is not None:
            if model not in self.PRETRAINED:
                raise ValueError(f"Model {model} not recognized. Available: "
                                 f"{sorted(self.PRETRAINED)}")
            path = bundled_checkpoint_path(self.PRETRAINED[model])
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"Pretrained checkpoint for {model!r} not bundled at "
                    f"{path}.")
            if checkpoint is not None:
                raise ValueError("give one of checkpoint and model")
            checkpoint = path
        if (arch is None) == (checkpoint is None):
            raise ValueError("give exactly one of arch, checkpoint and model")
        if weights is not None and arch is None:
            raise ValueError("weights go with arch")
        from ..training.checkpoint import load_checkpoint, load_weights
        if checkpoint is not None:
            state = load_checkpoint(checkpoint)
            arch, tree = state["arch"], state["weights"]
        elif weights is not None:
            tree = load_weights(weights)
        else:
            tree = init_params_numpy(arch, seed)
        self._set_arch(arch, tree, device)

    def _set_arch(self, arch: dict, tree: dict, device) -> None:
        """Modules of ``arch`` on ``device`` holding the parameter tree
        ``tree``, with the plan and field count they imply."""
        self.arch = dict(arch)
        self.num_fields = self.NUM_FIELDS or (
            int(arch["decoder"][1][-1]) if "decoder" in arch else None)
        self.plan = self.build_plan(self.arch)
        self.layers = build_modules(self.arch, device=device)
        self.load_state_dict(params_from_jax(tree))

    def _device(self) -> torch.device:
        return next(self.parameters()).device

    def load_arch(self, arch: dict, seed: int = 0) -> None:
        """Rebuild the model in place from ``arch`` with random weights
        from ``seed`` (``init_params_numpy``), on the device of the
        current parameters; ``compute_dtype`` is kept."""
        self._set_arch(arch, init_params_numpy(arch, seed), self._device())

    def load_model(self, arch: Optional[dict] = None,
                   weights: Optional[str] = None,
                   checkpoint: Optional[str] = None, seed: int = 0) -> "GNN":
        """Rebuild the model in place, as the JAX ``GNN.load_model``: from
        ``arch`` (random weights from ``seed``, or those of a ``weights``
        file) or from a self-describing ``.chk`` ``checkpoint``; on the
        device of the current parameters, ``compute_dtype`` kept."""
        from ..training.checkpoint import load_checkpoint, load_weights
        if arch is not None and checkpoint is None:
            tree = (load_weights(weights) if weights is not None
                    else init_params_numpy(arch, seed))
            self._set_arch(arch, tree, self._device())
        elif checkpoint is not None:
            state = load_checkpoint(checkpoint)
            self._set_arch(state["arch"], state["weights"], self._device())
        return self

    def shift_and_replace(self, x: torch.Tensor,
                          y: torch.Tensor) -> torch.Tensor:
        """Roll the field window left by ``num_fields`` and append ``y``."""
        return torch.cat([x[:, self.num_fields:], y], dim=1)

    def build_plan(self, arch: dict):
        raise NotImplementedError

    def prepare_batch(self, batch):
        """The host batch (numpy, from ``collate``) with what the training
        step's backward needs besides it; MuS needs nothing more, since
        ``collate`` carries ``sender_perm``/``sender_sorted``."""
        return batch

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def solve(self, graph, n_out: int) -> torch.Tensor:
        """Autoregressive rollout of a graph or a list of graphs;
        ``[V, num_fields * n_out]``."""
        from ..training.rollout import solve
        return solve(self, graph, n_out)

    def fit(self, train_config, train_loader, val_loader=None):
        from ..training.trainer import fit
        return fit(self, train_config, train_loader, val_loader)

    def save_checkpoint(self, file_name: str, n_out: int, epoch: int,
                        opt_state=None, lr: Optional[float] = None,
                        scheduler_state: Optional[dict] = None):
        """Write a ``.chk`` the JAX package reads; ``opt_state`` is this
        model's ``AdamState``."""
        from ..training.checkpoint import adam_state_to_numpy, save_checkpoint
        save_checkpoint(
            file_name, arch=self.arch, weights=params_to_numpy(self),
            opt_state=(adam_state_to_numpy(self, opt_state)
                       if opt_state is not None else None),
            n_out=n_out, lr=lr, epoch=epoch, scheduler_state=scheduler_state)
