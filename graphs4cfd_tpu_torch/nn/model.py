"""Model base: modules built from the arch dict, and weights carried across.

Port of ``graphs4cfd_tpu/nn/model.py:28-60, 92-160``.  The arch dict has
the reference's schema: each value is one MLP tuple ``(in, widths,
layer_norm)`` (encoders, down/up models, decoder) or a pair of them (a
message-passing block: edge MLP and node MLP, or, in a REMuS arch, which
has angle encoders, angle MLP and edge MLP).

Weights move between the packages as the JAX package's parameter tree of
numpy arrays, ``{"mp111": {"edge_mlp": {"layers": [{"w", "b"}, ...],
"ln": {"scale", "bias"}}, "node_mlp": ...}, "edge_encoder": ..., ...}``
(a REMuS block holds ``angle_mlp`` and ``edge_mlp``) with ``w`` stored
``[in, out]``: ``params_from_jax`` turns it into the port's state dict and
``params_to_numpy`` goes back.
"""
from __future__ import annotations

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


def _mlp_to_numpy(mlp: MLP) -> dict:
    get = lambda t: t.detach().cpu().numpy().copy()
    out = {"layers": [{"w": get(w), "b": get(b)}
                      for w, b in zip(mlp.weights, mlp.biases)]}
    if mlp.ln_scale is not None:
        out["ln"] = {"scale": get(mlp.ln_scale), "bias": get(mlp.ln_bias)}
    return out


def params_to_numpy(model: "GNN") -> dict:
    """The model's parameters as the JAX package's tree of numpy arrays."""
    tree = {}
    for name, mod in model.layers.items():
        if isinstance(mod, MLP):
            tree[name] = _mlp_to_numpy(mod)
        else:
            tree[name] = {s: _mlp_to_numpy(getattr(mod, s))
                          for s in _block_parts(name, model.arch)}
    return tree


def grad_norm2(grads) -> torch.Tensor:
    """Global L2 norm of a sequence of gradients, in f32 (port of
    ``graphs4cfd_tpu/nn/model.py:grad_norm2``)."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


class GNN(nn.Module):
    """Base of the model families: modules from an arch dict, with random
    weights from ``seed`` or the weights of a ``.chk`` checkpoint.

    Subclasses define ``build_plan(arch)`` and ``forward(graph)`` (one
    residual time step), and ``NUM_FIELDS`` where the number of predicted
    fields does not follow from the decoder's width.
    """

    NUM_FIELDS: Optional[int] = None

    def __init__(self, arch: Optional[dict] = None, *,
                 checkpoint: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        super().__init__()
        if (arch is None) == (checkpoint is None):
            raise ValueError("give exactly one of arch and checkpoint")
        if checkpoint is not None:
            from ..training.checkpoint import load_checkpoint
            state = load_checkpoint(checkpoint)
            arch, tree = state["arch"], state["weights"]
        else:
            tree = init_params_numpy(arch, seed)
        self.arch = dict(arch)
        self.num_fields = self.NUM_FIELDS or (
            int(arch["decoder"][1][-1]) if "decoder" in arch else None)
        self.plan = self.build_plan(self.arch)
        self.layers = build_modules(self.arch, device=device)
        self.load_state_dict(params_from_jax(tree))

    def build_plan(self, arch: dict):
        raise NotImplementedError

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def solve(self, graph, n_out: int) -> torch.Tensor:
        """Autoregressive rollout; ``[V, num_fields * n_out]``."""
        from ..training.rollout import solve
        return solve(self, graph, n_out)
