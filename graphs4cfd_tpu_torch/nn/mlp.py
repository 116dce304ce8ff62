"""MLP as in the reference's ``blocks.MLP`` (port of
``graphs4cfd_tpu/nn/mlp.py``).

``Linear -> SELU`` repeated, a final ``Linear`` without activation, and an
optional trailing LayerNorm (eps 1e-5, biased variance).  Weights are
stored ``[in, out]``, as the JAX package stores them, so parameters move
between the packages unchanged and the kernel reads them row-major.
Every chain runs through ``ops.fused_mlp.mlp_chain``: the CUDA kernel for
CUDA tensors, its plain version for CPU tensors.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops import fused_mlp

ArchTuple = Tuple[int, Sequence[int], bool]  # (input_size, widths, layer_norm)


class MLP(nn.Module):
    """Parameters of one MLP; values are loaded by ``nn.model``."""

    def __init__(self, input_size: int, widths: Sequence[int],
                 layer_norm: bool = False, device=None):
        super().__init__()
        dims = [int(input_size)] + [int(w) for w in widths]
        self.weights = nn.ParameterList(
            nn.Parameter(torch.zeros(a, b, device=device))
            for a, b in zip(dims[:-1], dims[1:]))
        self.biases = nn.ParameterList(
            nn.Parameter(torch.zeros(b, device=device)) for b in dims[1:])
        if layer_norm:
            self.ln_scale = nn.Parameter(torch.ones(dims[-1], device=device))
            self.ln_bias = nn.Parameter(torch.zeros(dims[-1], device=device))
        else:
            self.ln_scale = self.ln_bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mlp(self, x)


def apply_mlp(mlp: MLP, x: torch.Tensor) -> torch.Tensor:
    return apply_mlp_tail(mlp, x, start=0)


def apply_mlp_tail(mlp: MLP, h: torch.Tensor, *, start: int) -> torch.Tensor:
    """Apply the MLP from layer ``start`` on.  ``start=1`` expects ``h`` to
    be the pre-activation output of the first layer (blocks that fuse the
    first layer with gathers compute it)."""
    return fused_mlp.mlp_chain(h, list(mlp.weights)[start:],
                               list(mlp.biases)[start:], mlp.ln_scale,
                               mlp.ln_bias, preact_input=start > 0)


def chain_of(mlp: MLP):
    """``(weights, biases, (ln_scale, ln_bias) or None)`` for the kernels."""
    ln = (mlp.ln_scale, mlp.ln_bias) if mlp.ln_scale is not None else None
    return list(mlp.weights), list(mlp.biases), ln
