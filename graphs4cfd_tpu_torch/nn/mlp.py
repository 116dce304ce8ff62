"""MLP as in the reference's ``blocks.MLP`` (port of
``graphs4cfd_tpu/nn/mlp.py``).

``Linear -> SELU`` repeated, a final ``Linear`` without activation, and an
optional trailing LayerNorm (eps 1e-5, biased variance).  Weights are
stored ``[in, out]``, as the JAX package stores them, so parameters move
between the packages unchanged and the kernel reads them row-major.
Every chain runs through ``ops.fused_mlp.mlp_chain``: the CUDA kernel for
CUDA tensors, its plain version for CPU tensors.

``cd`` is the compute dtype (``GNN.compute_dtype``).  Under the bf16
policy (``cd = torch.bfloat16``) a chain's input is cast to bf16 (the
JAX package's ``x.astype(act)``) and its output is bf16; the parameters
stay f32.  The JAX package runs a chain that its Pallas kernel does not
take (narrow widths, rows off its block) through plain XLA, rounding to
bf16 after every product and bias add (``nn/mlp.py:81-99``); the port runs
every chain through ``mlp_chain``, whose bf16 version follows the Pallas
kernel's rounding points instead (f32 between the products, one rounding
of the output).
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


def apply_mlp(mlp: MLP, x: torch.Tensor,
              cd: torch.dtype = torch.float32) -> torch.Tensor:
    return apply_mlp_tail(mlp, x, start=0, cd=cd)


def apply_mlp_tail(mlp: MLP, h: torch.Tensor, *, start: int,
                   cd: torch.dtype = torch.float32) -> torch.Tensor:
    """Apply the MLP from layer ``start`` on.  ``start=1`` expects ``h`` to
    be the pre-activation output of the first layer (blocks that fuse the
    first layer with gathers compute it).  ``cd``: the compute dtype."""
    if cd != torch.float32:
        h = h.to(cd)
    return fused_mlp.mlp_chain(h, list(mlp.weights)[start:],
                               list(mlp.biases)[start:], mlp.ln_scale,
                               mlp.ln_bias, preact_input=start > 0)


def mlp_output_size(arch_tuple: ArchTuple) -> int:
    """The output width of an MLP's ``(input_size, widths, layer_norm)``."""
    return int(arch_tuple[1][-1])


def chain_of(mlp: MLP):
    """``(weights, biases, (ln_scale, ln_bias) or None)`` for the kernels."""
    ln = (mlp.ln_scale, mlp.ln_bias) if mlp.ln_scale is not None else None
    return list(mlp.weights), list(mlp.biases), ln
