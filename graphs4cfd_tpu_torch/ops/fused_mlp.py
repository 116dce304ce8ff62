"""Fused MLP chain: the CUDA kernel ``csrc/mlp_chain.cu``, its wrapper and
its plain PyTorch version.

Counterpart of ``graphs4cfd_tpu/ops/pallas_mlp.py:fused_mlp`` (forward
kernel ``_make_fwd_kernel:75``, called from ``_fused_fwd_impl:185``):
``Linear -> SELU -> ... -> Linear`` then an optional LayerNorm (eps 1e-5,
biased variance, f32 statistics).  ``preact_input`` (``start=1``) means
``x`` is the pre-activation of a first layer computed outside, and the
chain starts with SELU of it.

What bounds it on the H100 and what the design does about it: see the note
at the top of ``csrc/mlp_chain.cu``.

Dispatch: ``mlp_chain`` takes the plain version for a CPU tensor.  For a
CUDA tensor it launches the kernel or raises: the kernel takes 1-8 f32
layers whose output widths are at most 256 and whose widest activation
fits shared memory (input widths up to about 380).  Every MLP of the MuS
models (inputs 2, 5, 130, 258, hidden 128, output 3) fits, so on CUDA every
chain of the path goes through it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build

SELU_ALPHA = 1.6732632423543772848170429916717
SELU_SCALE = 1.0507009873554804934193349852946
LN_EPS = 1e-5
MAX_LAYERS = 8
MAX_OUT_WIDTH = 256


def selu(a: torch.Tensor) -> torch.Tensor:
    """SELU with the constants of the JAX package's kernels."""
    return SELU_SCALE * torch.where(a > 0, a, SELU_ALPHA * torch.expm1(a))


def layer_norm(h: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(h, h.shape[-1:], scale, bias, eps=LN_EPS)


def mlp_chain_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor],
                    ln_scale: Optional[torch.Tensor] = None,
                    ln_bias: Optional[torch.Tensor] = None, *,
                    preact_input: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch (weights ``[in, out]``).
    With no layers it applies only the LayerNorm, as ``apply_mlp_tail``
    does when ``start`` is the last layer."""
    h = selu(x) if preact_input and len(weights) else x
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = torch.addmm(b, h, w)
        if i < len(weights) - 1:
            h = selu(h)
    if ln_scale is not None:
        h = layer_norm(h, ln_scale, ln_bias)
    return h


def _check(x, weights, biases, ln_scale, ln_bias):
    if not 1 <= len(weights) <= MAX_LAYERS or len(biases) != len(weights):
        raise ValueError(f"mlp_chain kernel takes 1-{MAX_LAYERS} layers, "
                         f"got {len(weights)} weights, {len(biases)} biases")
    if x.dim() != 2:
        raise ValueError(f"x must be [rows, features], got {tuple(x.shape)}")
    dims = [x.shape[1]] + [w.shape[1] for w in weights]
    for i, (w, b) in enumerate(zip(weights, biases)):
        if tuple(w.shape) != (dims[i], dims[i + 1]) or \
                tuple(b.shape) != (dims[i + 1],):
            raise ValueError(f"layer {i}: weight {tuple(w.shape)}, bias "
                             f"{tuple(b.shape)} do not chain from "
                             f"{dims[i]} features")
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("LayerNorm needs both scale and bias")
    ln = [t for t in (ln_scale, ln_bias) if t is not None]
    for t in ln:
        if tuple(t.shape) != (dims[-1],):
            raise ValueError(f"LayerNorm params {tuple(t.shape)} do not "
                             f"match width {dims[-1]}")
    for t in [x, *weights, *biases, *ln]:
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("mlp_chain kernel takes contiguous float32 "
                             f"tensors on {x.device}; got {t.dtype} on "
                             f"{t.device}, contiguous={t.is_contiguous()}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [x, *weights, *biases, *ln]):
        raise NotImplementedError("mlp_chain has no backward kernel yet: "
                                  "call it under torch.no_grad()")
    if max(dims[1:]) > MAX_OUT_WIDTH:
        raise ValueError(f"mlp_chain kernel takes output widths up to "
                         f"{MAX_OUT_WIDTH}, got {dims[1:]}")
    return dims


def mlp_chain(x: torch.Tensor, weights: Sequence[torch.Tensor],
              biases: Sequence[torch.Tensor],
              ln_scale: Optional[torch.Tensor] = None,
              ln_bias: Optional[torch.Tensor] = None, *,
              preact_input: bool = False) -> torch.Tensor:
    """Run the chain: the plain version for a CPU tensor, the CUDA kernel
    for a CUDA tensor (or an error if the kernel does not take it)."""
    if x.device.type == "cpu":
        return mlp_chain_plain(x, weights, biases, ln_scale, ln_bias,
                               preact_input=preact_input)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_chain: unsupported device {x.device}")
    dims = _check(x, weights, biases, ln_scale, ln_bias)
    lib = _build.load()
    c_dims = _build.int_array(dims)
    smem = lib.g4c_mlp_chain_smem(len(weights), c_dims)
    if smem == 0 or smem > _build.MAX_SMEM:
        raise ValueError(f"mlp_chain kernel cannot hold widths {dims} in "
                         f"shared memory ({smem} bytes)")
    out = torch.empty(x.shape[0], dims[-1], device=x.device,
                      dtype=torch.float32)
    if x.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        err = lib.g4c_mlp_chain(
            x.data_ptr(), out.data_ptr(), x.shape[0], len(weights),
            _build.ptr_array(weights), _build.ptr_array(biases), c_dims,
            ln_scale.data_ptr() if ln_scale is not None else None,
            ln_bias.data_ptr() if ln_bias is not None else None,
            int(preact_input), torch.cuda.current_stream().cuda_stream)
    _build.check(err)
    mlp_chain.launches += 1
    return out


#: kernel launches since the count was last set to 0
mlp_chain.launches = 0

