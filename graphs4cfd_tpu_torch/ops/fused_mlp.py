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

Backward: when a gradient is needed, ``mlp_chain`` runs through
``MlpChainFn``, whose backward is ``mlp_chain_bwd``: the CUDA kernel
``csrc/mlp_chain_bwd.cu`` for a CUDA tensor (counterpart of
``pallas_mlp.py:_fused_vjp_bwd:202``, kernel ``_make_bwd_kernel:88``), its
plain version ``mlp_chain_bwd_plain`` for a CPU tensor.  It recomputes the
forward from the input ("remat") and returns ``dx`` (skipped when no input
needs it), every ``dW``, ``db`` and the LayerNorm's ``(dscale, dbias)``.
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


def dselu(a: torch.Tensor) -> torch.Tensor:
    """SELU's derivative at the pre-activation ``a``."""
    return SELU_SCALE * torch.where(a > 0, 1.0, SELU_ALPHA * torch.exp(a))


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
    for a CUDA tensor (or an error if the kernel does not take it).  When
    a gradient is needed it goes through ``MlpChainFn``, whose backward is
    ``mlp_chain_bwd``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mlp_chain: unsupported device {x.device}")
    ln = [t for t in (ln_scale, ln_bias) if t is not None]
    if len(weights) and torch.is_grad_enabled() and any(
            t.requires_grad for t in [x, *weights, *biases, *ln]):
        if (ln_scale is None) != (ln_bias is None):
            raise ValueError("LayerNorm needs both scale and bias")
        return MlpChainFn.apply(x, preact_input, len(weights), bool(ln),
                                *weights, *biases, *ln)
    if x.device.type == "cpu":
        return mlp_chain_plain(x, weights, biases, ln_scale, ln_bias,
                               preact_input=preact_input)
    return _launch_fwd(x, weights, biases, ln_scale, ln_bias, preact_input)


def _launch_fwd(x, weights, biases, ln_scale, ln_bias, preact_input):
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


def layer_norm_bwd(g: torch.Tensor, out: torch.Tensor, scale: torch.Tensor):
    """LayerNorm backward at the pre-LN rows ``out`` (f32 statistics,
    biased variance, eps 1e-5): ``(d out, dscale, dbias)``."""
    mean = out.mean(dim=-1, keepdim=True)
    cent = out - mean
    rstd = torch.rsqrt((cent * cent).mean(dim=-1, keepdim=True) + LN_EPS)
    xhat = cent * rstd
    dxhat = g * scale
    da = (dxhat - dxhat.mean(dim=-1, keepdim=True)
          - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True)) * rstd
    return da, (g * xhat).sum(dim=0), g.sum(dim=0)


def chain_bwd_plain(da: torch.Tensor, x: torch.Tensor,
                    weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor], *, preact_input: bool,
                    need_dx: bool = True):
    """Backward of the Linear/SELU layers of a chain from ``da`` (the
    cotangent of the last pre-LN output), recomputing the forward from
    ``x``.  Returns ``(dx or None, [dW], [db])``."""
    if not weights:
        return da, [], []
    h = selu(x) if preact_input else x
    ins, pre = [h], []
    for i, (w, b) in enumerate(zip(weights, biases)):
        a = torch.addmm(b, h, w)
        if i < len(weights) - 1:
            pre.append(a)
            h = selu(a)
            ins.append(h)
    dws, dbs, dx = [None] * len(weights), [None] * len(weights), None
    for i in range(len(weights) - 1, -1, -1):
        dws[i] = ins[i].t() @ da
        dbs[i] = da.sum(dim=0)
        if i == 0 and not need_dx:
            break
        dh = da @ weights[i].t()
        if i > 0:
            da = dh * dselu(pre[i - 1])
        else:
            dx = dh * dselu(x) if preact_input else dh
    return dx, dws, dbs


def mlp_chain_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                        weights: Sequence[torch.Tensor],
                        biases: Sequence[torch.Tensor],
                        ln_scale: Optional[torch.Tensor] = None, *,
                        preact_input: bool = False, need_dx: bool = True):
    """The backward kernel's function in plain PyTorch: from the chain's
    input ``x`` and the cotangent ``g`` of its output, ``(dx or None,
    [dW], [db], (dscale, dbias) or None)``."""
    with torch.no_grad():
        if ln_scale is not None:
            out = mlp_chain_plain(x, weights, biases,
                                  preact_input=preact_input)
            da, dscale, dbias = layer_norm_bwd(g, out, ln_scale)
            dln = (dscale, dbias)
        else:
            da, dln = g, None
        dx, dws, dbs = chain_bwd_plain(da, x, weights, biases,
                                       preact_input=preact_input,
                                       need_dx=need_dx)
    return dx, dws, dbs, dln


def mlp_chain_bwd(x: torch.Tensor, g: torch.Tensor,
                  weights: Sequence[torch.Tensor],
                  biases: Sequence[torch.Tensor],
                  ln_scale: Optional[torch.Tensor] = None, *,
                  preact_input: bool = False, need_dx: bool = True):
    """The chain's backward: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor (or an error if the kernel does not take
    it).  Returns ``(dx or None, [dW], [db], (dscale, dbias) or None)``."""
    if x.device.type == "cpu":
        return mlp_chain_bwd_plain(x, g, weights, biases, ln_scale,
                                   preact_input=preact_input,
                                   need_dx=need_dx)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_chain_bwd: unsupported device {x.device}")
    return _launch_bwd(x, g, weights, biases, ln_scale, preact_input, need_dx)


def _launch_bwd(x, g, weights, biases, ln_scale, preact_input, need_dx):
    dims = _check(x, weights, biases, ln_scale, ln_scale)  # no LN bias read
    if tuple(g.shape) != (x.shape[0], dims[-1]) or g.dtype != x.dtype \
            or g.device != x.device or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous float32 [{x.shape[0]}, "
                         f"{dims[-1]}] on {x.device}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    lib = _build.load()
    n, rows = len(weights), x.shape[0]
    c_dims = _build.int_array(dims)
    smem = lib.g4c_mlp_chain_bwd_smem(n, c_dims)
    if smem == 0 or smem > _build.MAX_SMEM:
        raise ValueError(f"mlp_chain_bwd kernel cannot hold widths {dims} "
                         f"in shared memory ({smem} bytes)")
    # every parameter gradient is a view of one flat buffer, in the order
    # W0, b0, W1, b1, ..., LN scale, LN bias
    sizes = [(dims[i], dims[i + 1]) for i in range(n)]
    numel = sum(a * b + b for a, b in sizes) + (2 * dims[-1]
                                                 if ln_scale is not None
                                                 else 0)
    flat = torch.zeros(numel, device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x) if need_dx else None
    grid = lib.g4c_mlp_chain_bwd_grid(n, c_dims, rows) if rows else 0
    if rows and grid < 1:
        raise RuntimeError("mlp_chain_bwd: no grid size for this card")
    work = torch.empty(grid * numel, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = 0 if rows == 0 else lib.g4c_mlp_chain_bwd(
            x.data_ptr(), g.data_ptr(),
            dx.data_ptr() if dx is not None else None, rows, n,
            _build.ptr_array(weights), _build.ptr_array(biases), c_dims,
            ln_scale.data_ptr() if ln_scale is not None else None,
            int(preact_input), work.data_ptr(), grid, flat.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err)
    mlp_chain_bwd.launches += 1
    dws, dbs, off = [], [], 0
    for a, b in sizes:
        dws.append(flat[off:off + a * b].view(a, b))
        dbs.append(flat[off + a * b:off + a * b + b])
        off += a * b + b
    dln = ((flat[off:off + dims[-1]], flat[off + dims[-1]:])
           if ln_scale is not None else None)
    return dx, dws, dbs, dln


#: kernel launches since the count was last set to 0
mlp_chain_bwd.launches = 0


class MlpChainFn(torch.autograd.Function):
    """``mlp_chain`` with ``mlp_chain_bwd`` as its backward; the chain's
    tensors come flattened: ``x, preact_input, n, has_ln, *W, *b, *ln``.
    Only ``x`` and the parameters are saved: the backward recomputes the
    forward."""

    @staticmethod
    def forward(ctx, x, preact_input, n, has_ln, *params):
        ws, bs = params[:n], params[n:2 * n]
        ln = params[2 * n:] if has_ln else (None, None)
        ctx.save_for_backward(x, *params)
        ctx.preact_input, ctx.n, ctx.has_ln = preact_input, n, has_ln
        return mlp_chain(x, ws, bs, *ln, preact_input=preact_input)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        n = ctx.n
        ws, bs = params[:n], params[n:2 * n]
        dx, dws, dbs, dln = mlp_chain_bwd(
            x, g.contiguous(), ws, bs, params[2 * n] if ctx.has_ln else None,
            preact_input=ctx.preact_input, need_dx=ctx.needs_input_grad[0])
        return (dx, None, None, None, *dws, *dbs, *(dln or ()))
